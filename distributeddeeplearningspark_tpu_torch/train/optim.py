"""Optimizers and LR schedules with optax's semantics, on torch tensors.

The port of ``distributeddeeplearningspark_tpu/train/optim.py`` for the
BERT and ResNet paths: ``adamw``, ``sgd``, ``warmup_linear``,
``warmup_cosine``, ``with_grad_clip`` and ``masked``. Each is a
:class:`GradientTransformation` of optax's shape, ``init(params) -> state``
and ``update(updates, state, params) -> (updates, state)``, over lists of
tensors in the params' order, so that a reader can map it onto optax. The
arithmetic is optax's, not ``torch.optim``'s defaults:

- a schedule is read at the count *before* it is incremented, so the first
  update under ``warmup_linear`` has lr 0; ``join_schedules`` evaluates the
  decay leg at ``count - warmup_steps``; schedules compute in f32;
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, as ``(t / norm) * max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- ``adamw`` is ``scale_by_adam`` (eps outside the sqrt, bias correction by
  ``count + 1``), then ``+ weight_decay * p`` for every param (optax's
  default mask is None: biases and LayerNorms decay too), then ``* -lr``;
- ``sgd`` is ``add_decayed_weights`` first (every param, BatchNorm's
  included), then ``trace`` (``t = g + momentum·t``, Nesterov
  ``g + momentum·t``), then ``* -lr``;
- ``warmup_cosine`` is ``warmup_cosine_decay_schedule``: the cosine leg
  runs over ``total − warmup`` steps.

Updates are made in place with ``torch._foreach_*`` ops: a transform may
overwrite the ``updates`` it is given (the caller's gradients) and the
moment buffers in its state. Counts are 0-d int64 tensors on the params'
device, as the JAX package's are device arrays: a schedule takes one and
returns a float or a 0-d f32 tensor, and Adam's bias corrections are
computed from it on the device in f32, so no update syncs with the host
and the train step's non-finite guard (:mod:`.step`) holds a skipped
step's counts back as it holds the moments. These are plain tensor ops,
as the JAX package runs its optimizer in XLA, not in Pallas. ``lamb``,
``lars`` and ``adafactor`` are not ported yet.

Under FSDP and tensor parallelism (:mod:`..parallel.sharding`) the train
step hands a transformation the local shards of the sharded params, as a
:class:`Shards` list that says which entries are shards and how many
times each distinct shard lies in the shard group (``fsdp × tensor``):
:func:`global_norm` (and so ``clip_by_global_norm``) then sums the
shards' squares across that group, each distinct shard once and never
across ``data`` replicas, and counts every other tensor once, the norm of
the whole gradient; elementwise updates are the same on a shard as on
the whole. Each list a multi-tensor op takes holds plain tensors only.

``masked(tx, trainable)`` (the LoRA fine-tune) names the params ``tx``
updates: the train step hands it only those, with their gradients, so the
others get no update, no optimizer state and no part in a clip inside it,
as under optax's ``multi_transform`` with ``set_to_zero``. A masked
transformation is the outermost one: :func:`chain` refuses to hold it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

#: a count (a 0-d int64 tensor; an int is taken too) to a learning rate
Schedule = Callable[[torch.Tensor], "float | torch.Tensor"]
Tensors = list[torch.Tensor]


def _count(params: Tensors) -> torch.Tensor:
    """A fresh step count: a 0-d int64 zero on the params' device."""
    return torch.zeros((), dtype=torch.int64,
                       device=params[0].device if params else None)


class Shards(list):
    """A list of tensors, some of which are this rank's shards of tensors
    sharded over the process group ``group`` (None: every rank): what the
    train step hands a transformation under FSDP and tensor parallelism.
    ``shares[i]`` is 0 for a whole tensor, else the weight of its squares
    in a sum across ``group``: its distinct shards over the group's size
    (``sharding.norm_share``), so each distinct shard counts once."""

    def __init__(self, tensors, shares, group=None):
        super().__init__(tensors)
        self.shares = [float(s) for s in shares]
        self.group = group

    def like(self, tensors) -> "Shards":
        """``tensors`` (one for each of this list's, in order) as Shards of
        the same layout."""
        return Shards(tensors, self.shares, self.group)


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], tuple[Tensors, Any]]
    #: the param names this transformation updates (:func:`masked`); None:
    #: every param it is given
    trainable: Callable[[str], bool] | None = None


def chain(*txs: GradientTransformation) -> GradientTransformation:
    if any(tx.trainable is not None for tx in txs):
        raise ValueError("a masked transformation must be the outermost one: "
                         "masked(chain(...), trainable), not chain(masked(...))")

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params):
        new_state = []
        for tx, s in zip(txs, state):
            out, s = tx.update(updates, s, params)
            # a later global norm must still see which entries are shards
            updates = (updates.like(out) if isinstance(updates, Shards)
                       and not isinstance(out, Shards) else out)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, f32, on the device.
    Over :class:`Shards`, the shards' sums of squares, each weighed by its
    share, are all-reduced across their group (a collective: every rank
    calls it) and each other tensor counts once."""
    norms = [n.float() for n in torch._foreach_norm(tensors)]
    if not (isinstance(tensors, Shards) and any(tensors.shares)):
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    squares = torch.stack([n.square() * s for n, s in zip(norms, tensors.shares)
                           if s]).sum()
    dist.all_reduce(squares, group=tensors.group)
    whole = [n for n, s in zip(norms, tensors.shares) if not s]
    if whole:
        squares = squares + torch.stack(whole).square().sum()
    return torch.sqrt(squares)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        one = torch.ones_like(g_norm)
        # (t / norm) * max_norm where clipping, t / 1 * 1 == t elsewhere
        torch._foreach_div_(updates, torch.where(keep, one, g_norm))
        torch._foreach_mul_(updates, torch.where(keep, one, one * max_norm))
        return updates, state

    return GradientTransformation(lambda params: (), update)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Tensors
    nu: Tensors


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(_count(params), [torch.zeros_like(p) for p in params],
                                [torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, updates, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, updates, updates, value=1.0 - b2)
        count = state.count + 1
        c = count.float()
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        # the gradients are spent: the denominator takes their memory, so
        # the update is the one param-sized temporary (nu / bc2 in place is
        # the same division, bit for bit, as into a new list)
        denom = updates
        torch._foreach_copy_(denom, nu)
        torch._foreach_div_(denom, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(mu, bc1)
        torch._foreach_div_(out, denom)
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        torch._foreach_add_(updates, params, alpha=weight_decay)
        return updates, state

    return GradientTransformation(lambda params: (), update)


class TraceState(NamedTuple):
    trace: Tensors


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax's ``trace``: ``t = g + decay·t``; the update is ``t`` (Nesterov:
    ``g + decay·t``). The state keeps its own tensors, so a later transform
    may scale the returned updates in place."""
    def init(params):
        return TraceState([torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        new_trace = torch._foreach_add(updates, state.trace, alpha=decay)
        torch._foreach_copy_(state.trace, new_trace)
        if nesterov:
            torch._foreach_add_(updates, new_trace, alpha=decay)
            return updates, state
        return new_trace, state

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: float | Schedule) -> GradientTransformation:
    """``updates * -lr``; a schedule is read at the count before the
    increment (optax's ``scale_by_schedule``)."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def update(updates, count, params):
        lr = schedule(count)
        torch._foreach_mul_(updates, -lr if isinstance(lr, torch.Tensor)
                            else -float(lr))
        return updates, count + 1

    return GradientTransformation(_count, update)


def adamw(learning_rate: float | Schedule, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: float | Schedule, momentum: float | None = 0.9,
        nesterov: bool = False, weight_decay: float = 0.0) -> GradientTransformation:
    """optax ``sgd`` (momentum by ``trace``), after ``add_decayed_weights``
    when ``weight_decay`` is set, as the JAX package chains them."""
    txs = [add_decayed_weights(weight_decay)] if weight_decay else []
    if momentum is not None:
        txs.append(trace(momentum, nesterov))
    return chain(*txs, scale_by_learning_rate(learning_rate))


def with_grad_clip(tx: GradientTransformation, max_norm: float) -> GradientTransformation:
    return chain(clip_by_global_norm(max_norm), tx)


def masked(tx: GradientTransformation,
           trainable: Callable[[str], bool]) -> GradientTransformation:
    """Train only the params whose name (``named_parameters()``'s, the JAX
    path with dots) ``trainable`` accepts: ``tx`` is given those params and
    their gradients only, so a clip inside it sees only theirs, and the
    others keep their values and get no optimizer state (the JAX package's
    ``masked``: base weights frozen, LoRA adapters trained)."""
    return GradientTransformation(tx.init, tx.update, trainable)


def updated_by(tx: GradientTransformation) -> Callable[[str], bool]:
    """The predicate over param names of the params ``tx`` updates."""
    return tx.trainable or (lambda name: True)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule`` in f32."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(0, transition_steps).float()
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value

    return schedule


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax's ``join_schedules``: past each boundary, the next schedule at
    ``count - boundary``."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)

        def dev(x):  # a constant leg's float, filled on the device (no copy)
            return x if isinstance(x, torch.Tensor) else torch.full(
                (), x, dtype=torch.float32, device=count.device)

        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count >= boundary, dev(sched(count - boundary)), dev(out))
        return out

    return schedule


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Schedule:
    """BERT-style linear warmup then linear decay."""
    return join_schedules(
        [linear_schedule(0.0, peak_lr, warmup_steps),
         linear_schedule(peak_lr, end_lr, max(total_steps - warmup_steps, 1))],
        [warmup_steps])


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1) in f32."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(max=decay_steps).float()
        cosine = 0.5 * (1.0 + torch.cos(np.float32(np.pi) * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_factor: float = 0.0) -> Schedule:
    """ResNet-style warmup + cosine decay: optax's
    ``warmup_cosine_decay_schedule(0, peak_lr, warmup_steps, total_steps,
    peak_lr * end_factor)``."""
    end_value = peak_lr * end_factor
    alpha = 0.0 if peak_lr == 0.0 else end_value / peak_lr
    return join_schedules(
        [linear_schedule(0.0, peak_lr, warmup_steps),
         cosine_decay_schedule(peak_lr, total_steps - warmup_steps, alpha)],
        [warmup_steps])

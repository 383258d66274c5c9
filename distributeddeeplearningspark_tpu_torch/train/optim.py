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
as the JAX package runs its optimizer in XLA, not in Pallas.

``lars`` and ``lamb`` are optax's with the JAX package's arguments.
``lars``: ``add_decayed_weights`` (masked), ``scale_by_trust_ratio``
(masked; ``trust_coefficient · ‖p‖ / ‖u‖``, 1 where either norm is 0), ``*
−lr``, then ``trace(momentum)``; both masks take the params with more than
one dim (conv and dense kernels; the OIHW convs' norms are their HWIO
norms), so BatchNorm's scales and every bias take neither. ``lamb``:
``scale_by_adam`` (eps 1e-6), ``+ weight_decay · p`` for every param,
``scale_by_trust_ratio``, ``* −lr``. Their trust ratios are norms of whole
tensors, so on shards or ZeRO slices they raise (ROADMAP Queue 1 item 3).

``adafactor`` is optax 0.2.6's (JAX's ``adafactor``):
``scale_by_factored_rms`` (the second moment of a tensor with two dims
of at least ``min_dim_size_to_factor`` kept as row and column means over
its two largest dims; decay ``1 − (t+1)^−0.8``, eps 1e-30 added to the
squares), ``clip_by_block_rms(1.0)``, ``* lr``,
``scale_by_param_block_rms`` (``* max(rms(p), 1e-3)``), ``+ weight_decay
· p`` where set, then ``* −1``. Its statistics and both RMS scalings are
taken over whole tensors, so on shards or ZeRO slices it raises
(ROADMAP Queue 1 item 5).

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


class Slices(Shards):
    """ZeRO's :class:`Shards` (:mod:`..parallel.zero`): this rank's slices
    of whole tensors (shares as :class:`Shards` say), and ``whole``, the
    whole tensors they were copied from. The first :func:`global_norm`
    over them reads ``whole``, so a clip sees the replicated optimizer's
    norm bit for bit; later ones (the slices may have changed) take the
    collective sum of :class:`Shards`."""

    def __init__(self, tensors, shares, group=None, whole=None):
        super().__init__(tensors, shares, group)
        self.whole = whole


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
    whole = getattr(tensors, "whole", None)
    if whole is not None:
        tensors.whole = None
        tensors = whole
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


def _kernels_only(p: torch.Tensor) -> bool:
    """The JAX package's LARS mask: params with more than one dim."""
    return p.ndim > 1


def add_decayed_weights(weight_decay: float,
                        mask: Callable[[torch.Tensor], bool] | None = None
                        ) -> GradientTransformation:
    """``updates + weight_decay · p``; with ``mask``, only for the params it
    accepts (optax's ``mask=``)."""
    def update(updates, state, params):
        if mask is None:
            torch._foreach_add_(updates, params, alpha=weight_decay)
            return updates, state
        sel = [i for i, p in enumerate(params) if mask(p)]
        if sel:
            torch._foreach_add_([updates[i] for i in sel], [params[i] for i in sel],
                                alpha=weight_decay)
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


def _refuse_shards(updates: Tensors, name: str) -> None:
    if isinstance(updates, Shards) and any(updates.shares):
        raise NotImplementedError(
            f"{name} over shards or ZeRO slices: its trust ratio is the norm of "
            f"a whole tensor; not ported yet: ROADMAP Queue 1 item 3")


def scale_by_trust_ratio(trust_coefficient: float = 1.0, eps: float = 0.0,
                         mask: Callable[[torch.Tensor], bool] | None = None,
                         name: str = "scale_by_trust_ratio"
                         ) -> GradientTransformation:
    """optax's ``scale_by_trust_ratio`` (``min_norm`` 0): each update times
    ``trust_coefficient · ‖p‖ / (‖u‖ + eps)``, or 1 where either norm is 0;
    with ``mask``, only the params it accepts (optax's ``masked``). Raises
    on shards and ZeRO slices, whose norms are a slice's."""
    def update(updates, state, params):
        _refuse_shards(updates, name)
        sel = [i for i, p in enumerate(params) if mask is None or mask(p)]
        if not sel:
            return updates, state
        ups = [updates[i] for i in sel]
        p_norm = torch._foreach_norm([params[i] for i in sel])
        u_norm = torch._foreach_norm(ups)
        ratios = [torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn),
                              trust_coefficient * pn / (un + eps))
                  for pn, un in zip(p_norm, u_norm)]
        torch._foreach_mul_(ups, ratios)
        return updates, state

    return GradientTransformation(lambda params: (), update)


def lars(learning_rate: float | Schedule, *, momentum: float = 0.9,
         weight_decay: float = 1e-4,
         trust_coefficient: float = 0.001) -> GradientTransformation:
    """LARS (You et al., arXiv:1708.03888), the large-batch CNN optimizer:
    the JAX package's ``optax.lars`` with weight decay and the trust ratio
    masked to the params with more than one dim (conv and dense kernels;
    BatchNorm's scales and the biases take neither), eps 0, then the
    momentum trace after ``* −lr``. Pair it with :func:`warmup_cosine`."""
    return chain(add_decayed_weights(weight_decay, _kernels_only),
                 scale_by_trust_ratio(trust_coefficient, mask=_kernels_only,
                                      name="lars"),
                 scale_by_learning_rate(learning_rate),
                 trace(momentum))


def lamb(learning_rate: float | Schedule, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.01) -> GradientTransformation:
    """LAMB (You et al., arXiv:1904.00962), the large-batch BERT optimizer:
    ``optax.lamb`` as the JAX package calls it (weight decay on every
    param, no mask)."""
    def refuse(updates, state, params):
        _refuse_shards(updates, "lamb")  # before Adam's moments see a slice
        return updates, state

    return chain(GradientTransformation(lambda params: (), refuse),
                 scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(name="lamb"),
                 scale_by_learning_rate(learning_rate))


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


class FactoredState(NamedTuple):
    """optax's ``FactoredState``: a tensor's row and column means where it
    is factored, else its whole second moment (the others a one-element
    zero, as optax keeps them)."""
    count: torch.Tensor
    v_row: Tensors
    v_col: Tensors
    v: Tensors


def _factored_dims(shape: tuple[int, ...], min_dim_size_to_factor: int
                   ) -> tuple[int, int] | None:
    """optax's: the second largest and the largest dim, where the second
    largest is at least ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


#: optax's ``adafactor`` defaults, which JAX's keeps: the second moment's
#: decay exponent (from step 0) and the eps added to the squares
ADAFACTOR_DECAY, ADAFACTOR_EPS = 0.8, 1e-30


def scale_by_factored_rms(min_dim_size_to_factor: int = 128) -> GradientTransformation:
    """optax's ``scale_by_factored_rms`` (factored second moments) at
    ``ADAFACTOR_DECAY`` and ``ADAFACTOR_EPS``."""
    def init(params):
        def one(p):
            return torch.zeros(1, dtype=p.dtype, device=p.device)

        v_row, v_col, v = [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                v_row.append(one(p))
                v_col.append(one(p))
                v.append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            v_row.append(p.new_zeros([n for i, n in enumerate(p.shape) if i != d0]))
            v_col.append(p.new_zeros([n for i, n in enumerate(p.shape) if i != d1]))
            v.append(one(p))
        return FactoredState(_count(params), v_row, v_col, v)

    def update(updates, state, params):
        if isinstance(updates, Shards) and any(updates.shares):
            raise NotImplementedError(
                "adafactor over shards or ZeRO slices: its factored moments and "
                "its RMS scalings are per whole tensor; not ported yet: ROADMAP "
                "Queue 1 item 5")
        decay = 1.0 - torch.pow((state.count + 1).float(), -ADAFACTOR_DECAY)
        out, v_row, v_col, v = [], [], [], []
        for g, vr, vc, vv in zip(updates, state.v_row, state.v_col, state.v):
            sq = g.square() + ADAFACTOR_EPS
            dims = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            if dims is None:
                vv = decay * vv + (1.0 - decay) * sq
                out.append(g * torch.pow(vv, -0.5))
            else:
                d1, d0 = dims
                vr = decay * vr + (1.0 - decay) * sq.mean(d0)
                vc = decay * vc + (1.0 - decay) * sq.mean(d1)
                row_mean = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                row = torch.pow(vr / row_mean, -0.5)
                col = torch.pow(vc, -0.5)
                out.append(g * row.unsqueeze(d0) * col.unsqueeze(d1))
            v_row.append(vr)
            v_col.append(vc)
            v.append(vv)
        return out, FactoredState(state.count + 1, v_row, v_col, v)

    return GradientTransformation(init, update)


def clip_by_block_rms() -> GradientTransformation:
    """optax's ``clip_by_block_rms(1.0)``: each tensor divided by ``max(1,
    rms)``."""
    def update(updates, state, params):
        return [u / torch.clamp(torch.sqrt(u.square().mean()), min=1.0)
                for u in updates], state

    return GradientTransformation(lambda params: (), update)


def scale_by_param_block_rms() -> GradientTransformation:
    """optax's: each update times its param's RMS, at least 1e-3."""
    def update(updates, state, params):
        out = []
        for u, p in zip(updates, params):
            rms = torch.sqrt(p.square().mean())
            out.append(u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms))
        return out, state

    return GradientTransformation(lambda params: (), update)


def adafactor(learning_rate: float | Schedule, *, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> GradientTransformation:
    """JAX's ``adafactor``: ``optax.adafactor(learning_rate,
    min_dim_size_to_factor=..., weight_decay_rate=weight_decay or None)``
    with optax's defaults (decay 0.8 from step 0, parameter scaling,
    clipping threshold 1, eps 1e-30, no momentum)."""
    txs = [scale_by_factored_rms(min_dim_size_to_factor),
           clip_by_block_rms(),
           scale_by_learning_rate(
               (lambda c: -learning_rate(c)) if callable(learning_rate)
               else -learning_rate),
           scale_by_param_block_rms()]
    if weight_decay:
        txs.append(add_decayed_weights(weight_decay))
    txs.append(scale_by_learning_rate(1.0))
    return chain(*txs)


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

"""The train and eval steps — the port of ``train/step.py``.

The JAX package compiles ``(state, batch) -> (state, metrics)`` into one
jitted SPMD program; here the same function runs eagerly: the forward in
train mode (dropout drawn from the state's generator), ``loss.backward()``,
the global gradient norm reported as ``grad_norm``, the optimizer's update
applied to the params in place, ``step + 1``. The model's buffers
(BatchNorm's running statistics, ``state.mutable``) are updated by the
forward itself and are neither params nor optimizer state. It never copies to the host:
metrics stay device tensors until the loop's log point, as the JAX loop
fetches them only there.

``guard_nonfinite=True`` (``Trainer.fit(on_nonfinite="skip")``) is the
JAX step's guard: ``ok = isfinite(grad_norm)``, taken after the gang's
all-reduce and the ``accum_steps`` division, so every rank decides alike;
where ``ok`` is false the params, the optimizer state and the model's
buffers keep their values from before the step, which still counts
(``step + 1``), and ``metrics["skipped"]`` is ``1 - ok`` as a device
tensor. The optimizer updates in place and the forward moves BatchNorm's
statistics in place, so zeroing the update would not do (Adam's moments,
SGD's trace and the statistics would already hold the NaN, and
``new * ok + old * (1 - ok)`` is NaN under NaN): the step copies every
tensor it may change into a flat snapshot buffer per dtype before the
forward, and after the update selects ``where(ok, new, old)`` in flat
space and copies the choice back, in a few multi-tensor launches and
with no host sync. The buffers are allocated once, at the first guarded
step. The optimizer's counts (the schedule's, Adam's bias correction)
are 0-d device tensors (:mod:`.optim`) and are held back with the rest.

``trainable`` (a predicate over param names, the LoRA fine-tune's
``lora_trainable``): the params it rejects leave autograd
(``requires_grad_(False)``), so they take no ``.grad``, no gradient
matmul, no part in ``grad_norm`` and no update, where the JAX step
``stop_gradient``\\ s them into zero gradients (the same norm, the same
update under the masked optimizer). The optimizer (:mod:`.optim`) sees the
params that ``trainable`` and its own mask (``optim.masked``) both accept,
in ``state.params`` order (:func:`optimizer_params`).

``accum_steps > 1``: the batch splits into that many equal micro-batches
(in order along the batch axis; a batch that does not divide raises), each
one forward and backward, the gradients summed in ``.grad`` as the JAX
step's scan sums them and divided by ``accum_steps``; the metrics are the
micro-batches' mean.

``distributed=True`` (a data-parallel gang, :mod:`..parallel.collectives`):
each rank holds its own rows of the global batch, and the step makes the
JAX step's gradient of the *global* batch's loss. Before each backward, one
small all-reduce of the ranks' weights (the loss's ``"weight"``, else the
rows) scales rank r's loss by ``w_r / W`` and makes the logged metrics
global; after the last backward, the gradients are summed across ranks
once, one flat buffer per dtype. ``grad_norm`` and clipping see the reduced
gradient. Micro-batch i is every rank's i-th slice of its rows. The model's
buffers are not reduced: BatchNorm's forward already takes the global
batch's statistics (:mod:`..models.resnet`), so they move alike on every
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train.optim import (
    GradientTransformation,
    global_norm,
    updated_by,
)
from distributeddeeplearningspark_tpu_torch.train.state import TrainState, leaves

LossFn = Callable[[Any, dict[str, Any]], tuple[torch.Tensor, dict[str, torch.Tensor]]]


def optimizer_params(names, tx: GradientTransformation,
                     trainable: Callable[[str], bool] | None = None) -> list[str]:
    """The names among ``names`` (in order) of the params the optimizer
    updates: those ``trainable`` and ``tx``'s mask both accept."""
    mask = updated_by(tx)
    return [n for n in names if (trainable is None or trainable(n)) and mask(n)]


def split_batch(batch: dict[str, torch.Tensor], accum_steps: int
                ) -> list[dict[str, torch.Tensor]]:
    """``accum_steps`` equal micro-batches along the batch axis, in order
    (the JAX step's ``reshape((accum_steps, rows // accum_steps, ...))``)."""
    if accum_steps == 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0]
    if rows % accum_steps:
        raise ValueError(f"global batch {rows} must divide by accum_steps "
                         f"{accum_steps}")
    m = rows // accum_steps
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(accum_steps)]


class NonfiniteGuard:
    """The flat snapshot of what a step may change, one buffer per (dtype,
    device), and the select that keeps it where the step was not finite.
    :meth:`save` before the forward, :meth:`keep_old_unless` after the
    update; the tensor list keeps its shapes and order from step to step
    (one of another length lays the buffers out anew)."""

    def __init__(self):
        self._groups: list[tuple[list[int], torch.Tensor, torch.Tensor,
                                 list[torch.Tensor], list[torch.Tensor]]] = []
        self._count = -1
        self.nbytes = 0

    def _layout(self, tensors: list[torch.Tensor]) -> None:
        by_key: dict[tuple, list[int]] = {}
        for i, t in enumerate(tensors):
            by_key.setdefault((t.dtype, t.device), []).append(i)
        self._groups = []
        for (dtype, device), idx in by_key.items():
            total = sum(tensors[i].numel() for i in idx)
            old = torch.empty(total, dtype=dtype, device=device)
            new = torch.empty(total, dtype=dtype, device=device)
            old_views, new_views, off = [], [], 0
            for i in idx:
                n, shape = tensors[i].numel(), tensors[i].shape
                old_views.append(old[off:off + n].view(shape))
                new_views.append(new[off:off + n].view(shape))
                off += n
            self._groups.append((idx, old, new, old_views, new_views))
        self._count = len(tensors)
        self.nbytes = sum(2 * g[1].numel() * g[1].element_size()
                          for g in self._groups)

    def save(self, tensors: list[torch.Tensor]) -> None:
        if len(tensors) != self._count:
            self._layout(tensors)
        with torch.no_grad():
            for idx, _, _, old_views, _ in self._groups:
                torch._foreach_copy_(old_views, [tensors[i] for i in idx])

    def keep_old_unless(self, ok: torch.Tensor, tensors: list[torch.Tensor]) -> None:
        """Each of ``tensors`` (the same ones, possibly new objects of the
        same shapes) becomes ``where(ok, itself, its saved value)``."""
        with torch.no_grad():
            for idx, old, new, old_views, new_views in self._groups:
                live = [tensors[i] for i in idx]
                torch._foreach_copy_(new_views, live)
                torch.where(ok, new, old, out=old)
                torch._foreach_copy_(live, old_views)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def make_train_step(model: torch.nn.Module, tx: GradientTransformation,
                    loss_fn: LossFn, *, distributed: bool = False,
                    trainable: Callable[[str], bool] | None = None,
                    accum_steps: int = 1, guard_nonfinite: bool = False):
    """(state, batch) → (state, metrics). ``model(batch, generator=g)``
    returns the outputs ``loss_fn(outputs, batch)`` consumes. Sets each
    param's ``requires_grad`` from ``trainable`` (None: every param).
    ``guard_nonfinite``: skip the update of a step whose gradient is not
    finite (the module docstring); the step's ``guard`` attribute is its
    :class:`NonfiniteGuard` (None without)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    named = dict(model.named_parameters())
    grad_names = [n for n in named if trainable is None or trainable(n)]
    for n, p in named.items():
        p.requires_grad_(trainable is None or trainable(n))
    opt_names = set(optimizer_params(grad_names, tx))
    opt_index = [i for i, n in enumerate(grad_names) if n in opt_names]

    guard = NonfiniteGuard() if guard_nonfinite else None

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = [state.params[n] for n in grad_names]
        opt_params = [params[i] for i in opt_index]
        if guard is not None:
            buffers = list(state.mutable.values())
            guard.save(opt_params + _tensors(state.opt_state) + buffers)
        model.train()
        for p in params:
            p.grad = None
        micro_metrics = []
        for mb in split_batch(batch, accum_steps):
            outputs = model(mb, generator=state.generator)
            loss, metrics = loss_fn(outputs, mb)
            if distributed:
                rows = next(iter(mb.values())).shape[0]
                loss, metrics = collectives.weigh_loss(loss, metrics, rows)
            loss.backward()
            micro_metrics.append({k: v.detach() for k, v in metrics.items()})
            del outputs, loss
        # a trainable param the forward did not reach: JAX's zero gradient
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        with torch.no_grad():
            if accum_steps > 1:
                torch._foreach_div_(grads, float(accum_steps))
            if distributed:
                collectives.all_reduce_grads(grads)
            grad_norm = global_norm(grads)
            updates, opt_state = tx.update([grads[i] for i in opt_index],
                                           state.opt_state, opt_params)
            torch._foreach_add_(opt_params, updates)
        if guard is not None:
            # a NaN/Inf anywhere in the gradients poisons their norm, so one
            # predicate covers a loss blowup and a gradient blowup
            ok = torch.isfinite(grad_norm)
            guard.keep_old_unless(ok, opt_params + _tensors(opt_state) + buffers)
        for p in params:
            p.grad = None
        metrics = (micro_metrics[0] if accum_steps == 1 else
                   {k: torch.stack([m[k] for m in micro_metrics]).mean(0)
                    for k in micro_metrics[0]})
        metrics["grad_norm"] = grad_norm
        if guard is not None:
            metrics["skipped"] = 1.0 - ok.float()
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    train_step.guard = guard
    return train_step


def make_eval_step(model: torch.nn.Module, loss_fn: LossFn):
    """batch → metrics, no gradients, the model in eval mode."""

    def eval_step(batch: dict[str, torch.Tensor]):
        model.eval()
        with torch.inference_mode():
            _, metrics = loss_fn(model(batch), batch)
        return metrics

    return eval_step

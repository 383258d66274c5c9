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

Under FSDP and tensor parallelism (``Trainer(rules=...)`` lowered the
model with :func:`..parallel.sharding.fully_shard_model`) a sharded param
is a ``DTensor``. ``mesh`` (the session's) names the groups: the loss is
weighed over the loss group (``data × fsdp``, and ``seq`` below: the
``tensor`` peers hold the same rows). An FSDP-sharded param's gradient arrives reduced from
FSDP2's backward (reduce-scattered over ``fsdp``, all-reduced over
``data``); every other trainable's (a replicated param, a param split over
``tensor`` only) goes through ``all_reduce_grads`` over the loss group
(a tensor-split layer's gradient is its shard's already, and the LoRA
adapters' arrive summed over ``tensor`` from the model's backward).
Everything after the backward runs on the local shards (``to_local()``,
views of the params' storage), so no multi-tensor op mixes ``DTensor``
and ``Tensor``: ``grad_norm`` is the whole gradient's (each distinct
shard's squares summed once across the ``fsdp × tensor`` group, each
replicated gradient counted once, :class:`..train.optim.Shards`), the
optimizer updates each shard in place and keeps its state as shards
(``DTensor``\\ s in ``state.opt_state``, sharded like their params), and
the guard snapshots and restores shards. Without ``mesh`` both groups are
the whole gang.

Under context parallelism (``seq`` above 1) each rank holds a block of
its rows' sequence, so the loss is weighed over the loss group (``data ×
fsdp × seq``) and the gradients are summed over it: the data-parallel
path's all-reduce takes the loss group, and the FSDP-reduced gradients
(reduce-scattered over ``fsdp`` only, since the rules never shard over
``seq`` and the params are replicated across it) are all-reduced over
the ``seq`` group, on their local shards: each card keeps the rule
engine's bytes. ``grad_norm`` stays over ``SHARD_AXES``.

On a pipeline (``pipe`` above 1, :mod:`..models.llama_pp`) each rank
holds its stage's layers and the replicated embedding, head and final
norm, and the pipe peers compute the same loss on the same rows. A
stage's params reduce over the loss group inside the stage, as above. The
replicated ones: the params only stage 0 uses (the embedding,
``model.pipe.first_stage_params``), whose gradient only stage 0 produces,
are summed over the pipe group (the other peers add zeros); the head's
and the final norm's are whole on every peer already and are not (that
would count them P times). ``grad_norm`` sums each stage's params'
squares across the pipe group too (``STAGE_SHARD_AXES``, each stage's
param weighed by the ranks of its stage that hold it) and counts the
replicated ones once, so it is one device's, and a NaN on any stage
skips the guarded update on every stage.

A model with a ``batch_sum`` attribute (the MoE Llama,
:mod:`..models.llama`) gets a differentiable all-reduce over the loss
group there in a distributed step: its load-balance loss E · Σₑ fₑ · p̄ₑ is
a product of two means over the global batch, which a mean of the ranks'
products is not. Every rank then adds the same global aux to its loss,
and the ``w_r / W`` weighing sums it to the aux once; its gradient, summed
back over the group by the all-reduce's backward and then over the ranks'
gradients, is the global batch's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding
from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
    AXIS_PIPE,
    AXIS_SEQ,
    LOSS_AXES,
    SHARD_AXES,
    STAGE_SHARD_AXES,
)
from distributeddeeplearningspark_tpu_torch.train.optim import (
    GradientTransformation,
    Shards,
    global_norm,
    updated_by,
)
from distributeddeeplearningspark_tpu_torch.train.state import (
    TrainState,
    leaves,
    map_leaves,
)

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


def _rewrap(old: Any, new: Any) -> Any:
    """The optimizer's new state leaf in the state's form: where the old
    leaf is sharded, the new local shard as a ``DTensor`` of its layout
    (the old one itself when the update wrote its shard in place)."""
    if not sharding.is_sharded(old):
        return new
    if new.data_ptr() == sharding.local(old).data_ptr():
        return old
    return type(old).from_local(new, old.device_mesh, old.placements,
                                shape=old.shape, stride=old.stride(),
                                run_check=False)


def make_train_step(model: torch.nn.Module, tx: GradientTransformation,
                    loss_fn: LossFn, *, distributed: bool = False,
                    trainable: Callable[[str], bool] | None = None,
                    accum_steps: int = 1, guard_nonfinite: bool = False,
                    mesh=None):
    """(state, batch) → (state, metrics). ``model(batch, generator=g)``
    returns the outputs ``loss_fn(outputs, batch)`` consumes. Sets each
    param's ``requires_grad`` from ``trainable`` (None: every param).
    ``guard_nonfinite``: skip the update of a step whose gradient is not
    finite (the module docstring); the step's ``guard`` attribute is its
    :class:`NonfiniteGuard` (None without). ``mesh``: the session's
    :class:`~..parallel.mesh.Mesh`, whose groups the step reduces over."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    named = dict(model.named_parameters())
    grad_names = [n for n in named if trainable is None or trainable(n)]
    for n, p in named.items():
        p.requires_grad_(trainable is None or trainable(n))
    opt_names = set(optimizer_params(grad_names, tx))
    opt_index = [i for i, n in enumerate(grad_names) if n in opt_names]
    # which trainables FSDP2 reduces, and each one's share of the norm
    loss_group = mesh.group(LOSS_AXES) if mesh is not None else None
    seq_split = mesh is not None and mesh.shape[AXIS_SEQ] > 1
    seq_group = mesh.group((AXIS_SEQ,)) if seq_split else None
    stages = mesh.shape[AXIS_PIPE] if mesh is not None else 1
    shard_axes = STAGE_SHARD_AXES if stages > 1 else SHARD_AXES
    shard_size = (mesh.size(shard_axes) if mesh is not None
                  else collectives.world_size())
    by_fsdp = [sharding.fsdp_reduced(named[n]) for n in grad_names]
    shares = [sharding.norm_share(named[n], shard_size, stages) for n in grad_names]
    shard_group = (mesh.group(shard_axes) if mesh is not None and any(shares)
                   else None)
    # the params only a pipeline's stage 0 uses: summed over the pipe group
    first_stage = getattr(getattr(model, "pipe", None), "first_stage_params", ())
    pipe_summed = [i for i, n in enumerate(grad_names) if stages > 1 and n in first_stage]
    pipe_group = mesh.group((AXIS_PIPE,)) if pipe_summed else None

    def shards(tensors: list, index: list[int]) -> list:
        if not any(shares):
            return tensors
        return Shards(tensors, [shares[i] for i in index], shard_group)

    guard = NonfiniteGuard() if guard_nonfinite else None
    loss_ranks = mesh.size(LOSS_AXES) if mesh is not None else collectives.world_size()
    if distributed and hasattr(model, "batch_sum"):
        # the MoE load balance is a product of two global-batch means: the
        # model adds its batch sums over the ranks that hold distinct rows
        # (the loss group) before the product, so every rank's aux is the
        # global one and, weighed by w_r / W, it joins the loss once; a loss
        # group of one rank (expert or tensor peers only) holds them all
        model.batch_sum = (functools.partial(collectives.all_reduce_sum, axis=LOSS_AXES,
                                             group=loss_group)
                           if loss_ranks > 1 else None)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = [state.params[n] for n in grad_names]
        opt_params = [sharding.local(params[i]) for i in opt_index]
        opt_state = map_leaves(sharding.local, state.opt_state)
        if guard is not None:
            buffers = list(state.mutable.values())
            guard.save(opt_params + _tensors(opt_state) + buffers)
        model.train()
        for p in params:
            p.grad = None
        micro_metrics = []
        for mb in split_batch(batch, accum_steps):
            outputs = model(mb, generator=state.generator)
            loss, metrics = loss_fn(outputs, mb)
            if distributed:
                rows = next(iter(mb.values())).shape[0]
                loss, metrics = collectives.weigh_loss(loss, metrics, rows,
                                                       loss_group)
            loss.backward()
            micro_metrics.append({k: v.detach() for k, v in metrics.items()})
            del outputs, loss
        # a trainable param the forward did not reach: JAX's zero gradient
        grads = shards([sharding.local(torch.zeros_like(p) if p.grad is None
                                       else p.grad) for p in params],
                       list(range(len(params))))
        with torch.no_grad():
            if accum_steps > 1:
                torch._foreach_div_(grads, float(accum_steps))
            if distributed:
                # FSDP2 already reduced its own over the batch dims in its
                # backward; under context parallelism the seq peers' remain
                collectives.all_reduce_grads(
                    [g for g, f in zip(grads, by_fsdp) if not f], loss_group)
                if seq_split and any(by_fsdp):
                    collectives.all_reduce_grads(
                        [g for g, f in zip(grads, by_fsdp) if f], seq_group)
                if pipe_summed:
                    collectives.all_reduce_grads([grads[i] for i in pipe_summed],
                                                 pipe_group)
            grad_norm = global_norm(grads)
            updates, opt_state = tx.update(shards([grads[i] for i in opt_index],
                                                  opt_index), opt_state, opt_params)
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
        return dataclasses.replace(
            state, step=state.step + 1,
            opt_state=map_leaves(_rewrap, state.opt_state, opt_state)), metrics

    train_step.guard = guard
    return train_step


def make_eval_step(model: torch.nn.Module, loss_fn: LossFn):
    """batch → metrics, no gradients, the model in eval mode. Under
    ``no_grad``, not ``inference_mode``: FSDP2 keeps a root's gathered
    params between forwards, and a training forward refuses those made in
    inference mode ("Inplace update to inference tensor outside
    InferenceMode")."""

    def eval_step(batch: dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            _, metrics = loss_fn(model(batch), batch)
        return metrics

    return eval_step

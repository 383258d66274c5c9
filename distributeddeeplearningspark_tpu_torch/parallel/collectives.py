"""The collectives the data-parallel path calls, over ``torch.distributed``.

The port of the parts of ``distributeddeeplearningspark_tpu/parallel/
collectives.py`` (and of ``utils/sanitize.py``'s replica check) that the
LeNet path runs. Under GSPMD the JAX step's gradient is the gradient of
the global batch's loss, reduced by XLA; here each rank holds its own rows,
so the train step makes the same gradient in two collectives:

1. :func:`weigh_loss` — one small all-reduce of each rank's weight ``w_r``
   (the loss's ``"weight"`` metric when it reports one, else its row
   count) beside its weighted metrics. Rank r's loss is scaled by
   ``w_r / W`` before backward, ``W`` the sum, and the metrics come back
   global (``perplexity`` the exp of the global loss). For a mean over
   rows on equal shards this is the plain mean;
   for ``masked_lm`` it is what stays exact when ranks hold unequal
   numbers of masked tokens (unless a rank holds none: the loss clamps
   its weight to 1).
2. :func:`all_reduce_grads` — the gradients summed across ranks in place,
   one flat buffer per dtype (one collective each, not one per param).

Under tensor parallelism (a mesh with ``tensor`` above 1) the batch is
split over the ``data × fsdp`` ranks only and the ranks of one ``tensor``
group hold the same rows, so the train step passes both collectives the
session's loss group (``Mesh.group(LOSS_AXES)``, ``data × fsdp × seq``:
the ``seq`` peers of context parallelism each hold a block of the same
rows' tokens): summed over the whole gang, every row would count
``tensor`` times.

Two more carry the models whose JAX step reduces inside the forward:

- :func:`all_reduce_sum` — a differentiable sum across ranks, for
  BatchNorm's statistics (JAX's ``mean`` over the sharded batch axis,
  which GSPMD reduces over the mesh): the forward sums each rank's column
  sums, the backward sums the gradients that reach them, since every
  rank's loss depends on every rank's rows through the global statistics;
- :func:`all_gather_rows` — the row-sparse step's merge: every rank's ids
  and gathered-vector gradients in rank order, which is the global
  batch's row order.

Megatron's two tensor-parallel operators carry a layer split over a
``tensor`` group (:mod:`..models.llama`): :func:`all_reduce_backward`
(``f``: the identity forward, the gradient summed across the group; at a
column-split layer's input, whose gradient each peer holds a part of)
and :func:`all_reduce_forward` (``g``: the sum forward, the gradient passed
as it is; after a row-split layer, whose output each peer holds a part
of). The LoRA adapters, replicated but used on each peer's columns only,
go through ``f`` too, so their gradients arrive summed across the group.

:func:`grad_average` is the reference's round loop, a numpy average of
per-partition gradients, which tests hold the step to. Whether the ranks'
replicas agree is :func:`..utils.sanitize.assert_replicas_in_sync`'s check.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def _dist():
    import torch.distributed as dist

    return dist


def active() -> bool:
    """True when this process is in a ``torch.distributed`` group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return _dist().get_world_size() if active() else 1


def rank() -> int:
    return _dist().get_rank() if active() else 0


def barrier() -> None:
    """Wait for every rank (a no-op outside a group)."""
    if not active():
        return
    dist = _dist()
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` from rank ``src`` on every rank (picklable objects)."""
    if not active():
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> list:
    """Every rank's ``obj`` (picklable), in rank order (``[obj]`` outside a
    group)."""
    if not active():
        return [obj]
    out: list = [None] * world_size()
    _dist().all_gather_object(out, obj)
    return out


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` across the ranks of ``group`` (None: every rank) in place
    (a no-op outside a group)."""
    if active():
        _dist().all_reduce(t, group=group)
    return t


def weigh_loss(loss: torch.Tensor, metrics: dict[str, torch.Tensor],
               rows: int, group=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Rank r's loss scaled by ``w_r / W`` and the metrics made global, by
    one all-reduce of ``[w_r, m·w_r ...]`` over ``group`` (None: every
    rank; under tensor or context parallelism the loss group). ``"weight"`` comes
    back as W."""
    w = metrics.get("weight")
    w = (w.detach().float().reshape(()) if w is not None
         else torch.full((), float(rows), device=loss.device))
    names = [k for k in metrics if k != "weight"]
    vec = torch.stack([w] + [metrics[k].detach().float().reshape(()) * w
                             for k in names])
    all_reduce_sum_(vec, group)
    total = vec[0]
    out = {k: v for k, v in zip(names, vec[1:] / total)}
    if "perplexity" in out and "loss" in out:
        # exp of the global loss, as JAX's; not the mean of the ranks' exps
        out["perplexity"] = torch.exp(out["loss"])
    out["weight"] = total
    return loss * (w / total), out


def all_reduce_grads(grads: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``grads`` across the ranks of ``group`` (None: every rank) in
    place: one flat buffer and one all-reduce per dtype (a no-op outside a
    group). Counts the calls that reduce in ``all_reduce_grads.calls``: the
    train step makes one a step, in a gang of one too."""
    if not active():
        return
    all_reduce_grads.calls += 1
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        _dist().all_reduce(flat, group=group)
        parts = flat.split([g.numel() for g in same])
        torch._foreach_copy_(same, [p.view_as(g) for p, g in zip(parts, same)])


all_reduce_grads.calls = 0


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; the gradient is summed across ranks too."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.detach().clone(memory_format=torch.contiguous_format)
        all_reduce_sum.calls += 1
        _dist().all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_sum.calls += 1
        _dist().all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed across ranks, differentiably: the backward sums the
    incoming gradient across ranks. ``t`` itself outside a group. Counts
    the collectives it makes, forward and backward, in
    ``all_reduce_sum.calls``: ResNet-50 makes 53 of each a train step."""
    if not active():
        return t
    return _AllReduceSum.apply(t)


all_reduce_sum.calls = 0


class _AllReduceForward(torch.autograd.Function):
    """Megatron's ``g``: summed across ``group``, the gradient as it is."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        all_reduce_forward.calls += 1
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _AllReduceBackward(torch.autograd.Function):
    """Megatron's ``f``: the identity, the gradient summed across ``group``."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_backward.calls += 1
        _dist().all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_forward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed across the ranks of ``group``; its gradient reaches
    each rank's ``t`` unreduced (every rank computes the same loss from the
    sum). Counts its collectives in ``all_reduce_forward.calls``."""
    return _AllReduceForward.apply(t, group)


def all_reduce_backward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient is summed across the ranks of ``group``
    (each rank's holds the part its shard of the next layer gives). Counts
    its collectives in ``all_reduce_backward.calls``."""
    return _AllReduceBackward.apply(t, group)


all_reduce_forward.calls = 0
all_reduce_backward.calls = 0


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of ``group`` (None: every rank)
    concatenated along dim 0 in rank order (``t`` itself outside a group
    and in a group of one)."""
    if not active() or _dist().get_world_size(group) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(_dist().get_world_size(group))]
    _dist().all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def grad_average(partition_grads: Sequence[Any]) -> Any:
    """Average per-partition gradient trees in one process (parity mode):
    dicts, lists and tuples of numpy arrays, summed in partition order in
    f32 and divided by the partition count."""
    n = len(partition_grads)
    first = partition_grads[0]
    if isinstance(first, dict):
        return {k: grad_average([g[k] for g in partition_grads]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(grad_average([g[i] for g in partition_grads])
                           for i in range(len(first)))
    acc = np.array(first, copy=True)
    for g in partition_grads[1:]:
        acc += np.asarray(g)
    return acc / n

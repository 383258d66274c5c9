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
   global. For a mean over rows on equal shards this is the plain mean;
   for ``masked_lm`` it is what stays exact when ranks hold unequal
   numbers of masked tokens (unless a rank holds none: the loss clamps
   its weight to 1).
2. :func:`all_reduce_grads` — the gradients summed across ranks in place,
   one flat buffer per dtype (one collective each, not one per param).

Two more carry the models whose JAX step reduces inside the forward:

- :func:`all_reduce_sum` — a differentiable sum across ranks, for
  BatchNorm's statistics (JAX's ``mean`` over the sharded batch axis,
  which GSPMD reduces over the mesh): the forward sums each rank's column
  sums, the backward sums the gradients that reach them, since every
  rank's loss depends on every rank's rows through the global statistics;
- :func:`all_gather_rows` — the row-sparse step's merge: every rank's ids
  and gathered-vector gradients in rank order, which is the global
  batch's row order.

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


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` across ranks in place (a no-op outside a group)."""
    if active():
        _dist().all_reduce(t)
    return t


def weigh_loss(loss: torch.Tensor, metrics: dict[str, torch.Tensor],
               rows: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Rank r's loss scaled by ``w_r / W`` and the metrics made global, by
    one all-reduce of ``[w_r, m·w_r ...]``. ``"weight"`` comes back as W."""
    w = metrics.get("weight")
    w = (w.detach().float().reshape(()) if w is not None
         else torch.full((), float(rows), device=loss.device))
    names = [k for k in metrics if k != "weight"]
    vec = torch.stack([w] + [metrics[k].detach().float().reshape(()) * w
                             for k in names])
    all_reduce_sum_(vec)
    total = vec[0]
    out = {k: v for k, v in zip(names, vec[1:] / total)}
    out["weight"] = total
    return loss * (w / total), out


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum ``grads`` across ranks in place: one flat buffer and one
    all-reduce per dtype (a no-op outside a group). Counts the calls that
    reduce in ``all_reduce_grads.calls``: the train step makes one a step."""
    if not active():
        return
    all_reduce_grads.calls += 1
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        _dist().all_reduce(flat)
        parts = flat.split([g.numel() for g in group])
        torch._foreach_copy_(group, [p.view_as(g) for p, g in zip(parts, group)])


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


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order (``t`` itself outside a group and in a gang of one)."""
    if world_size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size())]
    _dist().all_gather(parts, t.contiguous())
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

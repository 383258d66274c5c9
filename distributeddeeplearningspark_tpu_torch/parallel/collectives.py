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
per-partition gradients, which tests hold the step to; :func:`tree_aggregate`
is Spark's ``treeAggregate`` on the driver, which its parity tests use.
Whether the ranks' replicas agree is
:func:`..utils.sanitize.assert_replicas_in_sync`'s check.

The Horovod verbs (JAX's explicit style): :func:`all_reduce_sum`,
:func:`all_reduce_mean`, :func:`all_gather` (tiled: along dim 0),
:func:`reduce_scatter` (each rank its ``scatter_dim`` slice of the sum),
:func:`all_to_all` (``split_dim`` chunks out, ``concat_dim`` in),
:func:`broadcast_from` (the group's ``root``-th rank's value) and
:func:`ppermute_shift` (a ring shift). Each runs over the group of the
session mesh's axes ``axis`` (a name or a tuple of names; None: every rank
of the gang, which in a data-parallel gang is JAX's default
``BATCH_AXES``), on a tensor or a dict/list/tuple of them; JAX runs them
inside ``shard_map`` bodies, the port eagerly, every rank of the gang
calling. ``all_reduce_sum`` and ``all_reduce_mean`` are differentiable
(their gradient summed, or averaged, across the group).

The opt-in comms probes (``DLS_COMMS_PROBE=1`` or
:func:`enable_collective_probes`): the first four verbs, when probes are on,
time each eager call from dispatch to completion (the device synchronized)
and emit a ``collective`` telemetry event (``op``, ``axis``, ``wait_s``:
the JAX package's schema, which its ``fleet.host_table`` folds into the
comms-wait column); inside a region ``torch.compile`` traces they are
transparent (``torch.compiler.is_compiling()``, JAX's ``_is_tracing``):
the compiled graph schedules the collective, and no host wait is there to
measure. In the port every other call is eager, so probes on also time
(and sync the device at) BatchNorm's statistics and the MoE load balance's
sums, which JAX's compiled step keeps out of sight. :func:`barrier_probe` times one scalar all-reduce over the whole
gang; ``Trainer.fit`` takes one each log lap with probes on. JAX's
``transfer_probe`` is not ported: the live reshard's transfers report their
own spans (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import copy
import functools
import os
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch import telemetry

#: a mesh axis name, a tuple of them, or None (every rank of the gang)
AxisNames = str | Sequence[str] | None


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
        # (and of its cross-entropy: an MoE loss holds the load balance too)
        out["perplexity"] = torch.exp(out["loss"] - out.get("moe_aux", 0.0))
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
    """Sum across ``group``; the gradient is summed across it too."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.detach().clone(memory_format=torch.contiguous_format)
        all_reduce_sum.calls += 1
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_sum.calls += 1
        _dist().all_reduce(g, group=ctx.group)
        return g, None


def _all_reduce_sum(tree: Any, axis: AxisNames = None, *, group=None) -> Any:
    """Horovod's ``allreduce(op=Sum)``: ``tree`` summed across the group
    over the mesh axes ``axis`` (None: every rank; ``group``, a process
    group, in place of ``axis`` for a caller that holds one),
    differentiably: the backward sums the incoming gradient across the
    group too, since every rank's result depends on every rank's input.
    ``tree`` itself outside a process group. Counts the collectives it
    makes, forward and backward, in ``all_reduce_sum.calls``: BatchNorm's
    statistics (ResNet-50 makes 53 of each a train step) and the MoE load
    balance's batch means (:mod:`..models.moe`) go through it."""
    if not active():
        return tree
    group = _group(axis) if group is None else group
    return _map(lambda t: _AllReduceSum.apply(t, group), tree)


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


# -- the Horovod verbs and the comms probes ------------------------------------


def _names(axis: AxisNames) -> tuple[str, ...] | None:
    if axis is None:
        return None
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(axis: AxisNames):
    """The process group over the mesh axes ``axis`` on the session's mesh
    (None: every rank, also where the axes span the gang)."""
    names = _names(axis)
    if names is None:
        return None
    from distributeddeeplearningspark_tpu_torch.ops.ring_attention import resolve_mesh

    return resolve_mesh().group(names)


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` over each tensor of a tensor or a dict/list/tuple of them."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


#: the comms probes' switch (any value but ""/"0" turns them on)
COMMS_PROBE_ENV = "DLS_COMMS_PROBE"

_probe_override: bool | None = None


def enable_collective_probes(enabled: bool = True) -> None:
    """Turn the probes on or off for this process (wins over the env
    var)."""
    global _probe_override
    _probe_override = enabled


def collective_probes_enabled() -> bool:
    if _probe_override is not None:
        return _probe_override
    return os.environ.get(COMMS_PROBE_ENV, "") not in ("", "0")


def _axis_label(axis: AxisNames) -> str:
    """The event's ``axis``: the axis names, or every mesh axis for the
    whole gang (JAX's ``barrier_probe`` names them all)."""
    from distributeddeeplearningspark_tpu_torch.parallel.mesh import MESH_AXES

    names = _names(axis)
    return ",".join(MESH_AXES if names is None else names)


def _wait_for(tree: Any) -> None:
    """Block until the device has made ``tree`` (JAX's
    ``block_until_ready``)."""
    devices = set()
    _map(lambda t: devices.add(t.device) if isinstance(t, torch.Tensor) else None,
         tree)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _probed(op: str, fn: Callable) -> Callable:
    """``fn`` with the opt-in wait-time probe: with probes on, an eager call
    is timed from dispatch to completion and emitted as a ``collective``
    event; while ``torch.compile`` traces it, and with probes off, the
    wrapper is ``fn`` itself."""

    @functools.wraps(fn)
    def wrapper(tree: Any, axis: AxisNames = None, **kw: Any) -> Any:
        if not collective_probes_enabled() or torch.compiler.is_compiling():
            return fn(tree, axis, **kw)
        t0 = time.perf_counter()
        out = fn(tree, axis, **kw)
        _wait_for(out)
        telemetry.emit("collective", op=op, axis=_axis_label(axis),
                       wait_s=time.perf_counter() - t0)
        return out

    wrapper.__name__ = wrapper.__qualname__ = op
    return wrapper


#: the groups whose barrier has had its untimed first call
_barrier_warm: set = set()


def barrier_probe(mesh=None, *, tag: str = "barrier") -> float:
    """Time one scalar all-reduce over the whole gang, dispatch to
    completion, on the session's device: it cannot return before every
    rank has joined, so its host-side latency is this rank's wait for the
    gang (in a straggling gang the fast ranks' samples grow by the
    straggler's lag). The first call is an untimed warm-up (NCCL sets up
    its communicator there); each later one emits a ``collective`` event
    (``op=tag``) and returns the wait in seconds. ``mesh`` (the session's,
    by default) names the axes in the event. Outside a process group there
    is no one to wait for: the event says 0."""
    from distributeddeeplearningspark_tpu_torch.parallel.mesh import MESH_AXES

    wait = 0.0
    if active():
        from distributeddeeplearningspark_tpu_torch.session import Session

        device = (Session._active.device if Session._active is not None
                  else torch.device("cpu"))
        one = torch.ones((), device=device)
        if device not in _barrier_warm:
            _dist().all_reduce(one.clone())
            _wait_for(one)
            _barrier_warm.add(device)
        t0 = time.perf_counter()
        _dist().all_reduce(one)
        _wait_for(one)
        wait = time.perf_counter() - t0
    names = tuple(mesh.shape) if mesh is not None else MESH_AXES
    telemetry.emit("collective", op=tag, axis=",".join(names), wait_s=wait)
    return wait


def all_reduce_mean(tree: Any, axis: AxisNames = None) -> Any:
    """Horovod's default ``allreduce`` (the average) over the group:
    :func:`all_reduce_sum` over its size, differentiably."""
    if not active():
        return tree
    n = _dist().get_world_size(_group(axis))
    return _map(lambda t: t / n, _all_reduce_sum(tree, axis))


def all_gather(tree: Any, axis: AxisNames = None, *, tiled: bool = True) -> Any:
    """``hvd.allgather``: every rank's tensor of the group in group order,
    concatenated along dim 0 (``tiled``) or stacked on a new dim 0."""
    group = _group(axis) if active() else None

    def gather(t):
        if not active():
            return t if tiled else t[None]
        parts = [torch.empty_like(t) for _ in range(_dist().get_world_size(group))]
        _dist().all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts) if tiled else torch.stack(parts)

    return _map(gather, tree)


def reduce_scatter(tree: Any, axis: AxisNames = None, *, scatter_dim: int = 0) -> Any:
    """The sum over the group, each rank keeping its slice of it along
    ``scatter_dim`` (the group's size divides it), in group order (JAX's
    tiled ``psum_scatter``)."""
    if not active():
        return tree
    group = _group(axis)
    n = _dist().get_world_size(group)

    def scatter(t):
        if t.shape[scatter_dim] % n:
            raise ValueError(f"reduce_scatter: dim {scatter_dim} of {tuple(t.shape)} "
                             f"does not divide by the group's {n} ranks")
        # reduce_scatter_tensor splits dim 0: the chunks move there first
        send = t.movedim(scatter_dim, 0).contiguous()
        out = send.new_empty((send.shape[0] // n, *send.shape[1:]))
        if _dist().get_backend(group) == "gloo":  # gloo has no reduce-scatter
            _dist().all_reduce(send, group=group)
            out.copy_(send.chunk(n)[_dist().get_rank(group)])
        else:
            _dist().reduce_scatter_tensor(out, send, group=group)
        return out.movedim(0, scatter_dim)

    return _map(scatter, tree)


# one event a call: all_reduce_mean sums through the unprobed _all_reduce_sum
all_reduce_sum = _probed("all_reduce_sum", _all_reduce_sum)
all_reduce_mean = _probed("all_reduce_mean", all_reduce_mean)
all_gather = _probed("all_gather", all_gather)
reduce_scatter = _probed("reduce_scatter", reduce_scatter)
all_reduce_sum.calls = 0


def all_to_all(x: torch.Tensor, axis: AxisNames, *, split_dim: int,
               concat_dim: int, group=None) -> torch.Tensor:
    """The group's all-to-all (JAX's tiled ``all_to_all``): ``x`` split
    into as many chunks as ranks along ``split_dim``, chunk j to the
    group's j-th rank, the chunks received concatenated in group order
    along ``concat_dim`` (``group``, a process group, in place of ``axis``
    for a caller that holds one: Ulysses' exchange over ``seq``)."""
    if not active():
        return x
    group = _group(axis) if group is None else group
    n = _dist().get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does "
                         f"not divide by the group's {n} ranks")
    # all_to_all_single splits dim 0: the chunks move there first
    send = x.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send, group=group)
    parts = recv.chunk(n)  # part j came from the group's j-th rank
    return torch.cat([p.movedim(0, split_dim) for p in parts], dim=concat_dim)


def broadcast_from(tree: Any, axis: AxisNames = None, *, root: int = 0) -> Any:
    """The group's ``root``-th rank's value on every rank of the group
    (``sc.broadcast``'s semantics: re-syncing replicas)."""
    if not active():
        return tree
    group = _group(axis)
    src = _dist().get_global_rank(group, root) if group is not None else root

    def bcast(t):
        out = t.detach().clone(memory_format=torch.contiguous_format)
        _dist().broadcast(out, src=src, group=group)
        return out

    return _map(bcast, tree)


def ppermute_shift(x: torch.Tensor, axis: AxisNames, *, shift: int = 1) -> torch.Tensor:
    """A ring shift over the group: the group's i-th rank sends ``x`` to its
    (i + shift)-th and takes the (i - shift)-th's (mod the size), the
    building block of ring attention."""
    if not active():
        return x
    dist = _dist()
    group = _group(axis)
    n, i = _dist().get_world_size(group), dist.get_rank(group)

    def peer(j: int) -> int:
        j %= n
        return dist.get_global_rank(group, j) if group is not None else j

    x = x.contiguous()
    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer(i + shift), group),
                                    dist.P2POp(dist.irecv, out, peer(i - shift), group)])
    for w in works:
        w.wait()
    return out


def tree_aggregate(partitions: Iterable[Iterable[Any]], zero: Any,
                   seq_op: Callable[[Any, Any], Any],
                   comb_op: Callable[[Any, Any], Any]) -> Any:
    """Spark's ``RDD.treeAggregate`` on the driver: each partition folded
    from a fresh copy of ``zero`` with ``seq_op`` (the executors' fold),
    the partitions' results merged with ``comb_op`` (the driver's); the
    tree's depth changes only the schedule, so the merge is flat."""
    per_part = []
    for part in partitions:
        acc = copy.deepcopy(zero)
        for x in part:
            acc = seq_op(acc, x)
        per_part.append(acc)
    if not per_part:
        return zero
    return functools.reduce(comb_op, per_part)


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

"""ZeRO weight-update sharding — the port of the JAX ``Plan``'s ``zero_axes``
(``Plan.state_shardings``' ZeRO pass and ``Plan.wrap_optimizer``'s pin).

A plan with ``zero_axes`` keeps the params replicated and stores each
optimizer-state leaf of at least ``zero_min_size`` elements as this rank's
slice, along the dim :func:`.sharding.add_axis_spec` picks over the zero
axes (JAX's ``opt_state`` spec), so the state's bytes a card fall by the
zero degree. A sliced leaf is a ``DTensor`` on the zero axes' sub-mesh,
``Shard(dim)`` on each (several axes on one dim chunk in mesh order, as
JAX's tuple entry does), so checkpoints save it whole (gathered, as an
FSDP-sharded leaf is) and a restore writes each rank's slice of the whole
at any rank count.

The step (:meth:`ZeroLayout.update`) keeps JAX's pin: the gradients are
all-reduced whole, exactly as the replicated data-parallel step reduces
them; the optimizer then runs on this rank's slices of the gradients and
params (contiguous copies, so every elementwise op computes each element
as on the whole tensor) and its own state slices, and the updated slices
are all-gathered into every replica's params. The losses and params are
therefore bitwise the replicated optimizer's. A global norm inside the
optimizer (``with_grad_clip``) reads the whole gradients once
(:class:`..train.optim.Slices`), the replicated norm bit for bit.

The params the plan's rules shard are FSDP2's or ``DTensor``'s own, and
ZeRO beside them is not ported (ROADMAP Queue 1 item 5): a ZeRO plan
needs every param the optimizer updates replicated.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from distributeddeeplearningspark_tpu_torch.parallel.sharding import (
    P,
    add_axis_spec,
    axis_dim,
    is_sharded,
)


def _zero_mesh(mesh, wide: tuple[str, ...]):
    """The ``DeviceMesh`` over the zero axes above 1: the session's
    sub-mesh, or (a data-parallel gang, whose only axis above 1 is
    ``data``: the session makes no ``DeviceMesh`` for it) one over the
    whole gang's group."""
    if mesh.device_mesh is not None:
        return mesh.device_mesh[wide]
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh.from_group(dist.group.WORLD, device, mesh_dim_names=wide)


class ZeroLayout:
    """How a ZeRO plan lays out the optimizer state of ``params`` (the
    tensors the optimizer updates, in its order) over ``mesh``: for each,
    the ``DTensor`` placements of its state (None: kept whole, as a leaf
    below ``zero_min_size`` or with no dim the zero degree divides)."""

    def __init__(self, plan, mesh, params: Sequence[torch.Tensor]):
        axes = tuple(plan.zero_axes)
        sharded = [i for i, p in enumerate(params) if is_sharded(p)]
        if sharded:
            raise NotImplementedError(
                f"plan {plan.name!r}: zero_axes beside params its rules shard "
                f"({len(sharded)} of them): ZeRO over sharded params is not "
                f"ported yet: ROADMAP Queue 1 item 5")
        self.degree = mesh.size(axes)
        wide = tuple(a for a in axes if mesh.shape[a] > 1)
        self.device_mesh = _zero_mesh(mesh, wide) if wide else None
        #: the zero axes' process group (None: the whole gang)
        self.group = mesh.group(axes) if wide else None
        self.placements: list[list | None] = []
        for p in params:
            spec = add_axis_spec(P(), tuple(p.shape), mesh, axes, plan.zero_min_size)
            dims = [axis_dim(spec, a) for a in wide]
            if all(d is None for d in dims):
                self.placements.append(None)
                continue
            from torch.distributed.tensor import Replicate, Shard

            self.placements.append([Replicate() if d is None else Shard(d)
                                    for d in dims])

    def _slice(self, whole: torch.Tensor, placements: list) -> torch.Tensor:
        """This rank's slice of ``whole`` (a view), ``shard_of``'s chunking."""
        coord = self.device_mesh.get_coordinate()
        out = whole
        for i, pl in enumerate(placements):
            if pl.is_shard():
                out = out.chunk(self.device_mesh.size(i), pl.dim)[coord[i]]
        return out

    def _wrap(self, local: torch.Tensor, like: torch.Tensor, placements: list):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.device_mesh, placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    def init(self, tx, params: Sequence[torch.Tensor]) -> Any:
        """``tx``'s state over ``params``: each sliced leaf a ``DTensor``
        holding this rank's slice."""
        templates = [p if pl is None else self._wrap(
            self._slice(p.detach(), pl).contiguous(), p, pl)
            for p, pl in zip(params, self.placements)]
        return tx.init(templates)

    def update(self, tx, grads: list[torch.Tensor], opt_state: Any,
               params: list[torch.Tensor]) -> Any:
        """One update of the whole ``params`` in place from the whole,
        already reduced ``grads``, through ``tx`` on this rank's slices;
        ``opt_state`` holds the local slices (``map_leaves(local, ...)``)
        and the new one is returned in that form."""
        from distributeddeeplearningspark_tpu_torch.train.optim import Slices

        g_sl, p_sl, shares = [], [], []
        for g, p, pl in zip(grads, params, self.placements):
            if pl is None:
                g_sl.append(g)
                p_sl.append(p)
                shares.append(0.0)
                continue
            g_sl.append(self._slice(g, pl).contiguous())
            p_sl.append(self._slice(p, pl).clone(memory_format=torch.contiguous_format))
            # the distinct slices over the group's ranks (optim.Shards)
            shares.append(p.numel() / g_sl[-1].numel() / self.degree)
        updates, opt_state = tx.update(Slices(g_sl, shares, self.group, whole=grads),
                                       opt_state, p_sl)
        torch._foreach_add_(p_sl, updates)
        for p, s, pl in zip(params, p_sl, self.placements):
            if pl is not None:
                p.copy_(self._wrap(s, p, pl).full_tensor())
        return opt_state

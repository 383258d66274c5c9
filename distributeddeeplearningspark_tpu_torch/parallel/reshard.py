"""Which part of a sharded tensor each rank holds, and the layout record.

The part of ``distributeddeeplearningspark_tpu/parallel/reshard.py`` that
the live engine (:mod:`.live_reshard`) needs, in ``DTensor`` terms:

- :func:`shard_span` — the global index span (``[lo, hi)`` per dim) a
  rank's local tensor covers under its ``DTensor`` placements: each
  ``Shard(d)`` over a mesh dim of size n gives the rank at coordinate k
  the k-th of n ``torch.chunk`` pieces along d, which is how ``DTensor``
  and FSDP2 split a dim (ceil(n/k)-row chunks, so an uneven dim leaves the
  last ranks fewer rows, or none; FSDP2's padding lives in its flat buffer,
  never in the local shard). ``Replicate`` keeps the whole dim; the JAX
  ``_slices_cover``.
- :func:`assemble_block` — fill one block from the overlapping pieces of
  other blocks, raising :class:`SpanUnavailableError` where a cell is left
  unwritten; the JAX ``_assemble_block``.
- :func:`geometry_of` — the mesh shape and each leaf's spec record (one
  entry a tensor dim: the mesh axis that shards it, or None), what the
  handoff manifest records, in the JAX ``geometry_of``'s format.

The one-shot ``redistribute``, the re-projection of a recorded layout
onto another mesh, ``Trainer.apply_plan`` and per-rank shard files are not
ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from distributeddeeplearningspark_tpu_torch.parallel import collectives

Span = list[tuple[int, int]]


class SpanUnavailableError(RuntimeError):
    """A block needs an index span no available piece covers, or a
    placement this module cannot map to spans (``Partial``, two mesh dims
    on one tensor dim): restore from the shared checkpoint instead."""


def chunk_range(size: int, parts: int, index: int) -> tuple[int, int]:
    """``[lo, hi)`` of piece ``index`` of ``torch.chunk(size, parts)``: pieces
    of ceil(size/parts), the last ones short or empty."""
    step = -(-size // parts) if size else 0
    lo = min(index * step, size)
    return lo, min(lo + step, size)


def shard_span(shape: tuple[int, ...], placements, mesh_sizes: tuple[int, ...],
               coord: tuple[int, ...]) -> Span:
    """The global span a rank at mesh coordinate ``coord`` holds of a tensor
    of ``shape`` laid out by ``placements`` over a mesh of ``mesh_sizes``."""
    span = [(0, int(d)) for d in shape]
    seen: set[int] = set()
    for p, n, k in zip(placements, mesh_sizes, coord):
        if isinstance(p, Replicate):
            continue
        if type(p) is not Shard:
            raise SpanUnavailableError(
                f"placement {p} of a {tuple(shape)} tensor has no span: the "
                f"live engine maps Shard and Replicate only")
        if p.dim in seen:
            raise SpanUnavailableError(
                f"two mesh dims shard dim {p.dim} of a {tuple(shape)} tensor")
        seen.add(p.dim)
        span[p.dim] = chunk_range(int(shape[p.dim]), n, k)
    return span


def overlap(a: Span, b: Span) -> Span | None:
    """The intersection of two spans, None when it is empty."""
    out = [(max(alo, blo), min(ahi, bhi)) for (alo, ahi), (blo, bhi) in zip(a, b)]
    return None if any(lo >= hi for lo, hi in out) else out


def relative(span: Span, within: Span) -> tuple[slice, ...]:
    """``span``'s index into a block that covers ``within``."""
    return tuple(slice(lo - wlo, hi - wlo) for (lo, hi), (wlo, _) in zip(span, within))


def assemble_block(target_span: Span, sources: list[tuple[Span, torch.Tensor]],
                   *, dtype: torch.dtype | None = None,
                   device: torch.device | None = None) -> torch.Tensor:
    """The block covering ``target_span`` filled from ``sources``, each
    ``(span, tensor)`` with the tensor covering its span; raises
    :class:`SpanUnavailableError` if any cell stays unwritten."""
    shape = tuple(hi - lo for lo, hi in target_span)
    first = sources[0][1] if sources else None
    block = torch.empty(shape, dtype=dtype or first.dtype,
                        device=device or first.device)
    covered = torch.zeros(shape, dtype=torch.bool) if block.numel() else None
    for span, data in sources:
        o = overlap(target_span, span)
        if o is None:
            continue
        block[relative(o, target_span)] = data[relative(o, span)]
        if covered is not None:
            covered[relative(o, target_span)] = True
    if covered is not None and not bool(covered.all()):
        missing = int(covered.numel() - covered.sum())
        raise SpanUnavailableError(
            f"target span {target_span} has {missing} element(s) no piece "
            f"covers; restore it from the shared checkpoint instead of "
            f"redistributing live state")
    return block


def spec_record(t: torch.Tensor) -> list:
    """One entry a tensor dim: the mesh axis name sharding it (a list for
    several), or None — the JAX ``spec_to_record`` of its layout."""
    entries: list = [None] * t.dim()
    if not isinstance(t, DTensor):
        return entries
    names = t.device_mesh.mesh_dim_names or tuple(
        f"dim{i}" for i in range(t.device_mesh.ndim))
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            e = entries[p.dim]
            entries[p.dim] = name if e is None else (
                [*e, name] if isinstance(e, list) else [e, name])
    return entries


def geometry_of(leaves: dict[str, Any]) -> dict | None:
    """The recorded-geometry dict of a flat ``{path: leaf}`` state: the
    mesh's axis sizes (the root mesh of the first ``DTensor``'s), its
    device and process counts, and each ``DTensor`` leaf's spec record.
    None when no leaf is a ``DTensor`` (nothing sharded)."""
    specs: dict[str, list] = {}
    mesh_shape: dict[str, int] | None = None
    for path, leaf in leaves.items():
        if not isinstance(leaf, DTensor):
            continue
        specs[path] = spec_record(leaf)
        if mesh_shape is None:
            root = _root_mesh(leaf.device_mesh)
            names = root.mesh_dim_names or tuple(f"dim{i}" for i in range(root.ndim))
            mesh_shape = {str(n): int(s) for n, s in zip(names, root.shape)}
    if mesh_shape is None:
        return None
    return {
        "mesh": mesh_shape,
        "num_devices": int(math.prod(mesh_shape.values())),
        "num_processes": collectives.world_size(),
        "specs": specs,
    }


def _root_mesh(mesh):
    root = getattr(mesh, "_get_root_mesh", None)
    if root is not None:
        return root()
    from torch.distributed.device_mesh import _mesh_resources

    return _mesh_resources.get_root_mesh(mesh)

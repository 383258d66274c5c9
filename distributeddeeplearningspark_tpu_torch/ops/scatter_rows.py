"""In-place row scatter-add: the port of kernel K5.

Replaces the Pallas kernel ``_scatter_add_kernel`` of
``distributeddeeplearningspark_tpu/ops/scatter_rows.py`` with
``csrc/scatter_rows.cu``, a CUDA kernel written for Hopper (its header
states the design and the bound). It computes ``table[idx] += updates``
over the rows of a ``[V, D]`` f32 table, in place, for ids that are unique
among the in-range rows; it is how the row-wise AdaGrad of
:mod:`..train.embed` applies a DLRM embedding update. Here:

- :func:`scatter_add_rows` — the wrapper. Ids ``>= V`` (the sentinels
  that pad ``unique`` to K) and negative ids are dropped, the contract
  ``train/embed.py`` relies on. The JAX package has two functions here:
  the raw kernel for unique in-range ids, and a drop boundary that copies
  the table into ``[V + 1, D]`` to give the sentinels a scratch row. K5
  tests each id and skips a dropped row before it reads its update, so
  one function serves both contracts, and the table is updated in place
  (its ``data_ptr`` does not change) and never copied.
  ``scatter_add_rows_dropping`` is the same function under the JAX drop
  boundary's name.
- :func:`scatter_add_rows_reference` — the plain PyTorch version.

The wrapper launches the kernel for CUDA tensors (f32 table and updates,
int32 or int64 ids, contiguous, on one device) or raises, and takes the
plain version for CPU tensors. It returns ``table``. Its launches are
counted in ``scatter_add_rows.launches``; K = 0 launches nothing. The JAX
module's ``bench_scatter_ab`` is not carried over: ``chip_smoke.py`` times
the kernel against its plain version and ``index_add_`` on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def _check_shapes(table: torch.Tensor, idx: torch.Tensor,
                  updates: torch.Tensor) -> tuple[int, int, int]:
    if table.ndim != 2:
        raise ValueError(f"table must be [V, D], got {tuple(table.shape)}")
    if idx.ndim != 1:
        raise ValueError(f"idx must be [K], got {tuple(idx.shape)}")
    v, d = table.shape
    k = idx.shape[0]
    if tuple(updates.shape) != (k, d):
        raise ValueError(f"updates must be [{k}, {d}], got {tuple(updates.shape)}")
    return v, d, k


def scatter_add_rows_reference(table: torch.Tensor, idx: torch.Tensor,
                               updates: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``table[i] += updates[j]`` for
    every ``i = idx[j]`` in ``[0, V)``, in place; other ids are dropped.
    The kept ids must be unique. Returns ``table``."""
    v, _, _ = _check_shapes(table, idx, updates)
    keep = (idx >= 0) & (idx < v)
    rows = idx[keep]
    table[rows] += updates[keep].to(table.dtype)
    return table


@functools.cache
def _kernel():
    """K5's C entry point."""
    from distributeddeeplearningspark_tpu_torch.ops import _build

    fn = _build.load("scatter_rows").dls_scatter_add_rows_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scatter_add_rows(table: torch.Tensor, idx: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """``table[idx] += updates`` in place: table ``[V, D]``, idx ``[K]``,
    updates ``[K, D]`` (else ``ValueError``). Ids outside ``[0, V)`` add
    nothing; the in-range ids must be unique. K5 on CUDA tensors,
    :func:`scatter_add_rows_reference` on CPU tensors. Returns ``table``."""
    v, d, k = _check_shapes(table, idx, updates)
    devices = {t.device.type for t in (table, idx, updates)}
    if devices == {"cpu"}:
        return scatter_add_rows_reference(table, idx, updates)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cuda or cpu, not {table.device}")
    for name, t in (("table", table), ("updates", updates)):
        if t.dtype != torch.float32:
            raise TypeError(f"scatter_add_rows kernel takes an f32 {name}, "
                            f"got {t.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows kernel takes int32 or int64 ids, "
                        f"got {idx.dtype}")
    for name, t in (("table", table), ("idx", idx), ("updates", updates)):
        if not t.is_contiguous():
            raise ValueError(f"scatter_add_rows kernel takes a contiguous {name}")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    if k == 0:
        return table
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
                 updates.data_ptr(), v, k, d, stream)
    if err:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {err}")
    scatter_add_rows.launches += 1
    return table


scatter_add_rows.launches = 0

#: the JAX drop boundary's name for :func:`scatter_add_rows` (the same function)
scatter_add_rows_dropping = scatter_add_rows

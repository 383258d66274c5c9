"""Device-side segment-reduce aggregation — the combines leave the host.

The port of ``distributeddeeplearningspark_tpu/data/device_agg.py``. Once
the reduce phase's input is a hash-sorted plane with segment boundaries
(:func:`~.exchange.sorted_segments`), the numeric combines — ``count`` /
``sum`` / ``min`` / ``max`` (``mean`` derives from sum/count at read time)
— are one ``scatter_reduce`` each on the card, and the vocabulary build's
top-V filter is one stable descending sort. ``groupBy().agg(
transport="device")`` runs the folds here, and the DLRM feature pipeline's
vocabulary build streams its top-V selection through :class:`TopV`.

Three disciplines, as in the JAX module:

- **Bit-exactness.** The planes keep their dtypes on the card: int64
  counts and sums stay int64 (exact), float64 sums stay float64 and are
  exact under the exchange's proviso (integer-valued values, magnitudes
  below 2^53; the atomics' order is not fixed, so other floats may differ
  in the last bits); min and max are order-free. The final division for
  ``mean`` happens on the host with the formula the tuple path uses. So
  the device fold gives the bytes of the exchange's ``reduceat`` fold
  (:func:`~.exchange.combine_planes`) and of the heap. NaN keys and bool
  keys never reach it: :meth:`~.exchange.ColumnarPlan.pre_planes` refuses
  them as the JAX module's does.
- **A bounded set of shapes.** Every input pads to a pow-2 ladder (data
  length AND segment count), and every fold is wrapped in the signature
  ledger (:func:`~..telemetry.anatomy.instrument`) under the JAX names
  ``device_agg.segment_{op}`` and ``device_agg.top_v``: each size bucket
  is one ledgered signature, and a warm repeat at the same shapes records
  none.
- **The device is explicit, with no fallback.** :func:`available` gives the
  ``device=`` asked for, else the active ``Session``'s device, else
  ``cuda`` (:func:`~..utils.device.resolve_device`, which raises without
  CUDA). Nothing here quietly takes the host fold: only a caller that asks
  for the CPU gets it, as the tests do. (The exchange's own hash-collision
  path, :func:`~.exchange._combine_colliding`, is semantics, not a
  fallback: colliding runs compare full keys on the host.)

Ties in top-V: the JAX filter relies on ``lax.top_k`` returning the lowest
index among equal scores. ``torch.topk`` promises no order among ties, so
:class:`TopV` selects with ``torch.sort(descending=True, stable=True)``,
which keeps equal scores in index order — the same rule.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch.data import exchange

#: pad floor: below this, padding overhead dwarfs the work and the ladder
#: would mint one signature per tiny size.
_MIN_PAD = 1 << 10
#: per-fold distinct-signature allowance: the pow-2 ladder bounds the
#: genuine signature set well under this, so a flagged new signature is a
#: real bug (the same signature recorded twice), never ladder noise.
_EXPECTED_SIGS = 64

_folds: dict[tuple, Any] = {}

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def _pad_len(n: int) -> int:
    return max(_MIN_PAD, 1 << max(0, int(n - 1)).bit_length())


def available(device: str | torch.device | None = None) -> torch.device:
    """The device the folds run on: ``device`` when given, else the active
    ``Session``'s, else ``cuda``, raising where CUDA is absent. It reports
    the device and nothing else: no caller reads it to pick a host path."""
    from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

    if device is not None:
        return resolve_device(device)
    from distributeddeeplearningspark_tpu_torch.session import Session

    sess = Session._active
    if sess is not None and not sess._stopped:
        return sess.device
    return resolve_device("cuda")


def _identity(op: str, dtype: torch.dtype):
    """The fold's identity in ``dtype``: a segment with no row keeps it, as
    in ``jax.ops.segment_*``."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment_fold(op: str, nseg_pad: int, device: torch.device):
    key = ("seg", op, nseg_pad, str(device))
    if key not in _folds:
        from distributeddeeplearningspark_tpu_torch.telemetry.anatomy import instrument

        def fn(data: torch.Tensor, seg_ids: torch.Tensor, _op=_REDUCE[op],
               _n=nseg_pad) -> torch.Tensor:
            out = torch.full((_n,), _identity(op, data.dtype), dtype=data.dtype,
                             device=data.device)
            out.scatter_reduce_(0, seg_ids, data, reduce=_op, include_self=True)
            if _op != "sum" and data.is_floating_point():
                # NaN propagates as in numpy's reduceat fold, whatever
                # the atomics do with it
                nan = torch.zeros((_n,), dtype=torch.int32, device=data.device)
                nan.scatter_add_(0, seg_ids, torch.isnan(data).to(torch.int32))
                out = torch.where(nan > 0, torch.full_like(out, float("nan")), out)
            return out

        _folds[key] = instrument(fn, name=f"device_agg.segment_{op}",
                                 expected_signatures=_EXPECTED_SIGS, device=device)
    return _folds[key]


def segment_reduce(op: str, values: np.ndarray, seg_ids: np.ndarray,
                   nseg: int, *, device: str | torch.device | None = None
                   ) -> np.ndarray:
    """One plane's device fold: ``values`` (sorted so equal segments are
    adjacent) reduce into ``nseg`` outputs, in the dtype numpy's
    ``reduceat`` fold gives (a sum of small integers widens to int64, as
    ``np.add`` does; min and max keep the dtype). Pads both axes to the
    pow-2 ladder (pad rows target a trash segment past ``nseg``) and
    slices the real segments back out."""
    if op not in exchange.NUMERIC_COMBINES:
        raise ValueError(f"op {op!r} not in {exchange.NUMERIC_COMBINES}")
    dev = available(device)
    values = np.asarray(values)
    if op == "sum":
        values = values.astype(np.add.reduce(values[:0]).dtype, copy=False)
    n = len(values)
    n_pad = _pad_len(n)
    nseg_pad = _pad_len(nseg + 1)
    data = np.full(n_pad, _identity(op, torch.from_numpy(values[:0]).dtype),
                   dtype=values.dtype)
    data[:n] = values
    ids = np.full(n_pad, nseg, dtype=np.int64)
    ids[:n] = seg_ids
    out = _segment_fold(op, nseg_pad, dev)(
        torch.from_numpy(data).to(dev, non_blocking=False),
        torch.from_numpy(ids).to(dev, non_blocking=False))
    return out[:nseg].cpu().numpy()


def segment_combine(pl: "exchange._Planes", plan: "exchange.ColumnarPlan", *,
                    device: str | torch.device | None = None) -> "exchange._Planes":
    """The exchange's sort-and-fold, with the folds on the device: stable
    argsort by ``key_hash`` on the host (ordering is control flow, the
    combining is the work), then one :func:`segment_reduce` per value
    plane. Hash collisions (distinct keys, equal digest) take the
    exchange's full-key-compare path; the bytes equal
    :func:`~.exchange.combine_planes`'s either way."""
    dev = available(device)
    n = len(pl)
    if n == 0:
        return pl
    pl, starts, seg_id, collision = exchange.sorted_segments(pl)
    if collision:
        return exchange._combine_colliding(pl, plan)
    if len(starts) == n:
        return pl
    nseg = len(starts)
    out_vals = tuple(
        segment_reduce(op, col, seg_id, nseg, device=dev)
        for col, op in zip(pl.vals, plan.combines))
    return exchange._Planes(pl.h[starts],
                            tuple(a[starts] for a in pl.keys), out_vals)


class TopV:
    """Streaming device top-V filter — the vocabulary build's reduce phase.

    Feed ``update(scores, payloads)`` blocks (token counts + the tokens
    themselves); the running top-``v`` set lives in two small host arrays
    and every selection round is ONE stable descending sort on the device
    over a fixed-shape candidate buffer (kept ∪ block, padded to a constant
    length, so the whole stream is one ledgered signature). Tie-breaking
    matches the host heap it replaces: candidates pre-sort by payload
    descending, and the stable sort keeps equal scores in that order, so
    the larger payload wins — the ``(count, token)`` ordering of
    ``examples/dlrm_features.py``. ``ranked()`` returns
    ``[(score, payload), ...]`` best-first.
    """

    def __init__(self, v: int, block: int = 65536, *,
                 device: str | torch.device | None = None):
        if v < 1:
            raise ValueError(f"v must be >= 1, got {v}")
        self.v = int(v)
        self.block = int(block)
        self.device = available(device)
        self._cap = _pad_len(self.v + self.block)
        self._scores = np.empty(0, dtype=np.int64)
        self._payloads: np.ndarray | None = None  # dtype from first block

    def _select(self):
        key = ("topv", self.v, self._cap, str(self.device))
        if key not in _folds:
            from distributeddeeplearningspark_tpu_torch.telemetry.anatomy import (
                instrument,
            )

            def fn(x: torch.Tensor, _k=self.v) -> torch.Tensor:
                return torch.sort(x, descending=True, stable=True).indices[:_k]

            _folds[key] = instrument(fn, name="device_agg.top_v",
                                     expected_signatures=_EXPECTED_SIGS,
                                     device=self.device)
        return _folds[key]

    def update(self, scores: Sequence[int], payloads: Sequence) -> None:
        scores = np.asarray(scores, dtype=np.int64)
        payloads = np.asarray(payloads)
        if self._payloads is None:
            self._payloads = payloads[:0]
        for off in range(0, len(scores), self.block):
            s = np.concatenate([self._scores, scores[off:off + self.block]])
            p = np.concatenate([self._payloads, payloads[off:off + self.block]])
            order = np.argsort(p, kind="stable")[::-1]  # tie-break: payload desc
            s, p = s[order], p[order]
            n = len(s)
            pad = np.full(self._cap, np.iinfo(np.int64).min, dtype=np.int64)
            pad[:n] = s
            idx = self._select()(torch.from_numpy(pad).to(self.device)).cpu().numpy()
            idx = idx[idx < n][:self.v]
            self._scores, self._payloads = s[idx], p[idx]

    def ranked(self) -> list[tuple[int, Any]]:
        if self._payloads is None or not len(self._scores):
            return []
        order = np.lexsort((self._payloads, self._scores))[::-1]
        return list(zip(self._scores[order].tolist(),
                        self._payloads[order].tolist()))

"""The wide operations' shared helpers — the part of
``distributeddeeplearningspark_tpu/data/exchange.py`` that the serial paths
of :mod:`..rdd`'s ``distinct``, ``reduce_by_key``, ``group_by_key`` and
``sort_by`` need: the canonical key identity (:func:`key_bytes`) and its
bucket (:func:`bucket_of`), so the serial output is partitioned exactly as
the JAX package's is; the serial path's cardinality ceiling
(:func:`max_groups_limit`, ``DLS_AGG_MAX_GROUPS``) and its refusal; the
declared numeric combines; and :func:`resolve_shuffle_workers`.

The distributed exchange itself — the cross-worker hash-partitioned
shuffle with spill-to-disk reduce, its columnar transport, retries and the
``die_shuffle_worker`` fault — is not ported yet (ROADMAP Queue 1 item 4).
A wide operation that would take it (workers resolved above 0, from
``num_workers=`` or ``DLS_DATA_WORKERS``) raises
:class:`ExchangeNotPorted` rather than fall back to the serial path,
which would partition its output differently.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import warnings
from typing import Any

from distributeddeeplearningspark_tpu_torch.data.workers import (
    fork_available,
    resolve_num_workers,
)

#: env knob shared with the JAX package's DataFrame: the serial-path
#: distinct-key / materialization ceiling
MAX_GROUPS_ENV = "DLS_AGG_MAX_GROUPS"
_DEFAULT_MAX_GROUPS = 1_000_000
#: declared numeric combines the exchange's columnar transport vectorizes
NUMERIC_COMBINES = ("sum", "min", "max")

_PICKLE_PROTO = 4


class ExchangeNotPorted(NotImplementedError):
    """A wide operation asked for the distributed shuffle exchange."""


def max_groups_limit(explicit: int | None = None) -> int:
    """The serial-path cardinality ceiling: explicit value, else
    ``DLS_AGG_MAX_GROUPS``, else 1M."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(os.environ.get(MAX_GROUPS_ENV, "") or _DEFAULT_MAX_GROUPS)
    except ValueError:
        return _DEFAULT_MAX_GROUPS


def resolve_shuffle_workers(num_workers: int | None) -> int:
    """Worker count for the exchange: an explicit value wins, ``None`` reads
    ``DLS_DATA_WORKERS`` (the pool the shuffle rides on). 0 — or a platform
    without ``fork`` — means the serial driver-side path."""
    nw = resolve_num_workers(num_workers)
    if nw > 0 and not fork_available():  # pragma: no cover - platform
        warnings.warn("shuffle workers requested but the 'fork' start "
                      "method is unavailable; using the serial path")
        return 0
    return nw


def require_serial(op: str, num_workers: int | None) -> None:
    """Raise :class:`ExchangeNotPorted` when ``op`` would take the exchange
    (workers resolved above 0)."""
    nw = resolve_shuffle_workers(num_workers)
    if nw:
        raise ExchangeNotPorted(
            f"{op} with {nw} shuffle worker(s) (num_workers= or DLS_DATA_WORKERS) "
            f"takes the distributed shuffle exchange (data/exchange.py), which "
            f"the port does not have yet (ROADMAP Queue 1 item 4); the serial "
            f"path would partition the output differently. Pass num_workers=0 "
            f"for the serial path")


def key_bytes(key: Any) -> bytes:
    """Canonical sortable identity of a shuffle key: an 8-byte blake2b
    digest of the pickled key, then the pickle itself (the digest buckets
    and sorts; the tail breaks a collision deterministically). Stable across
    processes and runs, unlike ``hash()``. Keys that compare equal but
    pickle differently (``1`` vs ``np.int64(1)``) are different keys."""
    kb = pickle.dumps(key, protocol=_PICKLE_PROTO)
    return hashlib.blake2b(kb, digest_size=8).digest() + kb


def bucket_of(kb: bytes, n_out: int) -> int:
    """Owning bucket of a key's :func:`key_bytes`."""
    return int.from_bytes(kb[:8], "big") % n_out


def serial_refusal(op: str, limit: int, what: str = "distinct keys") -> str:
    """The serial path's loud failure, with its remediations."""
    return (
        f"{op} exceeded max_groups={limit} {what} on the serial driver-side "
        f"path. The distributed shuffle exchange, which spills to disk "
        f"instead of growing a driver dict, is not ported yet (ROADMAP Queue "
        f"1 item 4): hash_bucket/pre-bucket the key to bound the result, or "
        f"raise {MAX_GROUPS_ENV} if the result genuinely fits the driver.")

"""Cross-worker hash-partitioned shuffle — the wide-transformation engine.

The port's copy of ``distributeddeeplearningspark_tpu/data/exchange.py``
(numpy and the standard library on the host; no torch). Without workers
the wide operations (``reduce_by_key``, ``group_by_key``, ``distinct``,
``sort_by``, ``groupBy().agg``) merge their partials in ONE driver-side
dict, bounded by the ``max_groups`` ceiling. With workers they take this
exchange, a map/reduce over partitions built on the process-pool
machinery of :mod:`.workers`:

- **Map side.** ``M`` forked mapper processes walk the source partitions
  (partition ``p`` → mapper ``p % M``; when ``M > P`` mappers split a
  partition by element-residue classes, the WorkerPool discipline) and
  combine locally into a bounded dict. When the dict outgrows its share of
  ``DLS_SHUFFLE_MEM_MB`` it *flushes*: entries bucket by canonical key hash
  (:func:`key_bytes` — blake2b over the pickled key, NOT Python's
  per-process-seeded ``hash``) and each bucket's payload ships to its
  owning reducer through the mapper's shared-memory arena
  (:class:`~.workers._Arena`, first-fit with out-of-order reclaim),
  falling back to pickled queue transport when the arena is full —
  counted, never stalled.
- **Exchange.** Barrier-free: one queue per reducer, payloads stream as
  flushes happen, reducers merge incrementally while mappers still run.
  A mapper that raises forwards its traceback; one that *dies* (SIGKILL,
  OOM) is caught by the driver's liveness poll — either way the caller gets
  a typed :class:`~.workers.WorkerCrashed` within a bounded wait and every
  child, shm segment, and spill file is torn down.
- **Reduce side.** ``R`` reducer processes own buckets ``b % R == r`` and
  merge arriving partials into per-bucket dicts under their share of the
  memory budget; past it they **spill**: items sorted by :func:`key_bytes`
  stream to a run file, and finalization k-way-merges the sorted runs
  (``heapq.merge``) combining adjacent equal keys. Final output streams
  to one file per bucket; the returned dataset's partitions re-read those
  files, so nothing is ever fully materialized driver-side.

Every child is forked inside :func:`~.workers._forking` (the parent's
objects frozen out of the collector, the fork warnings silenced), respawns
too. A child runs numpy, pickle and the standard library only: it never
touches ``torch.cuda``, so a parent that already holds a CUDA context
(a ``Session`` on the card, :class:`~.device_agg.TopV`) may fork it.

**Determinism.** Output order is canonical: bucket-major, :func:`key_bytes`
order within each bucket — data-derived, so results are byte-identical at
ANY worker count (the serial paths in ``rdd.py``/``data/dataframe.py``
emit the same canonical order), and byte-identical to the JAX package's
exchange on the same input. Value-combine order is NOT fixed across worker
counts (partials merge as they arrive), so reduce functions must be
commutative + associative — Spark's own ``reduceByKey`` contract; results
are bit-identical when the combine is exact (int sums, min/max, counts;
float sums are exact while magnitudes stay within 2^53). ``group_by_key``
value lists ARE exactly ordered: values travel tagged with their
(partition, index) position and sort back to encounter order at emit.

**Telemetry.** The driver wraps the run in ``shuffle-map`` / ``shuffle-
merge`` phase spans and mirrors reducer spills plus a final summary as
``shuffle`` gauge events, with the JAX package's fields — the port's
``status`` (and the JAX package's ``dlstatus``) render them as the shuffle
block (bytes moved, spill count, per-bucket skew, slowest-bucket verdict,
per-format byte/key split).

**Columnar transport.** Per-key pickled tuples cap the agg path at tens
of thousands of keys/s/worker. When an operation declares a
:class:`ColumnarPlan` (``groupBy().agg`` with numeric keys;
``reduce_by_key``/``distinct`` over plain int/float scalars with a
declared numeric combine), conforming batches travel as **flat planes**
instead: a ``key_hash`` uint64 array (the first 8 bytes of
:func:`key_bytes`, so bucketing and ordering stay IDENTICAL to the tuple
path), the key columns, and one value array per combine — whole arrays
pickled once and shipped through the same shm arenas, metered by their
exact ``nbytes``. Map side, flushes sort by hash and segment-combine with
``np.argsort``/``ufunc.reduceat`` (no per-key Python); reduce side,
bucket planes merge by sorted hash, spill runs are columnar block files
k-way merged on the hash column, and hash collisions (2⁻⁶⁴, but tested)
resolve by full-key compare against the pickled key bytes. Batches that
do NOT conform (object keys, mixed value types) fall back to the tuple
path per batch, and a bucket that receives both formats degrades to
tuple merging — output is byte-identical to an all-tuple run either
way; ``DLS_SHUFFLE_TRANSPORT=tuple`` exists only to measure the
difference. ``groupBy().agg(transport="device")`` instead folds the
numeric combines on the card (:mod:`.device_agg`, ``scatter_reduce``
over the same sorted planes).

**Task-level fault tolerance.** The exchange survives task failure
instead of reporting it — the Spark lineage-retry model, safe here
because mapper tasks are pure callables over partition slices:

- **Tasks, not assignments.** The ``(part, slot, k)`` slices go through a
  shared task queue that mappers *pull* from, so a dead worker's
  unfinished slices flow to a respawned or surviving mapper with no
  rebalancing code. Every shipped payload frame carries a deterministic
  identity ``(part, slot, seq)`` — per-slice state resets at slice entry,
  so a replayed slice ships *byte-identical* frames at the same ids no
  matter which worker runs it. Reducers deduplicate on that identity,
  which is what makes retry AND speculative execution safe: first finish
  wins, duplicates drop, output stays byte-identical to a fault-free run.
- **Retention IS the transport (retain mode).** With retries enabled
  (``DLS_SHUFFLE_MAX_RETRIES`` > 0, default 3) every frame is written
  to the spill dir as an atomically-renamed ``ret-*`` file named by its
  identity, and reducers SWEEP the directory for unseen frames: no shared
  data queue exists, so a SIGKILLed producer cannot tear a frame
  mid-pipe-write or die holding a queue lock the survivors then block on.
  Control traffic rides per-attempt driver-owned queues whose messages
  stay under the pipe's 4KB atomic-write bound. A dead reducer's
  replacement rebuilds its buckets purely from retained files; retained
  files are deleted when the exchange completes.
  ``DLS_SHUFFLE_MAX_RETRIES=0`` keeps the shm-arena/queue transport with
  zero retention and zero recovery — fail-fast.
- **Legacy mode never recovers, so arenas are attempt-0-only.** With
  the budget at 0 the first failure escalates before any respawn could
  happen; every child that exists forked at exchange start.
- **Reducer termination by count.** Each ``slice-done`` reports
  per-reducer unique-frame counts (deterministic across replays), the
  driver sends each reducer an ``eof`` total once all slices are done,
  and a reducer finalizes when its unique-frame set reaches that total —
  late, lost, or duplicated frames all converge.
- **Policy.** A retry budget (``DLS_SHUFFLE_MAX_RETRIES``) bounds total
  recovery actions, escalating to the typed
  :class:`~.workers.WorkerCrashed` when exhausted; per-worker failure
  scoring blacklists a worker slot after ``DLS_SHUFFLE_BLACKLIST_AFTER``
  strikes (a blacklisted mapper's work redistributes; a blacklisted
  reducer escalates — its buckets are pinned); and speculative execution
  re-enqueues a slice whose runtime lags ``DLS_SHUFFLE_SPECULATE_FACTOR``
  × the median completed-slice duration (first finish wins via dedup).
  Every retry / speculation / blacklist decision is a ``shuffle``
  telemetry event, and ``DLS_FAULT=die_shuffle_worker@N``
  (:func:`~..faults.shuffle_fault`) kills a mapper at its Nth element / a
  reducer at its Nth merged frame for deterministic drills.
"""

from __future__ import annotations

import hashlib
import heapq
import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
import uuid
import warnings
import weakref
from multiprocessing import shared_memory
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from distributeddeeplearningspark_tpu_torch import faults, telemetry
from distributeddeeplearningspark_tpu_torch.data.workers import (
    _POLL_S,
    WorkerCrashed,
    _align,
    _Arena,
    _forking,
    env_num,
    fork_available,
    resolve_num_workers,
)

#: env knob: total shuffle memory budget (MB) split over mapper arenas,
#: mapper combine dicts, and reducer merge dicts. Past their share, mappers
#: flush early and reducers spill to disk — the budget bounds resident
#: bytes, it never refuses a workload.
MEM_MB_ENV = "DLS_SHUFFLE_MEM_MB"
_DEFAULT_MEM_MB = 256
#: env knob: where spill runs and bucket output files live (default: a
#: fresh tempdir per shuffle, removed when the result is garbage-collected
#: or the exchange fails).
SPILL_DIR_ENV = "DLS_SHUFFLE_SPILL_DIR"
#: env knob shared with data/dataframe.py: the serial-path distinct-key /
#: materialization ceiling (the exchange path has no ceiling — that is the
#: point of it).
MAX_GROUPS_ENV = "DLS_AGG_MAX_GROUPS"
_DEFAULT_MAX_GROUPS = 1_000_000
#: env knob: transport override for eligible wide ops — ``auto`` (default:
#: columnar where batches conform, tuple elsewhere), ``columnar`` (alias of
#: auto — non-conforming batches still fall back, byte-identically),
#: ``tuple`` (force the per-key pickled path; the measurement baseline), or
#: ``device`` (groupBy.agg only: serial scan + jitted segment-reduce
#: combines, data/device_agg.py).
TRANSPORT_ENV = "DLS_SHUFFLE_TRANSPORT"
TRANSPORTS = ("auto", "tuple", "columnar", "device")
#: env knob: total recovery actions (mapper/reducer respawns, slice
#: re-executions after a raise) one exchange may spend before escalating
#: to the typed :class:`~.workers.WorkerCrashed`. 0 = today's fail-fast
#: behavior exactly (and disables frame retention — the perf baseline).
MAX_RETRIES_ENV = "DLS_SHUFFLE_MAX_RETRIES"
_DEFAULT_MAX_RETRIES = 3
#: env knob: failure strikes before a worker slot is blacklisted.
BLACKLIST_ENV = "DLS_SHUFFLE_BLACKLIST_AFTER"
_DEFAULT_BLACKLIST_AFTER = 2
#: env knob: speculative-execution lag factor — a running slice whose
#: elapsed time exceeds factor × median completed-slice duration (and
#: the 1s floor) is cloned to the task queue; first finish wins, frame
#: dedup makes the clone safe. <= 0 disables speculation.
SPECULATE_ENV = "DLS_SHUFFLE_SPECULATE_FACTOR"
_DEFAULT_SPECULATE_FACTOR = 4.0
#: speculation never triggers below this elapsed time — tiny test slices
#: must not clone themselves just because the median is microseconds.
_SPECULATE_FLOOR_S = 1.0
#: last-resort driver stall window: with no control-queue progress for
#: this long, undone slices with no registered runner are re-enqueued.
#: Custody loss (a task popped by a worker that died before its
#: slice-start landed) is normally repaired by the failure handler
#: itself; this net only exists so an unforeseen loss degrades into one
#: duplicate round per minute instead of a hang. Duplicates are harmless
#: by dedup.
_RESEED_S = 60.0
#: declared numeric combines a ColumnarPlan can vectorize. "count" is a
#: sum of int64 count planes, "mean" derives from (sum, count) at read
#: time — both reduce to these three.
NUMERIC_COMBINES = ("sum", "min", "max")

_PICKLE_PROTO = 4
#: per-reducer metadata queue bound: flush payloads in flight beyond the
#: arenas (backpressure's item-count half, as in workers.py).
_QUEUE_AHEAD = 16
#: how long a mapper waits for arena space before the pickle fallback.
_ALLOC_WAIT_S = 0.25
_MIN_ARENA = 1 << 20
_MIN_CAP = 1 << 18
#: rdd-pair columnar mode: pairs buffered before a vectorization attempt
#: (conformance is judged per batch — one odd batch degrades itself, not
#: the whole shuffle).
_PAIR_BATCH = 8192
#: row cap per pickled plane block in columnar spill runs / output files —
#: the unit the k-way merge streams, so merge residency is O(streams ×
#: block), never O(run).
_COLS_BLOCK_ROWS = 131_072


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
    """Worker count for the exchange: explicit value wins, ``None`` reads
    ``DLS_DATA_WORKERS`` (the pool the shuffle rides on). 0 — or a platform
    without ``fork`` — means the serial driver-side path."""
    nw = resolve_num_workers(num_workers)
    if nw > 0 and not fork_available():  # pragma: no cover - platform
        warnings.warn("shuffle workers requested but the 'fork' start "
                      "method is unavailable; using the serial path")
        return 0
    return nw


def resolve_transport(explicit: str | None = None, *,
                      allow_device: bool = False) -> str:
    """Shuffle transport: explicit value wins, else ``DLS_SHUFFLE_TRANSPORT``,
    else ``auto``. ``device`` is only meaningful where the caller supports
    it (groupBy.agg); elsewhere it resolves to ``auto`` — the env knob must
    never break an ineligible op."""
    t = explicit or os.environ.get(TRANSPORT_ENV, "") or "auto"
    t = t.strip().lower()
    if t not in TRANSPORTS:
        raise ValueError(
            f"unknown shuffle transport {t!r}; choose one of {TRANSPORTS}")
    if t == "device" and not allow_device:
        if explicit:
            raise ValueError(
                "transport='device' is only supported by groupBy().agg "
                "numeric combines (data/device_agg.py); use 'auto', "
                "'columnar', or 'tuple' here")
        return "auto"
    return t


def mem_budget_bytes(explicit_mb: float | None = None) -> int:
    if explicit_mb is None:
        try:
            explicit_mb = float(
                os.environ.get(MEM_MB_ENV, "") or _DEFAULT_MEM_MB)
        except ValueError:
            explicit_mb = _DEFAULT_MEM_MB
    return max(4 << 20, int(explicit_mb * (1 << 20)))


def max_shuffle_retries(explicit: int | None = None) -> int:
    """The exchange's recovery budget: explicit value, else
    ``DLS_SHUFFLE_MAX_RETRIES``, else 3. 0 restores fail-fast."""
    if explicit is not None:
        return max(0, int(explicit))
    return env_num(MAX_RETRIES_ENV, _DEFAULT_MAX_RETRIES, lo=0)


def blacklist_after() -> int:
    """Failure strikes before a worker slot is blacklisted (min 1)."""
    return env_num(BLACKLIST_ENV, _DEFAULT_BLACKLIST_AFTER, lo=1)


def speculate_factor() -> float:
    """Speculation lag factor (``DLS_SHUFFLE_SPECULATE_FACTOR``, default
    4.0); <= 0 disables speculative execution."""
    return env_num(SPECULATE_ENV, _DEFAULT_SPECULATE_FACTOR, cast=float)


def key_bytes(key: Any) -> bytes:
    """Canonical sortable identity of a shuffle key: an 8-byte blake2b
    digest of the pickled key, followed by the pickle itself (the digest
    buckets and sorts; the tail breaks the astronomically-rare collision
    deterministically). Stable across processes and runs — unlike
    ``hash()``, which moves with ``PYTHONHASHSEED``. Keys that compare
    equal but pickle differently (``1`` vs ``np.int64(1)``) are DIFFERENT
    shuffle keys; keep key types canonical (the DataFrame plane already
    does)."""
    kb = pickle.dumps(key, protocol=_PICKLE_PROTO)
    return hashlib.blake2b(kb, digest_size=8).digest() + kb


def bucket_of(kb: bytes, n_out: int) -> int:
    """Owning bucket of a key's :func:`key_bytes` — shared with the serial
    fallbacks so both paths land every key in the same output partition."""
    return int.from_bytes(kb[:8], "big") % n_out


def _approx_nbytes(v: Any) -> int:
    """Cheap upper-ish estimate of an object's resident bytes for the
    flush/spill accounting. Precision is not the point — a stable,
    monotone estimate is (over-estimating just flushes earlier). The hot
    loops call this SAMPLED (every 64th item, :class:`_ByteMeter`): at 10M
    pairs, two recursive walks per pair were the map phase's single
    largest cost."""
    if isinstance(v, np.ndarray):
        return v.nbytes + 128
    if isinstance(v, (bytes, str)):
        return len(v) + 64
    if isinstance(v, (list, tuple)):
        return 64 + 16 * len(v) + sum(
            _approx_nbytes(x) for x in v[:8]) * max(1, len(v) // 8 if len(v) > 8 else 1)
    if isinstance(v, dict):
        return 64 + sum(_approx_nbytes(x) + 32 for x in v.values())
    return 64


class _ByteMeter:
    """Sampled byte accounting for the mapper/reducer stores: every 64th
    ``add`` re-measures the item with :func:`_approx_nbytes` and the
    in-between items are charged the rolling estimate. ``value`` tracks
    the store's resident bytes well enough to bound memory (the budget's
    contract), at 1/64th the walk cost.

    Columnar planes do NOT go through the sampler: a shipped plane is one
    array whose size is already known exactly, and charging it the rolling
    per-tuple estimate would book a 16MB plane as ~200 bytes — the sampled
    heuristic exists to dodge recursive size walks, not to excuse
    under-throttling against ``DLS_SHUFFLE_MEM_MB``. The mapper charges
    planes through :meth:`add_exact` on a dedicated meter; the reducer
    keeps the same exact-``nbytes`` accounting as per-bucket tallies
    (spilling a bucket must subtract exactly its planes, which one
    aggregate counter cannot express)."""

    __slots__ = ("value", "_est", "_n")

    def __init__(self):
        self.value = 0.0
        self._est = 192.0
        self._n = 0

    def add(self, item: Any, overhead: int = 0) -> None:
        self._n += 1
        if self._n & 0x3F == 1:
            self._est = float(_approx_nbytes(item))
        self.value += self._est + overhead

    def add_exact(self, nbytes: int) -> None:
        """Charge a known size verbatim — no sampling, no estimate drift
        (whole shipped planes: one array, exact ``nbytes``)."""
        self.value += float(nbytes)

    def reset(self) -> None:
        self.value = 0.0


# ---------------------------------------------------------------------------
# operation specs
# ---------------------------------------------------------------------------


class _Spec:
    """How one wide operation maps onto the exchange.

    ``pre(elem)``: iterable of (key, value) pairs for one source element
    (None = the element already is the pair). ``seed(v)``: first value →
    accumulator. ``combine(acc, v)``: fold one more value in (map side).
    ``merge(a, b)``: fold two accumulators (reduce side). ``final(key,
    acc)``: the emitted record. ``tag_values``: wrap each value as
    ``(part, idx, v)`` before seeding so ``final`` can restore encounter
    order (group_by_key).
    """

    __slots__ = ("pre", "seed", "combine", "merge", "final", "tag_values")

    def __init__(self, *, pre=None, seed=None, combine=None, merge=None,
                 final=None, tag_values=False):
        self.pre = pre
        self.seed = seed if seed is not None else (lambda v: v)
        self.combine = combine
        self.merge = merge if merge is not None else combine
        self.final = final if final is not None else (lambda k, a: (k, a))
        self.tag_values = tag_values


def _reduce_spec(f: Callable[[Any, Any], Any]) -> _Spec:
    return _Spec(combine=f)


def _group_spec() -> _Spec:
    def final(k, acc):
        acc.sort(key=lambda t: (t[0], t[1]))
        return (k, [v for _, _, v in acc])

    return _Spec(seed=lambda tv: [tv],
                 combine=lambda acc, tv: (acc.append(tv) or acc),
                 merge=lambda a, b: (a.extend(b) or a),
                 final=final, tag_values=True)


def _distinct_spec() -> _Spec:
    return _Spec(pre=lambda x: ((x, None),),
                 combine=lambda acc, v: acc,
                 final=lambda k, a: k)


# ---------------------------------------------------------------------------
# columnar transport
# ---------------------------------------------------------------------------


def canon_key_dtype(dt: np.dtype) -> np.dtype | None:
    """The dtype a key column lands in after the tuple path's
    ``.tolist()`` → ``np.asarray(python scalars)`` round trip — int kinds
    widen to int64, floats to float64, bool stays bool. ``None`` = not a
    fixed-width columnar-eligible key dtype (objects, strings, uint64
    whose values could exceed int64). BOTH paths must emit THESE dtypes
    or bit-identity dies on a dtype byte."""
    dt = np.dtype(dt)
    if dt.kind == "i" or (dt.kind == "u" and dt.itemsize < 8):
        return np.dtype(np.int64)
    if dt.kind == "f":
        return np.dtype(np.float64)
    if dt.kind == "b":
        return np.dtype(np.bool_)
    return None


def hash_rows(keys: Sequence[Any]) -> np.ndarray:
    """``key_hash`` plane for a batch of PYTHON keys: the uint64 big-endian
    read of each key's :func:`key_bytes` 8-byte digest prefix — so
    ``hash % n_out`` IS :func:`bucket_of` and ascending-hash order IS
    ascending ``key_bytes`` order (collisions excepted; those resolve by
    the full pickled bytes, rare path below). Routed through
    :func:`key_bytes` on purpose: one source of truth, and tests can
    force collisions by patching it."""
    return np.fromiter(
        (int.from_bytes(key_bytes(k)[:8], "big") for k in keys),
        dtype=np.uint64, count=len(keys))


class _Planes:
    """One columnar batch: aligned flat arrays — ``h`` (uint64 key hash),
    ``keys`` (one array per key column, canonical dtypes), ``vals`` (one
    array per combine plane). The unit that ships whole through the shm
    arenas and is metered by its exact ``nbytes``."""

    __slots__ = ("h", "keys", "vals")

    def __init__(self, h: np.ndarray, keys: tuple, vals: tuple):
        self.h = h
        self.keys = tuple(keys)
        self.vals = tuple(vals)

    def __len__(self) -> int:
        return len(self.h)

    @property
    def nbytes(self) -> int:
        return (self.h.nbytes + sum(a.nbytes for a in self.keys)
                + sum(a.nbytes for a in self.vals))

    def take(self, idx) -> "_Planes":
        return _Planes(self.h[idx], tuple(a[idx] for a in self.keys),
                       tuple(a[idx] for a in self.vals))

    def cut(self, lo: int, hi: int) -> "_Planes":
        return self.take(slice(lo, hi))

    def dtype_sig(self) -> tuple:
        return (tuple(a.dtype.str for a in self.keys),
                tuple(a.dtype.str for a in self.vals))

    def payload(self) -> tuple:
        """The picklable wire/disk form (a plain tuple, no class on the
        wire — a reducer from a future version must still read it)."""
        return ("cols", self.h, self.keys, self.vals)

    @staticmethod
    def from_payload(rec: tuple) -> "_Planes":
        return _Planes(rec[1], rec[2], rec[3])

    @staticmethod
    def concat(planes: "Sequence[_Planes]") -> "_Planes":
        if len(planes) == 1:
            return planes[0]
        return _Planes(
            np.concatenate([p.h for p in planes]),
            tuple(np.concatenate([p.keys[i] for p in planes])
                  for i in range(len(planes[0].keys))),
            tuple(np.concatenate([p.vals[i] for p in planes])
                  for i in range(len(planes[0].vals))))


class ColumnarPlan:
    """How one wide op's batches become planes (and back).

    ``combines`` names the vectorized fold per value plane (``sum`` /
    ``min`` / ``max``). ``pre_planes(elem)`` turns a source element into a
    :class:`_Planes` batch (unique keys within the batch, hashes filled) or
    ``None`` when the element does not conform — that element then walks
    the tuple path via ``spec.pre``, byte-identically. When ``pre_planes``
    is absent the mapper batches raw ``(key, value)`` pairs and calls
    ``pair_planes`` per batch (the rdd ops). The tuple-interop trio —
    ``key_of_row`` / ``vals_to_acc`` / ``row_emit`` — lets a mixed-format
    bucket degrade to tuple merging and lets generic consumers iterate
    rows off a columnar output file."""

    __slots__ = ("combines", "pre_planes", "pair_planes", "key_of_row",
                 "vals_to_acc", "row_emit")

    def __init__(self, *, combines: Sequence[str], pre_planes=None,
                 pair_planes=None, key_of_row=None, vals_to_acc=None,
                 row_emit=None):
        for c in combines:
            if c not in NUMERIC_COMBINES:
                raise ValueError(
                    f"combine {c!r} not in {NUMERIC_COMBINES}")
        self.combines = tuple(combines)
        self.pre_planes = pre_planes
        self.pair_planes = pair_planes
        self.key_of_row = (key_of_row if key_of_row is not None
                           else (lambda kv: kv[0]))
        self.vals_to_acc = (vals_to_acc if vals_to_acc is not None
                            else (lambda vs: vs[0] if vs else None))
        self.row_emit = (row_emit if row_emit is not None
                         else (lambda k, vs: (k, vs[0])))

    # -- tuple interop ------------------------------------------------------

    def entries_from_planes(self, pl: _Planes) -> list:
        """Planes → the tuple path's ``(kb, key, acc)`` entries (the
        degrade direction for a mixed-format bucket; also feeds columnar
        spill runs into a tuple-mode heapq merge). Entries come out in the
        planes' (hash, kb) order, which IS kb order."""
        key_lists = [a.tolist() for a in self.keys_as_python(pl)]
        val_lists = [a.tolist() for a in pl.vals]
        out = []
        for i in range(len(pl)):
            key = self.key_of_row(tuple(col[i] for col in key_lists))
            out.append((key_bytes(key), key,
                        self.vals_to_acc(tuple(v[i] for v in val_lists))))
        return out

    def keys_as_python(self, pl: _Planes) -> tuple:
        return pl.keys

    def rows_from_planes(self, pl: _Planes) -> Iterator:
        """Output rows off a columnar bucket file, matching what
        ``spec.final`` emits on the tuple path (python scalars — a
        consumer comparing ``5 == np.int64(5)`` is fine, one pickling the
        row is not)."""
        key_lists = [a.tolist() for a in pl.keys]
        val_lists = [a.tolist() for a in pl.vals]
        for i in range(len(pl)):
            yield self.row_emit(
                self.key_of_row(tuple(col[i] for col in key_lists)),
                tuple(v[i] for v in val_lists))


def _cmp_view(a: np.ndarray) -> np.ndarray:
    """Bitwise-comparable view of a key column (float NaN != NaN would
    false-positive the collision check; the tuple path compares pickled
    bytes, i.e. bit patterns)."""
    if a.dtype.kind == "f":
        return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)
    return a


def sorted_segments(pl: _Planes, *, assume_sorted: bool = False
                    ) -> tuple[_Planes, np.ndarray, np.ndarray, bool]:
    """The shared segment prologue for EVERY plane fold (host
    ``combine_planes`` and the device :mod:`~.device_agg` path — one
    source of truth, because the collision check is the bit-identity-
    critical step): stable-sort by ``key_hash`` and return
    ``(sorted planes, segment starts, per-row segment id, collision)``.
    ``collision=True`` means an equal-hash run holds DIFFERENT keys (a
    digest collision) — the caller must fold through
    :func:`_combine_colliding`, which orders by the full pickled key
    bytes, the tuple path's exact tie-break."""
    n = len(pl)
    if not assume_sorted:
        order = np.argsort(pl.h, kind="stable")
        pl = pl.take(order)
    changed = np.empty(n, dtype=bool)
    changed[0] = True
    np.not_equal(pl.h[1:], pl.h[:-1], out=changed[1:])
    starts = np.flatnonzero(changed)
    seg_id = np.cumsum(changed) - 1
    collision = False
    if len(starts) < n:
        # same hash, same key? (the overwhelmingly common duplicate case)
        for col in pl.keys:
            cv = _cmp_view(col)
            if not np.array_equal(cv, cv[starts][seg_id]):
                collision = True
                break
    return pl, starts, seg_id, collision


def combine_planes(pl: _Planes, plan: ColumnarPlan,
                   *, assume_sorted: bool = False) -> _Planes:
    """Sort a batch by ``key_hash`` (stable) and fold equal-key runs with
    the plan's vectorized combines (``np.add.reduceat`` /
    ``np.minimum.reduceat`` / ``np.maximum.reduceat`` — C loops, no
    per-key Python). Equal-hash runs holding DIFFERENT keys (a digest
    collision) drop to :func:`_combine_colliding`, which orders and folds
    by the full pickled key bytes — the tuple path's exact tie-break."""
    n = len(pl)
    if n == 0:
        return pl
    pl, starts, _seg_id, collision = sorted_segments(
        pl, assume_sorted=assume_sorted)
    if collision:
        return _combine_colliding(pl, plan)
    out_vals = []
    for col, op in zip(pl.vals, plan.combines):
        if len(starts) == n:
            out_vals.append(col)
        elif op == "sum":
            out_vals.append(np.add.reduceat(col, starts))
        elif op == "min":
            out_vals.append(np.minimum.reduceat(col, starts))
        else:
            out_vals.append(np.maximum.reduceat(col, starts))
    if len(starts) == n:
        return pl
    return _Planes(pl.h[starts], tuple(a[starts] for a in pl.keys),
                   tuple(out_vals))


def _combine_colliding(pl: _Planes, plan: ColumnarPlan) -> _Planes:
    """The 2⁻⁶⁴ path: at least one hash run holds distinct keys. Fold the
    whole batch per full key in Python, ordered by complete
    :func:`key_bytes` (digest + pickled key — the tuple path's total
    order), and rebuild planes. Correctness over speed: production never
    lands here; the collision tests force it."""
    key_lists = [a.tolist() for a in pl.keys]
    val_lists = [a.tolist() for a in pl.vals]
    acc: dict[bytes, list] = {}
    for i in range(len(pl)):
        key_row = tuple(col[i] for col in key_lists)
        kb = key_bytes(plan.key_of_row(key_row))
        vals = [v[i] for v in val_lists]
        ent = acc.get(kb)
        if ent is None:
            acc[kb] = [key_row, vals]
        else:
            held = ent[1]
            for j, op in enumerate(plan.combines):
                if op == "sum":
                    held[j] = held[j] + vals[j]
                elif op == "min":
                    held[j] = min(held[j], vals[j])
                else:
                    held[j] = max(held[j], vals[j])
    ordered = sorted(acc.items(), key=lambda t: t[0])
    h = np.fromiter((int.from_bytes(kb[:8], "big") for kb, _ in ordered),
                    dtype=np.uint64, count=len(ordered))
    keys = tuple(
        np.asarray([ent[0][c] for _, ent in ordered], dtype=pl.keys[c].dtype)
        for c in range(len(pl.keys)))
    vals = tuple(
        np.asarray([ent[1][j] for _, ent in ordered], dtype=pl.vals[j].dtype)
        for j in range(len(pl.vals)))
    return _Planes(h, keys, vals)


def _bucket_split(pl: _Planes, n_out: int) -> Iterator[tuple[int, _Planes]]:
    """Hash-sorted planes → (bucket, sub-planes) runs, bucket-major with
    hash order preserved inside each bucket (stable argsort over
    ``h % n_out`` of already-hash-sorted rows = the canonical layout)."""
    if len(pl) == 0:
        return
    bucket = (pl.h % np.uint64(n_out)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    pl = pl.take(order)
    bucket = bucket[order]
    edges = np.flatnonzero(np.r_[True, bucket[1:] != bucket[:-1]])
    bounds = list(edges) + [len(pl)]
    for i, lo in enumerate(bounds[:-1]):
        yield int(bucket[lo]), pl.cut(lo, bounds[i + 1])


def _merge_cols_streams(streams: list, plan: ColumnarPlan
                        ) -> Iterator[_Planes]:
    """K-way merge of hash-sorted plane streams (spill-run block iterators
    plus the in-memory remainder), yielding combined blocks in hash order.
    Classic min-of-buffered-maxes frontier: rows strictly below the
    smallest buffered maximum of any live stream are complete and emit;
    rows at the frontier wait for the stream that set it to buffer
    another block. Residency is O(streams × block), never O(run)."""
    bufs: list[_Planes | None] = [None] * len(streams)
    alive = [True] * len(streams)

    def fill(i: int) -> None:
        while alive[i] and (bufs[i] is None or len(bufs[i]) == 0):
            try:
                blk = next(streams[i])
            except StopIteration:
                alive[i] = False
                return
            bufs[i] = (blk if bufs[i] is None or len(bufs[i]) == 0
                       else _Planes.concat([bufs[i], blk]))

    for i in range(len(streams)):
        fill(i)
    while True:
        live = [i for i in range(len(streams)) if alive[i]]
        if not live:
            rest = [b for b in bufs if b is not None and len(b)]
            if rest:
                yield combine_planes(_Planes.concat(rest), plan)
            return
        thresh = min(bufs[i].h[-1] for i in live)
        parts = []
        for i, b in enumerate(bufs):
            if b is None or len(b) == 0:
                continue
            cut = int(np.searchsorted(b.h, thresh, side="left"))
            if cut:
                parts.append(b.cut(0, cut))
                bufs[i] = b.cut(cut, len(b))
        if parts:
            yield combine_planes(_Planes.concat(parts), plan)
        # advance every live stream sitting AT the frontier — next loop's
        # threshold must strictly grow or a stream must die
        for i in live:
            if len(bufs[i]) == 0 or bufs[i].h[-1] == thresh:
                blk = None
                try:
                    blk = next(streams[i])
                except StopIteration:
                    alive[i] = False
                if blk is not None:
                    bufs[i] = (_Planes.concat([bufs[i], blk])
                               if len(bufs[i]) else blk)


# -- rdd-side plan factories (the dataframe builds its own in agg) ----------


def _scalar_batch(keys: list, vals: list | None, combines) -> _Planes | None:
    """Vectorize one rdd pair batch, or ``None`` when it does not conform:
    every key must be a plain python ``int``, ``float``, or ``bool`` and
    every value a plain ``int`` or ``float``, type-uniform per batch —
    exact types, because the tuple path pickles the ORIGINAL objects and
    ``np.int64(5)`` pickles differently from ``5`` (and ``True`` min/max
    results must come back as ``True``, so bool VALUES stay tuple-path).
    Two more exactness guards: under ``combine="sum"`` int values must fit
    int32, so even 2³² occurrences of one key cannot wrap the int64
    accumulator the planes sum in (the tuple path's python ints are
    arbitrary-precision — a wrapped plane would be a silently wrong
    answer, not a slow one); and float keys containing ANY zero fall
    back, because ``-0.0 == 0.0`` merges in a tuple-path dict but pickles
    to different key bytes (the documented equal-but-pickles-differently
    caveat — keeping every ±0.0 on one path keeps both transports on the
    same side of it)."""
    def uniform(xs, allowed) -> type | None:
        t = type(xs[0])
        if t not in allowed:
            return None
        for x in xs:
            if type(x) is not t:
                return None
        return t

    kt = uniform(keys, (int, float, bool))
    if kt is None:
        return None
    if kt is int and any(abs(k) > 0x7FFF_FFFF_FFFF_FFFF for k in keys):
        return None  # arbitrary-precision python ints stay tuple-path
    if kt is float and any(k == 0.0 for k in keys):
        # ±0.0 are dict-equal but pickle-different; only the tuple path
        # carries the dict-merge semantics, so EVERY zero goes there —
        # a columnar +0.0 could never merge with a tuple-path -0.0
        return None
    val_planes: tuple = ()
    if combines:
        vt = uniform(vals, (int, float))
        if vt is None:
            return None
        v_bound = (0x7FFF_FFFF if combines[0] == "sum"
                   else 0x7FFF_FFFF_FFFF_FFFF)
        if vt is int and any(abs(v) > v_bound for v in vals):
            return None
        val_planes = (np.asarray(vals, dtype=np.dtype(
            np.int64 if vt is int else np.float64)),)
    key_col = np.asarray(keys, dtype=np.dtype(
        {int: np.int64, float: np.float64, bool: np.bool_}[kt]))
    return _Planes(hash_rows(keys), (key_col,), val_planes)


def reduce_pair_plan(combine: str) -> ColumnarPlan:
    """Plan for ``reduce_by_key(f, combine=...)``: scalar numeric key, one
    value plane folded with the DECLARED combine — the declaration is a
    contract exactly like commutativity is (an ``f`` that disagrees with
    it diverges between paths, and that is the caller's bug)."""
    return ColumnarPlan(
        combines=(combine,),
        pair_planes=lambda ks, vs: _scalar_batch(ks, vs, (combine,)),
        key_of_row=lambda kr: kr[0],
        vals_to_acc=lambda vs: vs[0],
        row_emit=lambda k, vs: (k, vs[0]))


def distinct_pair_plan() -> ColumnarPlan:
    """Plan for ``distinct()`` over numeric scalars: key planes only, the
    segment fold is pure dedup (first row of each hash run)."""
    return ColumnarPlan(
        combines=(),
        pair_planes=lambda ks, vs: _scalar_batch(ks, None, ()),
        key_of_row=lambda kr: kr[0],
        vals_to_acc=lambda vs: None,
        row_emit=lambda k, vs: k)


# ---------------------------------------------------------------------------
# mapper / reducer process bodies (fork-inherited closures, numpy only)
# ---------------------------------------------------------------------------


def _drain_frees(ring: _Arena, free_q) -> None:
    try:
        while True:
            ring.free(free_q.get_nowait())
    except queue_lib.Empty:
        pass


def _clip_tb(tb: str, limit: int = 2000) -> str:
    """Bound a forwarded traceback so the whole control message stays
    under the pipe's 4KB atomic-write size: a producer SIGKILLed mid-write
    must never leave a torn frame in a stream someone still reads. The
    TAIL survives — that is where the raising line lives."""
    return tb if len(tb) <= limit else "…" + tb[-limit:]


def _mapper_loop(wid: int, epoch: int, parts, spec: _Spec, n_out: int,
                 n_red: int, shm, arena_size: int, out_qs, free_q, ctl_q,
                 task_q, stop_evt, cancel_evt, all_done_evt, done_flags,
                 cap_bytes: int, retain: bool, spill_dir: str,
                 sort_route=None, plan: ColumnarPlan | None = None) -> None:
    """Child body: PULL (partition, slot, k) slices off the shared task
    queue, combine each into a bounded dict, flush bucketed payload
    frames. In retain mode (retries enabled, the default) frames go to
    disk as atomically-renamed ``ret-*`` files that reducers sweep — no
    shared data queue a SIGKILLed producer could tear or lock-poison; in
    legacy mode (``DLS_SHUFFLE_MAX_RETRIES=0``) they ship through the shm
    arena / reducer queues exactly as before. With a
    :class:`ColumnarPlan`, conforming batches accumulate as planes
    instead (exact-byte metered) and flush via vectorized sort +
    segment-combine + hash-bucket split; non-conforming batches walk the
    tuple dict path.

    ``ctl_q`` is this attempt's PRIVATE control queue (single producer):
    a SIGKILL mid-write can only poison this attempt's own stream, and
    every control message stays under the pipe's 4KB atomic-write bound
    so the driver can keep draining it after the death.

    EVERY piece of per-slice state — combine store, byte meters, batch
    buffers, dtype pin, frame sequence counter — lives inside
    ``run_slice``: a replayed or speculatively cloned slice ships
    byte-identical frames at the same ``(part, slot, seq)`` ids no matter
    which worker runs it or what that worker ran before, which is the
    whole basis of reducer-side dedup (module docstring)."""
    os.environ["DLS_NATIVE_THREADS"] = "1"  # same capping rationale as workers
    # retain mode ships through the filesystem — no arena exists (shm is
    # None); the legacy transport gets its ring over the shm slab
    ring = _Arena(shm.size) if shm is not None else None
    buf = shm.buf if shm is not None else None
    alloc_id = [0]
    R = n_red
    stats = {"elems": 0, "pairs": 0, "bytes_moved": 0, "overflow": 0,
             "flushes": 0, "busy_s": 0.0, "cols_pairs": 0, "cols_bytes": 0}
    #: one shipped payload must fit the (would-be) arena with room to
    #: breathe; planes above this split by rows (each slice is
    #: independently decodable). Static, derived from the configured
    #: ``arena_size`` in BOTH modes — splitting by the arena's live hole
    #: size (or by which transport happens to run) would make frame
    #: boundaries depend on runtime state and break replay identity.
    ship_cap = max(_MIN_CAP, arena_size // 4)
    fault_at = None

    def halted() -> bool:
        return stop_evt.is_set() or cancel_evt.is_set()

    def put(q, rec) -> bool:
        while not halted():
            try:
                q.put(rec, timeout=_POLL_S)
                return True
            except queue_lib.Full:
                continue
        return False

    def alloc(need: int) -> int | None:
        deadline = time.perf_counter() + _ALLOC_WAIT_S
        while True:
            _drain_frees(ring, free_q)
            off = ring.try_alloc(alloc_id[0], need)
            if off is not None or need > ring.size:
                return off
            if halted() or time.perf_counter() > deadline:
                return None
            try:
                ring.free(free_q.get(timeout=_POLL_S))
            except queue_lib.Empty:
                pass

    def run_slice(part_idx: int, slot: int, k: int):
        """One slice, deterministically. Returns ``(per-reducer unique
        frame counts, slice stats)`` or ``None`` when halted mid-slice."""
        store: dict = {}
        meter = _ByteMeter()
        cols: list[_Planes] = []      # columnar batches awaiting a flush
        cols_meter = _ByteMeter()     # their EXACT bytes (add_exact — a
        #                               plane's size is known, never sampled)
        pend_k: list = []             # rdd pair-mode vectorization buffer
        pend_v: list = []
        pin_sig: list = [None]        # first columnar batch pins the dtypes
        seq = [0]
        counts = [0] * R
        sl = {"elems": 0, "pairs": 0, "cols_pairs": 0, "bytes": 0,
              "cols_bytes": 0}

        def ship(bucket: int, payload: bytes, columnar: bool = False) -> bool:
            stats["bytes_moved"] += len(payload)
            sl["bytes"] += len(payload)
            if columnar:
                stats["cols_bytes"] += len(payload)
                sl["cols_bytes"] += len(payload)
            hdr = (part_idx, slot, seq[0])
            seq[0] += 1
            r = bucket % R
            counts[r] += 1
            if retain:
                # the retained file IS the transport: reducers sweep
                # their retention subdir, so no shared data queue exists
                # for a killed producer to tear mid-write or lock-poison
                # for the survivors — and the lineage-replay copy costs
                # nothing extra (one write either way)
                _retain_frame(spill_dir, r, bucket, hdr, payload)
                return not halted()
            off = alloc(_align(len(payload)))
            if off is None:
                stats["overflow"] += 1
                return put(out_qs[r], ("pkl", wid, bucket, payload, hdr))
            buf[off:off + len(payload)] = payload
            ok = put(out_qs[r], ("shm", wid, bucket, alloc_id[0], off,
                                 len(payload), hdr))
            alloc_id[0] += 1
            return ok

        def add_tuple_pair(key, v) -> None:
            if key in store:
                store[key] = spec.combine(store[key], v)
                meter.add(v)
            else:
                store[key] = spec.seed(v)
                meter.add(v, 120)

        def drain_pend() -> None:
            """Vectorize the buffered rdd pairs, or route the batch through
            the tuple dict when it does not conform / breaks the pinned
            dtype signature (np.concatenate across mismatched planes would
            silently promote — int keys becoming floats is a wrong answer,
            not a slow one)."""
            if not pend_k:
                return
            pl = plan.pair_planes(pend_k, pend_v)
            if pl is not None and (pin_sig[0] is None
                                   or pl.dtype_sig() == pin_sig[0]):
                pin_sig[0] = pin_sig[0] or pl.dtype_sig()
                cols.append(pl)
                cols_meter.add_exact(pl.nbytes)
                stats["cols_pairs"] += len(pl)
                sl["cols_pairs"] += len(pl)
            else:
                for key, v in zip(pend_k, pend_v):
                    add_tuple_pair(key, v)
            pend_k.clear()
            pend_v.clear()

        def flush() -> bool:
            if plan is not None and plan.pre_planes is None:
                drain_pend()
            if not store and not cols:
                return True
            stats["flushes"] += 1
            if cols:
                combined = combine_planes(_Planes.concat(cols), plan)
                cols.clear()
                cols_meter.reset()
                for b, sub in _bucket_split(combined, n_out):
                    row_bytes = max(1, sub.nbytes // max(1, len(sub)))
                    step = max(1, ship_cap // row_bytes)
                    for lo in range(0, len(sub), step):
                        payload = pickle.dumps(
                            sub.cut(lo, min(lo + step, len(sub))).payload(),
                            protocol=_PICKLE_PROTO)
                        if not ship(b, payload, columnar=True):
                            return False
            if store:
                buckets: dict[int, list] = {}
                for key, acc in store.items():
                    kb = key_bytes(key)
                    buckets.setdefault(bucket_of(kb, n_out), []).append(
                        (kb, key, acc))
                store.clear()
                meter.reset()
                for b in sorted(buckets):
                    if not ship(b, pickle.dumps(buckets[b],
                                                protocol=_PICKLE_PROTO)):
                        return False
            return True

        t0 = time.perf_counter()
        for j, elem in enumerate(parts[part_idx]()):
            if k > 1 and j % k != slot:
                continue
            if halted():
                return None
            stats["elems"] += 1
            sl["elems"] += 1
            if fault_at is not None and stats["elems"] >= fault_at:
                faults.crash()
            if sort_route is not None:
                # sort mode: no combine — route each element straight
                # to its range bucket, tagged with (key, part, idx)
                kv = sort_route[0](elem)
                b = sort_route[1](kv)
                store.setdefault(b, []).append((kv, part_idx, j, elem))
                meter.add(elem, 64)
                stats["pairs"] += 1
                sl["pairs"] += 1
                if meter.value >= cap_bytes:
                    stats["flushes"] += 1
                    for bb in sorted(store):
                        if not ship(bb, pickle.dumps(
                                store[bb], protocol=_PICKLE_PROTO)):
                            return None
                    store.clear()
                    meter.reset()
                continue
            if plan is not None and plan.pre_planes is not None:
                pl = plan.pre_planes(elem)
                if pl is not None and (pin_sig[0] is None
                                       or pl.dtype_sig() == pin_sig[0]):
                    pin_sig[0] = pin_sig[0] or pl.dtype_sig()
                    cols.append(pl)
                    cols_meter.add_exact(pl.nbytes)
                    stats["pairs"] += len(pl)
                    sl["pairs"] += len(pl)
                    stats["cols_pairs"] += len(pl)
                    sl["cols_pairs"] += len(pl)
                    if meter.value + cols_meter.value >= cap_bytes:
                        if not flush():
                            return None
                    continue
            pairs = spec.pre(elem) if spec.pre is not None else (elem,)
            if plan is not None and plan.pre_planes is None:
                for key, v in pairs:
                    stats["pairs"] += 1
                    sl["pairs"] += 1
                    pend_k.append(key)
                    pend_v.append(v)
                    if len(pend_k) >= _PAIR_BATCH:
                        drain_pend()
                if meter.value + cols_meter.value >= cap_bytes:
                    if not flush():
                        return None
                continue
            for key, v in pairs:
                stats["pairs"] += 1
                sl["pairs"] += 1
                if spec.tag_values:
                    v = (part_idx, j, v)
                add_tuple_pair(key, v)
                if meter.value + cols_meter.value >= cap_bytes:
                    if not flush():
                        return None
        # flush at the slice boundary: mapper state never spans slices,
        # so flush points depend only on the slice's own content and the
        # cap — the determinism replay identity rests on
        if sort_route is not None:
            for bb in sorted(store):
                if not ship(bb, pickle.dumps(store[bb],
                                             protocol=_PICKLE_PROTO)):
                    return None
            store.clear()
            meter.reset()
        elif not flush():
            return None
        stats["busy_s"] += time.perf_counter() - t0
        return counts, sl

    try:
        # inside the forwarding try: a malformed spec must surface as this
        # child's typed traceback, not an inscrutable nonzero-exit "death"
        fault_at = faults.shuffle_fault("mapper", wid, epoch)
        while not halted():
            try:
                task = task_q.get(timeout=_POLL_S)
            except queue_lib.Empty:
                if all_done_evt.is_set():
                    break
                continue
            slice_idx, part_idx, slot, k = task
            if done_flags[slice_idx]:
                continue  # finished elsewhere (speculation / reseed dup)
            if not put(ctl_q, ("slice-start", wid, epoch, slice_idx)):
                # cancelled (blacklisted) between the pop and the start:
                # hand the task back, or no runner ever holds it and the
                # exchange waits out _RESEED_S (the JAX copy loses it)
                task_q.put(task)
                break
            try:
                out = run_slice(part_idx, slot, k)
            except BaseException:  # noqa: BLE001 — the SLICE failed (user
                # combine raised, bad record); the worker itself is fine —
                # report and keep pulling, the driver budgets the retries
                if not put(ctl_q, ("slice-err", wid, epoch, slice_idx,
                                   _clip_tb(traceback.format_exc()))):
                    break
                continue
            if out is None:
                break
            if not put(ctl_q, ("slice-done", wid, epoch, slice_idx,
                               out[0], out[1])):
                break
        put(ctl_q, ("mapper-done", wid, epoch, stats))
    except BaseException:  # noqa: BLE001 — forward ANY failure, typed
        put(ctl_q, ("err", ("mapper", wid, epoch),
                    _clip_tb(traceback.format_exc())))


def _spill_path(spill_dir: str, rid: int, bucket: int, n: int,
                fmt: str = "pkl") -> str:
    return os.path.join(spill_dir, f"r{rid}-b{bucket}-run{n}.{fmt}")


def _retain_dir(spill_dir: str, r: int) -> str:
    """Per-reducer retention subdirectory (``bucket % R`` owner): each
    reducer sweeps ONLY its own frames, so the poll cost scales with its
    share of the shuffle, not with the whole spill directory."""
    return os.path.join(spill_dir, f"ret{r}")


def _retain_path(spill_dir: str, r: int, bucket: int, hdr: tuple) -> str:
    """Retained-frame file: named by the frame's deterministic identity
    alone — a replayed slice re-writes the SAME name with the SAME bytes,
    so the atomic rename makes retention idempotent across attempts."""
    part, slot, seq = hdr
    return os.path.join(_retain_dir(spill_dir, r),
                        f"ret-b{bucket}-p{part}-s{slot}-q{seq}.pkl")


def _retain_frame(spill_dir: str, r: int, bucket: int, hdr: tuple,
                  payload: bytes) -> str:
    """Persist one frame — this IS the retain-mode transport (write to
    temp + atomic rename, so a sweeping reader never sees a torn file),
    and what a respawned reducer rebuilds from."""
    path = _retain_path(spill_dir, r, bucket, hdr)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def _parse_retained(fname: str) -> tuple[int, tuple] | None:
    """``ret-b{b}-p{p}-s{s}-q{q}.pkl`` → ``(bucket, (part, slot, seq))``,
    or None for any other file in the spill dir."""
    if not fname.startswith("ret-") or not fname.endswith(".pkl"):
        return None
    try:
        b, p, s, q = fname[4:-4].split("-")
        return int(b[1:]), (int(p[1:]), int(s[1:]), int(q[1:]))
    except (ValueError, IndexError):
        return None


def out_path(spill_dir: str, bucket: int) -> str:
    return os.path.join(spill_dir, f"out-b{bucket}.pkl")


def cols_out_path(spill_dir: str, bucket: int) -> str:
    return os.path.join(spill_dir, f"out-b{bucket}.cols")


def _write_cols_run(path: str, pl: _Planes) -> int:
    """One columnar spill run / output: hash-sorted combined planes as a
    stream of independently-pickled row blocks (the k-way merge and the
    readers stream blocks — run size never has to fit memory again)."""
    with open(path, "wb") as f:
        p = pickle.Pickler(f, protocol=_PICKLE_PROTO)
        for lo in range(0, len(pl), _COLS_BLOCK_ROWS):
            p.dump(pl.cut(lo, min(lo + _COLS_BLOCK_ROWS, len(pl))).payload())
        return f.tell()


def _iter_cols_blocks(path: str) -> Iterator[_Planes]:
    for rec in _iter_run(path):
        yield _Planes.from_payload(rec)


def _iter_cols_as_entries(path: str, plan: ColumnarPlan) -> Iterator:
    """A columnar run read as tuple-path ``(kb, key, acc)`` entries, in kb
    order (hash order + in-collision kb order IS kb order) — so a
    degraded bucket's earlier columnar spills merge straight into the
    tuple heapq without re-sorting."""
    for pl in _iter_cols_blocks(path):
        yield from plan.entries_from_planes(pl)


def _write_run(path: str, items: list) -> int:
    """One sorted spill run: a raw pickle stream, re-read with repeated
    loads. Returns bytes written."""
    with open(path, "wb") as f:
        p = pickle.Pickler(f, protocol=_PICKLE_PROTO)
        for it in items:
            p.dump(it)
        return f.tell()


def _iter_run(path: str) -> Iterator:
    with open(path, "rb") as f:
        up = pickle.Unpickler(f)
        while True:
            try:
                yield up.load()
            except EOFError:
                return


def _reducer_loop(rid: int, R: int, n_out: int, spec: _Spec | None,
                  in_q, free_qs, shm_prefix, ctl_q, stop_evt,
                  cap_bytes: int, spill_dir: str, sort_spec=None,
                  plan: ColumnarPlan | None = None, attempt: int = 0,
                  retain: bool = False) -> None:
    """Child body: merge arriving bucket payload frames under a byte
    budget, spill sorted runs past it, k-way-merge runs into one output
    file per owned bucket. A bucket receiving only plane payloads stays
    columnar end to end (exact-byte metered, columnar spill runs,
    vectorized merge, ``.cols`` output); the first tuple payload for a
    bucket degrades THAT bucket to the tuple dict path — output bytes are
    identical either way, the formats differ only in speed.

    Fault tolerance: frames dedupe by their ``(part, slot,
    seq)`` identity (mapper replays and speculative clones ship
    byte-identical duplicates); the loop ends when the unique-frame count
    reaches the ``eof`` total the driver computed from winning
    ``slice-done`` reports. In retain mode frames arrive by SWEEPING the
    retained ``ret-*`` files (``in_q`` then carries only the driver's
    ``eof``); in legacy mode (retries=0) they stream through
    shm-arena/queue transport as before. A respawned attempt first
    discards the dead attempt's spill runs and partial out files — their
    merge provenance is unknown — then rebuilds purely from retained
    files; it never touches the dead consumer's queue (whose pipe a
    SIGKILL mid-``recv`` can leave torn). ``ctl_q`` is this attempt's
    private notify channel to the driver."""
    os.environ["DLS_NATIVE_THREADS"] = "1"
    shms: dict[int, shared_memory.SharedMemory] = {}
    # keyed mode: bucket -> {key: [kb, acc]} (tuple) | [_Planes] (cols);
    # sort mode: bucket -> [entry]
    stores: dict[int, Any] = {}
    modes: dict[int, str] = {}          # bucket -> "cols" | "tuple"
    sigs: dict[int, tuple] = {}         # bucket -> pinned plane dtype sig
    cols_bytes: dict[int, int] = {}     # bucket -> exact resident plane B
    runs: dict[int, list] = {}          # bucket -> [(fmt, path)]
    meter = _ByteMeter()
    seen: set = set()                   # merged frame ids (part, slot, seq)
    expected = [None]                   # unique-frame total, from "eof"
    fault_at = None
    stats = {"spills": 0, "spill_bytes": 0, "bucket_rows": {}, "merge_s": 0.0,
             "cols_buckets": 0, "tuple_buckets": 0}

    def notify(msg) -> None:
        try:
            ctl_q.put(msg, timeout=_POLL_S)
        except queue_lib.Full:
            pass

    def arena_bytes(wid: int, alloc_id: int, off: int, size: int) -> bytes:
        if wid not in shms:
            shms[wid] = shared_memory.SharedMemory(
                name=f"{shm_prefix}-m{wid}")
        data = bytes(shms[wid].buf[off:off + size])
        try:  # copy taken — release the mapper's arena slot immediately
            free_qs[wid].put_nowait(alloc_id)
        except Exception:  # noqa: BLE001 — mapper may be gone at teardown
            pass
        return data

    def merge_entries(bucket: int, items) -> None:
        st = stores.setdefault(bucket, {})
        for kb, key, acc in items:
            ent = st.get(key)
            if ent is None:
                st[key] = [kb, acc]
                meter.add(acc, len(kb) + 100)
            else:
                ent[1] = spec.merge(ent[1], acc)
                meter.add(acc)

    def degrade(bucket: int) -> None:
        """Mixed formats arrived for this bucket: convert its resident
        planes to tuple entries and continue dict-side. Earlier columnar
        spill runs stay columnar on disk; the finalize merge reads them
        back as kb-ordered entries."""
        planes = stores.pop(bucket, [])
        cols_bytes.pop(bucket, None)
        modes[bucket] = "tuple"
        sigs.pop(bucket, None)
        stores[bucket] = {}
        if planes:
            merge_entries(bucket, plan.entries_from_planes(
                combine_planes(_Planes.concat(planes), plan)))

    def resident() -> float:
        return meter.value + sum(cols_bytes.values())

    def bucket_size(b: int) -> int:
        s = stores[b]
        return (sum(len(p) for p in s) if modes.get(b) == "cols"
                else len(s))

    def spill_largest() -> None:
        if not stores:
            return
        bucket = max(stores, key=bucket_size)
        n_run = len(runs.setdefault(bucket, []))
        if modes.get(bucket) == "cols":
            combined = combine_planes(_Planes.concat(stores.pop(bucket)),
                                      plan)
            cols_bytes.pop(bucket, None)
            path = _spill_path(spill_dir, rid, bucket, n_run, "cols")
            nbytes = _write_cols_run(path, combined)
            runs[bucket].append(("cols", path))
            n_items = len(combined)
        else:
            if sort_spec is not None:
                items = sorted(stores.pop(bucket), key=sort_spec[0],
                               reverse=sort_spec[1])
            else:
                items = sorted(
                    ((e[0], key, e[1])
                     for key, e in stores.pop(bucket).items()),
                    key=lambda t: t[0])
            path = _spill_path(spill_dir, rid, bucket, n_run)
            nbytes = _write_run(path, items)
            runs[bucket].append(("pkl", path))
            n_items = len(items)
            # rebase surviving tuple buckets at the meter's OWN rolling
            # per-item estimate — a flat constant here would under-charge
            # fat values (group lists) and let residency creep past the
            # budget share. Columnar residency is exact and untouched.
            meter.value = (sum(len(s) for b, s in stores.items()
                               if modes.get(b) != "cols")
                           * (meter._est + 100))
        stats["spills"] += 1
        stats["spill_bytes"] += nbytes
        notify(("spill", rid, bucket, n_items, nbytes))

    def merge_bucket(bucket: int) -> None:
        """Stream the bucket's runs + memory into its final output file."""
        t0 = time.perf_counter()
        rows = 0
        bucket_runs = runs.get(bucket, [])
        if sort_spec is not None:
            streams = [_iter_run(p) for _fmt, p in bucket_runs]
            mem = sorted(stores.pop(bucket, []), key=sort_spec[0],
                         reverse=sort_spec[1])
            merged = heapq.merge(*streams, mem, key=sort_spec[0],
                                 reverse=sort_spec[1])
            with open(out_path(spill_dir, bucket), "wb") as f:
                p = pickle.Pickler(f, protocol=_PICKLE_PROTO)
                for _kv, _part, _j, elem in merged:
                    p.dump(elem)
                    rows += 1
        elif modes.get(bucket) == "cols":
            # pure columnar bucket: k-way merge the sorted runs + memory
            # on the hash column, blockwise — no per-key Python anywhere
            planes = stores.pop(bucket, [])
            cols_bytes.pop(bucket, None)
            streams = [_iter_cols_blocks(p) for _fmt, p in bucket_runs]
            if planes:
                streams.append(iter(
                    [combine_planes(_Planes.concat(planes), plan)]))
            with open(cols_out_path(spill_dir, bucket), "wb") as f:
                pk = pickle.Pickler(f, protocol=_PICKLE_PROTO)
                for blk in _merge_cols_streams(streams, plan):
                    if len(blk):
                        pk.dump(blk.payload())
                        rows += len(blk)
            if rows:
                stats["cols_buckets"] += 1
        else:
            streams = [(_iter_run(p) if fmt == "pkl"
                        else _iter_cols_as_entries(p, plan))
                       for fmt, p in bucket_runs]
            mem = sorted(
                ((e[0], key, e[1])
                 for key, e in stores.pop(bucket, {}).items()),
                key=lambda t: t[0])
            merged = heapq.merge(*streams, mem, key=lambda t: t[0])
            with open(out_path(spill_dir, bucket), "wb") as f:
                p = pickle.Pickler(f, protocol=_PICKLE_PROTO)
                cur_kb = cur_key = cur_acc = None
                for kb, key, acc in merged:
                    if cur_kb is not None and kb == cur_kb:
                        cur_acc = spec.merge(cur_acc, acc)
                        continue
                    if cur_kb is not None:
                        p.dump(spec.final(cur_key, cur_acc))
                        rows += 1
                    cur_kb, cur_key, cur_acc = kb, key, acc
                if cur_kb is not None:
                    p.dump(spec.final(cur_key, cur_acc))
                    rows += 1
            if rows:
                stats["tuple_buckets"] += 1
        for _fmt, p_ in runs.pop(bucket, []):
            try:
                os.remove(p_)
            except OSError:
                pass
        stats["bucket_rows"][bucket] = rows
        stats["merge_s"] += time.perf_counter() - t0

    def ingest(bucket: int, payload: bytes) -> None:
        """Merge one deduplicated frame payload into its bucket store."""
        items = pickle.loads(payload)
        if sort_spec is not None:
            lst = stores.setdefault(bucket, [])
            lst.extend(items)
            for e in items:
                meter.add(e[3], 64)
        elif (isinstance(items, tuple) and items
              and items[0] == "cols"):
            pl = _Planes.from_payload(items)
            mode = modes.get(bucket)
            if mode is None:
                modes[bucket] = "cols"
                sigs[bucket] = pl.dtype_sig()
                stores[bucket] = [pl]
                cols_bytes[bucket] = pl.nbytes
            elif mode == "cols":
                if pl.dtype_sig() != sigs[bucket]:
                    # two mappers pinned different scalar types for
                    # keys landing here — concatenation would promote
                    # (wrong bytes); the tuple path merges them right
                    degrade(bucket)
                    merge_entries(bucket,
                                  plan.entries_from_planes(pl))
                else:
                    stores.setdefault(bucket, []).append(pl)
                    cols_bytes[bucket] = (cols_bytes.get(bucket, 0)
                                          + pl.nbytes)
            else:
                merge_entries(bucket, plan.entries_from_planes(pl))
        else:
            if modes.get(bucket) == "cols":
                degrade(bucket)
            modes.setdefault(bucket, "tuple")
            merge_entries(bucket, items)
        while resident() >= cap_bytes and stores:
            spill_largest()
        if fault_at is not None and len(seen) >= fault_at:
            faults.crash()

    def handle_rec(rec) -> None:
        kind = rec[0]
        if kind == "eof":
            expected[0] = rec[1]
            return
        if kind == "shm":
            _, wid, bucket, aid, off, size, hdr = rec
            # read + free BEFORE the dedup check: a duplicate's arena slot
            # must still be released or speculation would leak the ring
            data = arena_bytes(wid, aid, off, size)
            if hdr in seen:
                return
            seen.add(hdr)
            ingest(bucket, data)
        elif kind == "pkl":
            _, wid, bucket, payload, hdr = rec
            if hdr in seen:
                return
            seen.add(hdr)
            ingest(bucket, payload)

    swept: set = set()  # filenames already handled (or never relevant)
    my_ret_dir = _retain_dir(spill_dir, rid)

    def sweep_retained() -> bool:
        """Merge retained frames not yet seen — the retain-mode data path
        (every attempt, not just respawns). Only THIS reducer's retention
        subdir is listed, and handled (or never-relevant: in-flight
        ``.tmp``s — a tmp becomes visible under its FINAL name) filenames
        memoize into ``swept``, so each sweep parses only new arrivals.
        Retention writes are atomic renames, so any listed file is
        whole; merge order needs no sort — dedup is identity-keyed and
        the final output order is canonicalized by the bucket merge."""
        progressed = False
        for fname in os.listdir(my_ret_dir):
            if fname in swept:
                continue
            parsed = _parse_retained(fname)
            if parsed is None:
                swept.add(fname)
                continue
            bucket, hdr = parsed
            if bucket % R != rid or hdr in seen:
                swept.add(fname)
                continue
            try:
                with open(os.path.join(my_ret_dir, fname), "rb") as f:
                    data = f.read()
            except OSError:  # pragma: no cover - teardown race
                continue
            swept.add(fname)
            seen.add(hdr)
            ingest(bucket, data)
            progressed = True
        return progressed

    try:
        # inside the forwarding try: a malformed spec must surface as this
        # child's typed traceback, not an inscrutable nonzero-exit "death"
        fault_at = faults.shuffle_fault("reducer", rid, attempt)
        if attempt > 0:
            # rebuild from scratch: the dead attempt's spill runs and any
            # partial out files merged an unknown subset of frames
            for fname in os.listdir(spill_dir):
                if fname.startswith(f"r{rid}-b"):
                    try:
                        os.remove(os.path.join(spill_dir, fname))
                    except OSError:
                        pass
            for b in range(rid, n_out, R):
                for p in (out_path(spill_dir, b), cols_out_path(spill_dir, b)):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        while expected[0] is None or len(seen) < expected[0]:
            if stop_evt.is_set():
                return
            if retain:
                progressed = sweep_retained()
                try:
                    handle_rec(in_q.get_nowait())  # driver "eof" only
                    progressed = True
                except queue_lib.Empty:
                    pass
                if not progressed:
                    time.sleep(0.05)
            else:
                try:
                    handle_rec(in_q.get(timeout=_POLL_S))
                except queue_lib.Empty:
                    pass
        for bucket in range(rid, n_out, R):
            if stop_evt.is_set():
                return
            merge_bucket(bucket)
        notify(("reducer-done", rid, stats))
    except BaseException:  # noqa: BLE001
        notify(("err", ("reducer", rid, attempt),
                _clip_tb(traceback.format_exc())))
    finally:
        for s in shms.values():
            try:
                s.close()
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


class ShuffleResult:
    """Per-bucket output files + the stats the telemetry summary carried.
    Holds the spill directory alive; it is removed when this object (and
    every dataset partition referencing it) is garbage-collected."""

    def __init__(self, spill_dir: str, n_out: int, stats: dict,
                 keep_dir: bool, plan: ColumnarPlan | None = None):
        self.spill_dir = spill_dir
        self.n_out = n_out
        self.stats = stats
        self.plan = plan
        self._fin = (weakref.finalize(self, _rm_dir, spill_dir)
                     if not keep_dir else None)

    def iter_bucket(self, bucket: int) -> Iterator:
        # generator METHOD on purpose: the running frame holds ``self``, so
        # the spill directory cannot be finalized out from under a consumer
        # whose dataset reference was dropped mid-iteration
        path = out_path(self.spill_dir, bucket)
        if os.path.exists(path):
            yield from _iter_run(path)
            return
        cpath = cols_out_path(self.spill_dir, bucket)
        if os.path.exists(cpath) and self.plan is not None:
            for pl in _iter_cols_blocks(cpath):
                yield from self.plan.rows_from_planes(pl)

    def iter_bucket_planes(self, bucket: int) -> Iterator[_Planes] | None:
        """Blockwise plane access for a columnar bucket, or ``None`` when
        this bucket finalized in tuple format (mixed-eligibility buckets
        do) — the caller then falls back to :meth:`iter_bucket` rows. The
        zero-copy read the dataframe agg path builds chunks straight
        from."""
        cpath = cols_out_path(self.spill_dir, bucket)
        if self.plan is None or not os.path.exists(cpath):
            return None
        return self._planes_gen(cpath)

    def _planes_gen(self, cpath: str) -> Iterator[_Planes]:
        # separate generator so iter_bucket_planes can return None eagerly
        self_ref = self  # noqa: F841 — pins the finalizer, like iter_bucket
        yield from _iter_cols_blocks(cpath)


def _rm_dir(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def _assignments(P: int, M: int) -> list[list[tuple[int, int, int]]]:
    """Mapper → [(partition, slot, k)]: whole partitions round-robin onto
    mappers while ``M <= P``; past that, the mappers co-assigned to one
    partition split it by element residue (slot of k) — the WorkerPool
    discipline, so a single-partition source still scales."""
    if M <= P:
        whole: list[list[tuple[int, int, int]]] = [[] for _ in range(M)]
        for p in range(P):
            whole[p % M].append((p, 0, 1))
        return whole
    per_part: list[list[int]] = [[] for _ in range(P)]
    for m in range(M):
        per_part[m % P].append(m)
    out: list[list[tuple[int, int, int]]] = [[] for _ in range(M)]
    for p, ms in enumerate(per_part):
        for slot, m in enumerate(ms):
            out[m].append((p, slot, len(ms)))
    return out


def run_exchange(parts: Sequence[Callable[[], Any]], *, num_workers: int,
                 n_out: int, spec: _Spec | None, label: str,
                 sort_route=None, sort_spec=None,
                 mem_mb: float | None = None,
                 plan: ColumnarPlan | None = None) -> ShuffleResult:
    """Execute one shuffle: spawn mappers + reducers, stream the exchange,
    return the per-bucket output. Task failures self-heal (lineage retry,
    speculation, blacklisting — module docstring) under the
    ``DLS_SHUFFLE_MAX_RETRIES`` budget; past it — or with the budget set
    to 0 — raises the typed :class:`WorkerCrashed` (cleaning up every
    child, shm segment, and spill file) exactly as before. With a
    :class:`ColumnarPlan`, conforming batches ship as flat planes (see
    the module docstring) — output is byte-identical either way."""
    P = len(parts)
    M = max(1, int(num_workers))
    R = max(1, min(M, n_out))
    budget = mem_budget_bytes(mem_mb)
    arena_bytes = max(_MIN_ARENA, budget // (4 * M))
    map_cap = max(_MIN_CAP, budget // (4 * M))
    red_cap = max(_MIN_CAP, budget // (2 * R))
    retries_left = max_shuffle_retries()
    retries_budget = retries_left
    retain = retries_left > 0
    strikes_k = blacklist_after()
    spec_factor = speculate_factor()
    # validate any declared shuffle fault HERE, driver-side: a typo'd
    # drill must fail loudly before a single child spawns, not burn the
    # retry budget on children that die at startup and get misread as
    # OOM kills (the children re-check inside their forwarding try)
    faults.shuffle_fault("mapper", 0, 0)
    base = os.environ.get(SPILL_DIR_ENV) or None
    if base:
        os.makedirs(base, exist_ok=True)
    spill_dir = tempfile.mkdtemp(prefix="dlsx-", dir=base)
    if retain:  # per-reducer retention subdirs, created before any child
        for r in range(R):
            os.makedirs(_retain_dir(spill_dir, r))
    ctx = mp.get_context("fork")
    stop = ctx.Event()
    task_q = ctx.Queue()
    all_done_evt = ctx.Event()
    # the shm-arena data plane exists only in legacy mode; retain mode
    # ships frames through the filesystem, so its exchanges carry no data
    # queues, free queues, or arenas at all
    out_qs = ([] if retain
              else [ctx.Queue(maxsize=_QUEUE_AHEAD) for _ in range(R)])
    free_qs = [] if retain else [ctx.Queue() for _ in range(M)]
    #: the canonical slice list — task ids index into it
    slices = sorted((t for a in _assignments(P, M) for t in a),
                    key=lambda t: (t[0], t[1]))
    n_slices = len(slices)
    done_flags = ctx.RawArray("b", max(1, n_slices))
    shm_prefix = f"dlsx-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    # LIVE lists, shared with the finalizer: respawned children and their
    # fresh epoch arenas append here, so interpreter-exit teardown reaps
    # them too (not just the processes alive at registration time)
    live_procs: list = []
    live_shms: list = []
    attempts: list[dict] = []
    red_q: list = [None] * R         # newest attempt's control/data queue
    red_attempt = [0] * R

    def _new_arena(wid: int):
        s = shared_memory.SharedMemory(
            create=True, size=arena_bytes, name=f"{shm_prefix}-m{wid}")
        live_shms.append(s)
        return s

    def _start(proc) -> None:
        # children run numpy/pickle only (never torch.cuda): fork them as
        # the input pool does, the collector frozen, the warnings silenced
        with _forking():
            proc.start()
        live_procs.append(proc)

    def spawn_mapper(wid: int, epoch: int) -> dict:
        # retain mode moves frames through the filesystem — no arena to
        # allocate (ship_cap still derives from arena_bytes so frame
        # boundaries match across modes and attempts); epoch > 0 only
        # happens in retain mode, so arenas never need versioning
        shm = None if retain else _new_arena(wid)
        cancel = ctx.Event()
        # per-attempt control queue, single producer: a SIGKILL mid-write
        # can only poison THIS attempt's stream — the shared-queue version
        # of this deadlocked every surviving producer on the write lock
        ctl = ctx.Queue()
        p = ctx.Process(
            target=_mapper_loop, daemon=True, name=f"dlsx-map-{wid}e{epoch}",
            args=(wid, epoch, list(parts), spec, n_out, R, shm, arena_bytes,
                  out_qs, free_qs[wid] if free_qs else None, ctl, task_q,
                  stop, cancel, all_done_evt, done_flags, map_cap, retain,
                  spill_dir, sort_route, plan))
        _start(p)
        att = {"role": "mapper", "wid": wid, "epoch": epoch, "proc": p,
               "ctl": ctl, "cancel": cancel, "finished": False}
        attempts.append(att)
        return att

    def spawn_reducer(rid: int, attempt: int) -> dict:
        if retain:
            # retain mode: data arrives by sweeping retained files; this
            # queue carries ONLY the driver's "eof" (driver is the sole
            # producer). A replacement never touches the dead consumer's
            # queue — a SIGKILL mid-recv can leave its pipe torn.
            in_q = ctx.Queue()
        else:
            in_q = out_qs[rid]
        ctl = ctx.Queue()
        red_q[rid] = in_q
        p = ctx.Process(
            target=_reducer_loop, daemon=True,
            name=f"dlsx-red-{rid}a{attempt}",
            args=(rid, R, n_out, spec, in_q, free_qs, shm_prefix, ctl,
                  stop, red_cap, spill_dir, sort_spec, plan, attempt,
                  retain))
        _start(p)
        att = {"role": "reducer", "wid": rid, "epoch": attempt, "proc": p,
               "ctl": ctl, "finished": False}
        attempts.append(att)
        return att

    for m in range(M):
        spawn_mapper(m, 0)
    for r in range(R):
        spawn_reducer(r, 0)
    for i, t in enumerate(slices):
        task_q.put((i,) + t)
    finalizer = weakref.finalize(
        run_exchange, _exchange_cleanup, stop, live_procs, live_shms)

    t_start = time.perf_counter()
    sl_done = [False] * n_slices
    sl_counts: list = [None] * n_slices   # winning per-reducer frame counts
    sl_stats: list = [None] * n_slices    # winning per-slice input stats
    sl_running: dict[int, dict] = {}      # slice -> {(wid, epoch): t0}
    sl_speculated = [False] * n_slices
    sl_durations: list[float] = []
    n_done = 0
    strikes: dict[tuple, int] = {}
    blacklisted: set[tuple] = set()
    recovery = {"retries": 0, "mapper_retries": 0, "reducer_retries": 0,
                "speculations": 0, "blacklists": 0}
    map_stats: list[dict] = []
    red_done: dict[int, dict] = {}
    spills = 0
    spill_bytes = 0
    map_end: float | None = None
    eof_totals: list | None = None
    pending_eof: dict[int, tuple] = {}    # rid -> (queue, total)
    last_progress = t_start

    def _active_mappers() -> list:
        return [a for a in attempts if a["role"] == "mapper"
                and not a["finished"] and a["proc"].is_alive()]

    def _find_attempt(role: str, wid: int, epoch: int) -> dict | None:
        for a in attempts:
            if (a["role"], a["wid"], a["epoch"]) == (role, wid, epoch):
                return a
        return None

    def charge_retry(role: str, wid: int, reason: str, *,
                     slice_idx: int | None = None,
                     exitcode: int | None = None) -> None:
        """Burn one unit of the retry budget, or escalate — the typed
        WorkerCrashed of the fail-fast days — when it is spent."""
        nonlocal retries_left
        if retries_left <= 0:
            suffix = ("" if retries_budget == 0 else
                      f" [retry budget {MAX_RETRIES_ENV}="
                      f"{retries_budget} exhausted]")
            raise WorkerCrashed(f"shuffle {role} {wid} {reason}{suffix}",
                                worker=wid, exitcode=exitcode)
        retries_left -= 1
        recovery["retries"] += 1
        recovery[f"{role}_retries"] += 1
        telemetry.emit(
            "shuffle", edge="retry", op=label, role=role, worker=wid,
            reason=("died" if exitcode is not None else "raised"),
            exitcode=exitcode, slice=slice_idx, retries_left=retries_left)

    def strike(role: str, wid: int) -> bool:
        """Score one failure; True when the slot just got blacklisted."""
        k = strikes[(role, wid)] = strikes.get((role, wid), 0) + 1
        if k >= strikes_k and (role, wid) not in blacklisted:
            blacklisted.add((role, wid))
            recovery["blacklists"] += 1
            telemetry.emit("shuffle", edge="blacklist", op=label,
                           role=role, worker=wid, strikes=k)
            return True
        return False

    def clear_runners(wid: int, epoch: int) -> None:
        """Deregister a failed attempt's running slices — enqueueing is
        reseed_unclaimed's job, the SINGLE re-enqueue point, so one
        failure adds at most one copy of any slice to the queue."""
        for runners in sl_running.values():
            runners.pop((wid, epoch), None)

    def reseed_unclaimed() -> None:
        """Repair task custody after a worker failure: the slices the
        failed attempt was running, plus any task it POPPED before its
        slice-start landed (gone from the queue with no runner
        registered). Re-enqueue every undone slice with no runner — a
        duplicate of a task still sitting unclaimed in the queue is
        harmless (done_flags skip + frame dedup) and bounded at one copy
        per failure; this never runs on the hot path."""
        for si in range(n_slices):
            if not sl_done[si] and not sl_running.get(si):
                task_q.put((si,) + slices[si])

    def assert_mappers_remain(wid: int, reason: str,
                              exitcode=None) -> None:
        if not _active_mappers() and n_done < n_slices:
            raise WorkerCrashed(
                f"shuffle mapper {wid} blacklisted after "
                f"{strikes[('mapper', wid)]} failures and no usable "
                f"mappers remain ({n_slices - n_done} slices unfinished); "
                f"last failure: {reason}", worker=wid, exitcode=exitcode)

    def on_mapper_failure(wid: int, epoch: int, reason: str, *,
                          exitcode=None, slice_idx=None) -> None:
        charge_retry("mapper", wid, reason, exitcode=exitcode,
                     slice_idx=slice_idx)
        crossed = strike("mapper", wid)
        clear_runners(wid, epoch)
        if crossed:
            for a in attempts:   # a blacklisted slot stops taking work
                if (a["role"] == "mapper" and a["wid"] == wid
                        and not a["finished"]):
                    a["cancel"].set()
                    a["finished"] = True
            assert_mappers_remain(wid, reason, exitcode)
        else:
            att = _find_attempt("mapper", wid, epoch)
            if exitcode is not None or (att is not None and att["finished"]):
                # the process is gone (death, or infra-err exit): respawn
                # a replacement attempt — it runs the retained-file
                # transport, so no transport state needs recreating
                spawn_mapper(wid, epoch + 1)
        reseed_unclaimed()

    def on_reducer_failure(rid: int, attempt: int, reason: str, *,
                           exitcode=None) -> None:
        if not retain:  # pragma: no cover - retain is False only when
            # retries are 0, and charge_retry escalates first
            raise WorkerCrashed(f"shuffle reducer {rid} {reason}",
                                worker=rid, exitcode=exitcode)
        charge_retry("reducer", rid, reason, exitcode=exitcode)
        if strike("reducer", rid):
            raise WorkerCrashed(
                f"shuffle reducer {rid} blacklisted after "
                f"{strikes[('reducer', rid)]} failures — its buckets "
                f"cannot move to another slot; last failure: {reason}",
                worker=rid, exitcode=exitcode)
        red_attempt[rid] += 1
        spawn_reducer(rid, red_attempt[rid])
        if eof_totals is not None:
            pending_eof[rid] = (red_q[rid], eof_totals[rid])

    def finish_map(now: float) -> None:
        nonlocal map_end, eof_totals
        map_end = now
        telemetry.emit("phase", name="shuffle-map", edge="end",
                       dur_s=map_end - t_start, op=label)
        telemetry.emit("phase", name="shuffle-merge", edge="begin",
                       op=label)
        all_done_evt.set()
        eof_totals = [sum(c[r] for c in sl_counts if c is not None)
                      for r in range(R)]
        for r in range(R):
            pending_eof[r] = (red_q[r], eof_totals[r])

    def maybe_speculate(now: float) -> None:
        if (spec_factor <= 0 or not sl_durations or n_done >= n_slices
                or len(_active_mappers()) < 2):
            return
        med = sorted(sl_durations)[len(sl_durations) // 2]
        lag = max(_SPECULATE_FLOOR_S, spec_factor * med)
        for si, runners in sl_running.items():
            if sl_done[si] or sl_speculated[si] or not runners:
                continue
            started = min(runners.values())
            if now - started > lag:
                sl_speculated[si] = True
                recovery["speculations"] += 1
                telemetry.emit(
                    "shuffle", edge="speculate", op=label, slice=si,
                    part=slices[si][0], slot=slices[si][1],
                    elapsed_s=round(now - started, 3),
                    median_s=round(med, 3))
                task_q.put((si,) + slices[si])

    def maybe_reseed(now: float) -> None:
        """Last-resort custody net: failure handlers already call
        reseed_unclaimed() for every known loss path; this long-window
        sweep only exists so an UNFORESEEN loss degrades into one
        duplicate round per _RESEED_S instead of a silent hang."""
        nonlocal last_progress
        if n_done >= n_slices or now - last_progress < _RESEED_S:
            return
        last_progress = now
        reseed_unclaimed()

    telemetry.emit("phase", name="shuffle-map", edge="begin", op=label)
    try:
        if n_slices == 0 and map_end is None:
            finish_map(time.perf_counter())
        while n_done < n_slices or len(red_done) < R:
            now = time.perf_counter()
            for rid in list(pending_eof):
                q, total = pending_eof[rid]
                try:
                    q.put_nowait(("eof", total))
                    del pending_eof[rid]
                except queue_lib.Full:
                    pass
            msg = None
            for att in attempts:
                if att["finished"]:
                    continue
                try:
                    msg = att["ctl"].get_nowait()
                    break
                except queue_lib.Empty:
                    continue
            if msg is None:
                dead = None
                for att in attempts:
                    if att["finished"] or att["proc"].is_alive():
                        continue
                    # drain race: its last message may still be in flight
                    try:
                        msg = att["ctl"].get(timeout=_POLL_S)
                    except queue_lib.Empty:
                        dead = att
                    break
                if dead is not None:
                    dead["finished"] = True
                    rc = dead["proc"].exitcode
                    rc = -1 if rc is None else rc
                    reason = (f"died (exit code {rc}) mid-exchange — "
                              f"killed (OOM/SIGKILL) or crashed in "
                              f"native code")
                    if dead["role"] == "mapper":
                        if n_done < n_slices:
                            on_mapper_failure(dead["wid"], dead["epoch"],
                                              reason, exitcode=rc)
                        # else: a straggler (speculation loser) dying
                        # after every slice completed costs nothing
                    else:
                        on_reducer_failure(dead["wid"], dead["epoch"],
                                           reason, exitcode=rc)
                    continue
                if msg is None:
                    maybe_speculate(now)
                    maybe_reseed(now)
                    time.sleep(0.02)
                    continue
            last_progress = now
            kind = msg[0]
            if kind == "slice-start":
                _, wid, ep, si = msg
                sl_running.setdefault(si, {})[(wid, ep)] = now
            elif kind == "slice-done":
                _, wid, ep, si, counts, sl = msg
                started = sl_running.get(si, {}).pop((wid, ep), None)
                if not sl_done[si]:
                    sl_done[si] = True
                    done_flags[si] = 1
                    n_done += 1
                    sl_counts[si] = counts
                    sl_stats[si] = sl
                    if started is not None:
                        sl_durations.append(now - started)
                    if n_done == n_slices:
                        finish_map(now)
            elif kind == "slice-err":
                _, wid, ep, si, tb = msg
                sl_running.get(si, {}).pop((wid, ep), None)
                if not sl_done[si]:
                    # the trailing reseed_unclaimed re-enqueues the slice
                    on_mapper_failure(wid, ep, f"raised:\n{tb}",
                                      slice_idx=si)
            elif kind == "err":
                role, wid, ep = msg[1]
                att = _find_attempt(role, wid, ep)
                if att is not None:
                    att["finished"] = True
                if role == "mapper":
                    on_mapper_failure(wid, ep, f"raised:\n{msg[2]}")
                else:
                    on_reducer_failure(wid, ep, f"raised:\n{msg[2]}")
            elif kind == "mapper-done":
                _, wid, ep, st = msg
                att = _find_attempt("mapper", wid, ep)
                if att is not None:
                    att["finished"] = True
                map_stats.append(st)
            elif kind == "reducer-done":
                red_done[msg[1]] = msg[2]
                for a in attempts:
                    if a["role"] == "reducer" and a["wid"] == msg[1]:
                        a["finished"] = True
            elif kind == "spill":
                spills += 1
                spill_bytes += msg[4]
                telemetry.emit("shuffle", edge="spill", op=label,
                               reducer=msg[1], bucket=msg[2], rows=msg[3],
                               bytes=msg[4])
        merge_s = time.perf_counter() - (map_end or t_start)
        telemetry.emit("phase", name="shuffle-merge", edge="end",
                       dur_s=merge_s, op=label)
    except BaseException:
        # failed exchange: nothing must leak — children, shm, spill files.
        # End whichever phase is OPEN (map, or merge once map ended) so a
        # crashed shuffle never pins a stale open phase onto every later
        # heartbeat's hang localization
        stop.set()
        telemetry.emit(
            "phase", edge="end", op=label, aborted=True,
            name="shuffle-map" if map_end is None else "shuffle-merge")
        _exchange_cleanup(stop, live_procs, live_shms)
        finalizer.detach()
        _rm_dir(spill_dir)
        raise

    # reducers are done; give clean-exiting mappers a beat to land their
    # stats, then cancel stragglers (speculation losers still grinding a
    # slice someone else already won)
    grace = time.time() + 2.0
    while (any(a["role"] == "mapper" and not a["finished"]
               for a in attempts) and time.time() < grace):
        progressed = False
        for a in attempts:
            if a["role"] != "mapper" or a["finished"]:
                continue
            try:
                msg = a["ctl"].get_nowait()
            except queue_lib.Empty:
                if not a["proc"].is_alive():
                    a["finished"] = True
                continue
            if msg[0] == "mapper-done":
                a["finished"] = True
                map_stats.append(msg[3])
                progressed = True
        if not progressed:
            time.sleep(0.05)
    for a in attempts:
        if a["role"] == "mapper" and not a["finished"]:
            a["cancel"].set()
            a["finished"] = True
    finalizer.detach()
    _exchange_cleanup(stop, live_procs, live_shms)
    if retain:  # retained frames served their purpose; the result dir
        for r in range(R):   # keeps only bucket output
            shutil.rmtree(_retain_dir(spill_dir, r), ignore_errors=True)

    bucket_rows: dict[int, int] = {}
    for st in red_done.values():
        bucket_rows.update(st["bucket_rows"])
    rows_list = [bucket_rows.get(b, 0) for b in range(n_out)]
    # input-side totals come from the WINNING slice reports, so they are
    # deterministic across retries and speculation (a replayed slice's
    # numbers count once, no matter how many attempts ran it); transport-
    # dependent counters (overflow) still sum over every attempt
    win = [s for s in sl_stats if s is not None]
    pairs_in = sum(s["pairs"] for s in win)
    bytes_moved = sum(s["bytes"] for s in win)
    cols_pairs = sum(s["cols_pairs"] for s in win)
    cols_bytes = sum(s["cols_bytes"] for s in win)
    transport = ("tuple" if plan is None or cols_pairs == 0
                 else ("columnar" if cols_pairs == pairs_in else "mixed"))
    stats = {
        "op": label,
        "workers": M,
        "reducers": R,
        "buckets": n_out,
        "elems_in": sum(s["elems"] for s in win),
        "pairs_in": pairs_in,
        "rows_out": sum(rows_list),
        "bytes_moved": bytes_moved,
        "overflow": sum(st["overflow"] for st in map_stats),
        "spills": spills,
        "spill_bytes": spill_bytes,
        "map_s": round((map_end or t_start) - t_start, 3),
        "merge_s": round(time.perf_counter() - (map_end or t_start), 3),
        "bucket_rows": rows_list,
        "mem_budget_mb": round(budget / (1 << 20), 1),
        # per-format split: which bytes/keys rode which
        # transport, and how each bucket finalized — the dlstatus
        # shuffle block's per-format rows
        "transport": transport,
        "columnar_pairs": cols_pairs,
        "columnar_bytes": cols_bytes,
        "tuple_pairs": pairs_in - cols_pairs,
        "tuple_bytes": bytes_moved - cols_bytes,
        "columnar_buckets": sum(
            st.get("cols_buckets", 0) for st in red_done.values()),
        "tuple_buckets": sum(
            st.get("tuple_buckets", 0) for st in red_done.values()),
        # recovery rollup: what self-healing cost this run
        "retries": recovery["retries"],
        "mapper_retries": recovery["mapper_retries"],
        "reducer_retries": recovery["reducer_retries"],
        "speculations": recovery["speculations"],
        "blacklists": recovery["blacklists"],
    }
    telemetry.emit("shuffle", edge="done", **stats)
    return ShuffleResult(spill_dir, n_out, stats, keep_dir=False, plan=plan)


def _exchange_cleanup(stop, procs, shms) -> None:
    """Idempotent teardown (finalize/atexit-safe): stop, reap, unlink."""
    stop.set()
    for p in procs:
        p.join(timeout=1.0)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=1.0)
    for s in shms:
        try:
            s.unlink()
        except FileNotFoundError:
            pass
        try:
            s.close()
        except BufferError:  # pragma: no cover - defensive
            s._buf = None
            s._mmap = None


# ---------------------------------------------------------------------------
# dataset-level entry points (used by rdd.py / data/dataframe.py)
# ---------------------------------------------------------------------------


def lazy_exchange(parts, *, num_workers: int, n_out: int,
                  spec: _Spec | None, label: str,
                  prepare=None, sort_spec=None, plan=None
                  ) -> Callable[[], ShuffleResult]:
    """A memoized exchange runner: the returned callable executes the
    shuffle ONCE, on first call (the lazy + memoized contract every wide
    op keeps), and hands back the same :class:`ShuffleResult` after that.
    ``prepare`` (also deferred to first call) returns the ``sort_route``
    pair for sort mode — it may walk the source (boundary sampling)."""
    memo: dict = {}

    def result() -> ShuffleResult:
        if "r" not in memo:
            memo["r"] = run_exchange(
                parts, num_workers=num_workers, n_out=n_out, spec=spec,
                label=label,
                sort_route=prepare() if prepare is not None else None,
                sort_spec=sort_spec, plan=plan)
        return memo["r"]

    return result


def _lazy_exchange_dataset(parts, *, num_workers: int, n_out: int,
                           spec: _Spec | None, label: str,
                           prepare=None, sort_spec=None, plan=None):
    """A PartitionedDataset whose partitions stream the exchange's bucket
    files (rows); the exchange runs once via :func:`lazy_exchange`. The
    dataframe agg path bypasses this for columnar buckets and reads
    planes directly."""
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

    result = lazy_exchange(
        parts, num_workers=num_workers, n_out=n_out, spec=spec,
        label=label, prepare=prepare, sort_spec=sort_spec, plan=plan)

    def make(bucket: int):
        return lambda: result().iter_bucket(bucket)

    return PartitionedDataset([make(b) for b in range(n_out)])


def reduce_by_key(dataset, f, n_out: int, num_workers: int, *,
                  combine: str | None = None, transport: str | None = None):
    plan = None
    if (combine in NUMERIC_COMBINES
            and resolve_transport(transport) != "tuple"):
        plan = reduce_pair_plan(combine)
    return _lazy_exchange_dataset(
        dataset._parts, num_workers=num_workers, n_out=n_out,
        spec=_reduce_spec(f), label="reduce_by_key", plan=plan)


def group_by_key(dataset, n_out: int, num_workers: int):
    return _lazy_exchange_dataset(
        dataset._parts, num_workers=num_workers, n_out=n_out,
        spec=_group_spec(), label="group_by_key")


def distinct(dataset, num_workers: int, *, transport: str | None = None):
    plan = (distinct_pair_plan()
            if resolve_transport(transport) != "tuple" else None)
    return _lazy_exchange_dataset(
        dataset._parts, num_workers=num_workers,
        n_out=dataset.num_partitions, spec=_distinct_spec(),
        label="distinct", plan=plan)


def _sample_boundaries(parts, key_fn, n_out: int) -> list:
    """Range-partition boundaries for sort_by: a deterministic stride-
    thinned sample of the key stream (every s-th key, s doubling once the
    sample would exceed 8192 entries), quantiled into ``n_out - 1`` cut
    points. One serial pre-pass over the source — cheap next to the sort
    itself, and data-derived, so boundaries are identical at any worker
    count."""
    sample: list = []
    stride, phase = 1, 0
    for p in parts:
        for x in p():
            if phase % stride == 0:
                sample.append(key_fn(x))
                if len(sample) >= 8192:
                    sample = sample[::2]
                    stride *= 2
            phase += 1
    if not sample:
        return []
    sample.sort()
    return [sample[(i + 1) * len(sample) // n_out]
            for i in range(n_out - 1)]


def sort_by(dataset, key_fn, *, ascending: bool, n_out: int,
            num_workers: int):
    """Range-partitioned external sort: sample boundaries, route elements
    to range buckets, external-sort each bucket by ``(key, position)`` so
    equal keys keep encounter order — the same total order the serial
    stable sort emits (partition boundaries fall on sample quantiles
    rather than exact equal splits)."""
    import bisect

    parts = dataset._parts

    def prepare():
        boundaries = ([] if n_out == 1
                      else _sample_boundaries(parts, key_fn, n_out))

        def route(kv) -> int:
            b = bisect.bisect_right(boundaries, kv)
            return (n_out - 1 - b) if not ascending else b

        return (key_fn, route)

    if ascending:
        sort_key = lambda e: (e[0], (e[1], e[2]))  # noqa: E731
    else:
        # reverse=True flips both: key DESC, (-part, -idx) DESC = pos ASC,
        # matching the serial stable sort's equal-key encounter order
        sort_key = lambda e: (e[0], (-e[1], -e[2]))  # noqa: E731
    return _lazy_exchange_dataset(
        dataset._parts, num_workers=num_workers, n_out=n_out, spec=None,
        label="sort_by", prepare=prepare,
        sort_spec=(sort_key, not ascending))


def serial_refusal(op: str, limit: int, what: str = "distinct keys") -> str:
    """The serial-path loud failure, with remediations in priority order:
    the exchange first (the fix that scales), then key bounding, then the
    ceiling knob."""
    return (
        f"{op} exceeded max_groups={limit} {what} on the serial driver-side "
        f"path. Set DLS_DATA_WORKERS=N (or pass num_workers=) to route "
        f"through the distributed shuffle exchange (data/exchange.py), "
        f"which spills to disk under DLS_SHUFFLE_MEM_MB instead of growing "
        f"a driver dict; or hash_bucket/pre-bucket the key to bound the "
        f"result; or raise {MAX_GROUPS_ENV} if the result genuinely fits "
        f"the driver.")

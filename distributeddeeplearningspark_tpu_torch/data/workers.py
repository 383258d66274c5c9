"""Multi-process input-pipeline worker pool: the host-side map, scaled out.

The port's own copy of the JAX package's ``data/workers.py``: the same
pool, the same env knobs (``DLS_DATA_WORKERS``, ``DLS_DATA_WORKER_RING_MB``,
``DLS_DATA_WORKER_MAX_RETRIES``, ``DLS_DATA_WORKER_COPY``), the same
``dlsw-<pid>-...`` shared-memory segment names and the same gauges. The
per-example map (the Spark partitioned map, run on the host) fans out over
``N`` worker *processes*, real cores with no GIL, under three contracts
the rest of the stack depends on:

- **Deterministic, seed-stable ordered delivery.** Worker ``w`` of ``N``
  processes exactly the elements ``j`` with ``j % N == w`` of the source
  stream, and the consumer reassembles ``j = 0, 1, 2, ...`` by round-robin
  over per-worker FIFO queues, so the mapped stream is byte-identical for
  ANY ``num_workers`` (0, the in-process path, included), and the
  Trainer's resume fast-forward stays exact. Augmentation randomness is
  content-seeded per example (:mod:`.vision`), so scheduling cannot change
  a single output byte.
- **Shared-memory delivery, no pickling of array data.** Each worker owns
  an arena of ``multiprocessing.shared_memory`` bytes; its arrays are
  written there and only a small metadata record (key, dtype, shape,
  offset) crosses the queue. The consumer wraps numpy views over the arena
  and :func:`~.feed.stack_examples` copies them into the batch: one copy
  in all. An allocation frees itself when its views are garbage-collected
  (first-fit intervals, so out-of-order frees reclaim at once); when a
  batch is too big to hold as views (``batch_size/num_workers`` × example
  bytes against ``DLS_DATA_WORKER_RING_MB``) the consumer copies and
  releases instead, so the worker never stalls. Backpressure is the arena
  plus a bounded metadata queue: a slow consumer parks the workers, memory
  stays capped. A view must never reach ``torch.from_numpy`` uncopied: the
  worker reuses its bytes once the view is freed.
- **Crash recovery: a dead worker respawns; a raising one propagates.**
  A worker that *dies* (OOM kill, segfault) is found by liveness polling
  and, within the ``DLS_DATA_WORKER_MAX_RETRIES`` budget (default 2),
  replaced in place: a fresh process takes over the same residue class
  with a fresh arena and queues (the dead one's pipe may hold a frame torn
  mid-write), fast-forwarded past the examples already delivered, so
  ordered byte-identical delivery resumes where the stream left off. Each
  respawn writes an ``input-worker-respawn`` ``recovery`` event through the
  process-wide telemetry writer. Past the budget, or when a worker
  *raises* (deterministic on this input: a retry would raise again), the
  consumer raises a typed :class:`WorkerCrashed` within a bounded wait,
  and it propagates out of ``Trainer.fit`` like any training error. A
  worker that is alive but *silent*, whose next record the consumer has
  waited ``_RESULT_TIMEOUT_S`` for (120 s, far past any one example's
  map), counts as dead: it is killed and respawned within
  the same budget, past which :class:`WorkerCrashed` is raised. So the
  consumer never waits on a child for good.

Workers start with the ``fork`` start method: the map ``fn`` and the source
partition are closures (lambdas over tokenizers and transform settings)
that fork inherits and spawn could not pickle. **Children run numpy and
plain Python only, never torch**, as torch's own DataLoader asks of its
workers: a pool may fork while the parent's main thread drives CUDA (and,
in a gang, NCCL) and after torch's intra-op OpenMP pool has started, and a
torch call in such a child can hang on a lock or thread that fork did not
copy. The child inherits no CUDA work and makes none. Nor does it collect
the parent's garbage: the parent freezes its objects (``gc.freeze``) for
the fork, so a cycle the parent had not collected yet, holding an object
whose finalizer takes a lock of a parent thread (a JAX array's buffer, a
torch handle), is never finalized in a child, where that lock may be held
for good. Where fork is unavailable the pool degrades to the serial
in-process map with a one-time warning: the same bytes, no speedup.

Each worker re-iterates its partition's *source* and maps only its residue
class: no input pickling, no dispatcher thread. That repeats the source
walk ``k``× per partition, the right trade while the map outweighs the
walk. Where the walk is the expensive part (a synthetic source drawing
every example), split the source into as many partitions as workers:
:func:`_split_budget` then gives each partition a worker of its own, which
walks that partition alone.

Sizing: a 224² float32 image is ~600 KB; the default 32 MB ring per worker
holds ~50 in-flight examples, and tmpfs allocates pages only when
touched. An example that cannot get ring space within a bounded wait
(consumer holding too many views, or bigger than the whole ring) falls
back to queue transport (pickled, slower, counted in the ``overflow``
gauge), so liveness never depends on ring capacity. At ``local[N]`` every
rank forks its own ``DLS_DATA_WORKERS`` workers: the budget is per rank.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import multiprocessing as mp
import os
import queue as queue_lib
import time
import traceback
import uuid
import warnings
import weakref
from multiprocessing import shared_memory
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

#: env knob: default worker count when ``num_workers=None`` (0 = in-process).
WORKERS_ENV = "DLS_DATA_WORKERS"
#: env knob: shared-memory ring size per worker, in MB.
RING_MB_ENV = "DLS_DATA_WORKER_RING_MB"
#: env knob: how many SIGKILL'd workers one pool may respawn before a
#: death escalates to the typed WorkerCrashed (0 = today's fail-fast).
INPUT_RETRIES_ENV = "DLS_DATA_WORKER_MAX_RETRIES"
_DEFAULT_INPUT_RETRIES = 2
#: seconds the consumer waits on a live worker's next record before it
#: counts the worker as dead (killed, then respawned or raised)
_RESULT_TIMEOUT_S = 120.0

_DEFAULT_RING_MB = 32
#: metadata-queue bound = max mapped examples in flight per worker beyond
#: the ring — the item-count half of the backpressure contract; more
#: lookahead just bloats the ring/queue.
_DEFAULT_MAX_AHEAD = 32
#: arrays below this ride the metadata queue (labels, scalars); at/above it
#: they go through shared memory (image/token planes).
_SHM_MIN_BYTES = 256
_ALIGN = 64
#: how long a worker waits for ring space before the pickle fallback. Kept
#: short: frees arrive in bulk at batch boundaries (the feed clears its
#: example refs before refilling), so mid-batch fullness means the ring is
#: genuinely undersized for batch_size/num_workers and queue transport
#: (one extra memcpy-scale pickle) beats stalling.
_ALLOC_WAIT_S = 0.25
#: consumer liveness-poll interval while waiting on a worker queue.
_POLL_S = 0.2

# stats array layout (one float64 stride per worker, single-writer cells:
# the worker owns all four, the consumer only reads)
_ST_BUSY, _ST_PRODUCED, _ST_OVERFLOW, _ST_RING_USED, _ST_STRIDE = 0, 1, 2, 3, 4

#: transport wrapper for non-dict map results (token arrays, scalars).
_VALUE_KEY = "__dls_pool_value__"

#: live pools, for telemetry aggregation (prefetch.StarvationProbe.snapshot
#: merges pool_gauges() so dlstatus can tell pool-bound from consumer-bound).
_LIVE_POOLS: "weakref.WeakSet[WorkerPool]" = weakref.WeakSet()


def resolve_num_workers(num_workers: int | None) -> int:
    """Explicit value wins; ``None`` reads ``DLS_DATA_WORKERS`` (default 0 =
    today's in-process path, unchanged)."""
    if num_workers is not None:
        return max(0, int(num_workers))
    try:
        return max(0, int(os.environ.get(WORKERS_ENV, "0") or 0))
    except ValueError:
        warnings.warn(f"ignoring non-integer {WORKERS_ENV}="
                      f"{os.environ.get(WORKERS_ENV)!r}")
        return 0


def _ring_bytes(override: int | None) -> int:
    if override is not None:
        return max(1 << 20, int(override))
    try:
        mb = float(os.environ.get(RING_MB_ENV, "") or _DEFAULT_RING_MB)
    except ValueError:
        mb = _DEFAULT_RING_MB
    return max(1 << 20, int(mb * (1 << 20)))


def fork_available() -> bool:
    return "fork" in mp.get_all_start_methods()


def env_num(name: str, default, lo=None, cast=int):
    """The env-knob parse contract: empty or malformed values fall back to
    the default silently (a tuning knob must never crash a run), and
    ``lo`` clamps the floor."""
    try:
        v = cast(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    return v if lo is None else max(lo, v)


def input_worker_retries(explicit: int | None = None) -> int:
    """The pool's respawn budget: explicit value, else
    ``DLS_DATA_WORKER_MAX_RETRIES``, else 2."""
    if explicit is not None:
        return max(0, int(explicit))
    return env_num(INPUT_RETRIES_ENV, _DEFAULT_INPUT_RETRIES, lo=0)


class WorkerCrashed(RuntimeError):
    """A pool worker raised or died. Typed so the consumer (and a
    supervisor behind it) can tell "the input pipeline crashed" from a
    hang: the error surfaces in the training process within a bounded
    wait and exits it nonzero, a training crash, never silence."""

    def __init__(self, message: str, *, worker: int, exitcode: int | None = None):
        super().__init__(message)
        self.worker = worker
        self.exitcode = exitcode


@contextlib.contextmanager
def _forking():
    """Around a worker's fork: the parent's objects frozen out of the
    collector (the child then never finalizes them: see the module
    docstring), and the warnings that a fork from a multi-threaded parent
    raises (Python's DeprecationWarning; JAX's RuntimeWarning where JAX is
    loaded beside the port) silenced, since the child runs numpy and plain
    Python only and never waits on a thread or lock of the parent's."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=r".*os\.fork\(\) was called.*",
            category=RuntimeWarning)
        warnings.filterwarnings(
            "ignore", message=r".*multi-threaded, use of fork\(\).*",
            category=DeprecationWarning)
        gc.freeze()
        try:
            yield
        finally:
            gc.unfreeze()


def _safe_put(q, item) -> None:
    """free-queue put from GC/finalizer context: at interpreter shutdown the
    queue's feeder may already be gone — releasing a ring slot then is moot
    (the pool is dying too), so never let it raise."""
    try:
        q.put_nowait(item)
    except Exception:  # noqa: BLE001 — shutdown races only
        pass


def _release(free_q, alloc_id, counter, nbytes) -> None:
    _safe_put(free_q, alloc_id)
    counter[0] -= nbytes


class _ReleaseToken:
    """One per shm-transported example; frees its ring allocation (and the
    parent-side outstanding-bytes counter) when the last view dies — or
    explicitly, in copy mode. Finalizers run in the parent, so the counter
    is an accurate live view of how many ring bytes the consumer holds."""

    __slots__ = ("_fin", "__weakref__")

    def __init__(self, free_q, alloc_id: int, counter: list, nbytes: int):
        self._fin = weakref.finalize(
            self, _release, free_q, alloc_id, counter, nbytes)

    def release(self) -> None:
        self._fin()


class _ShmArray(np.ndarray):
    """ndarray view into a pool ring; carries the release token so the slot
    frees itself when the (last) view is garbage-collected."""

    _dls_token: Any = None


class _Arena:
    """Worker-side byte arena over the shm slab, with OUT-OF-ORDER free.

    The consumer frees allocations by id in whatever order its views die —
    and the hold pattern is adversarial for FIFO reclaim: a batch's
    *first* examples are held as views until the batch stacks, so a ring
    that can only reclaim from the tail wedges full behind them for the
    whole batch (measured: 80% of a 256-batch fell to pickle overflow).
    So: first-fit over a sorted free-interval list with coalescing. Hole
    count stays tiny (≈ the handful of concurrently-held views), keeping
    the scan O(few).
    """

    def __init__(self, size: int):
        self.size = size
        self.used = 0
        self._free: list[list[int]] = [[0, size]]  # sorted disjoint [s, e)
        self._live: dict[int, tuple[int, int]] = {}

    def free(self, alloc_id: int) -> None:
        iv = self._live.pop(alloc_id, None)
        if iv is None:
            return
        s, e = iv
        self.used -= e - s
        i = bisect.bisect_left(self._free, [s, e])
        # coalesce with the right then the left neighbor
        if i < len(self._free) and self._free[i][0] == e:
            self._free[i][0] = s
        else:
            self._free.insert(i, [s, e])
        if i > 0 and self._free[i - 1][1] == self._free[i][0]:
            self._free[i - 1][1] = self._free[i][1]
            del self._free[i]

    def try_alloc(self, alloc_id: int, need: int) -> int | None:
        """Offset for ``need`` bytes, or None (full / fragmented)."""
        if need <= 0 or need > self.size:
            return None
        for i, iv in enumerate(self._free):
            s, e = iv
            if e - s >= need:
                self._live[alloc_id] = (s, s + need)
                self.used += need
                if e - s == need:
                    del self._free[i]
                else:
                    iv[0] = s + need
                return s
        return None


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _worker_loop(wid: int, num_workers: int, source_factory, fn,
                 shm, out_q, free_q, stats, stop_evt, skip: int = 0) -> None:
    """Child body (fork-inherited state): iterate the source, map this
    worker's residue class, publish through the ring + metadata queue.
    ``skip`` fast-forwards a respawned replacement past the first ``skip``
    class elements the consumer already received — the source walk still
    happens (cheap, page-cached) but the map and the transport don't."""
    # the native kernels' fan-out to one thread a call: the processes are
    # the parallelism, and W workers each spawning a thread a core would
    # oversubscribe the host W times. Set whatever the parent's value: that
    # one tunes the parent's own calls.
    os.environ["DLS_NATIVE_THREADS"] = "1"
    ring = _Arena(shm.size)
    buf = shm.buf
    base = wid * _ST_STRIDE
    alloc_id = 0

    def put(rec) -> bool:
        while not stop_evt.is_set():
            try:
                out_q.put(rec, timeout=_POLL_S)
                return True
            except queue_lib.Full:
                continue
        return False

    starved = [False]  # last alloc timed out and no free has arrived since

    def alloc(need: int) -> int | None:
        # while starved, don't re-pay the wait per example — the consumer
        # is holding views (or the ring is undersized for this batch
        # size), so degrade to queue transport IMMEDIATELY until a free
        # arrives; per-example waits here once turned an undersized ring
        # into a 10× throughput collapse instead of a few % of pickling
        deadline = time.perf_counter() + _ALLOC_WAIT_S
        while True:
            got_free = False
            try:  # drain frees accumulated since the last allocation
                while True:
                    ring.free(free_q.get_nowait())
                    got_free = True
            except queue_lib.Empty:
                pass
            if got_free:
                starved[0] = False
            off = ring.try_alloc(alloc_id, need)
            if off is not None or need > ring.size:
                return off
            if (stop_evt.is_set() or starved[0]
                    or time.perf_counter() > deadline):
                starved[0] = True
                return None
            try:
                ring.free(free_q.get(timeout=_POLL_S))
                starved[0] = False
            except queue_lib.Empty:
                pass

    try:
        ci = -1  # this worker's class-element ordinal, for skip
        for j, item in enumerate(source_factory()):
            if stop_evt.is_set():
                return
            if j % num_workers != wid:
                continue
            ci += 1
            if ci < skip:
                continue
            t0 = time.perf_counter()
            ex = fn(item) if fn is not None else item
            stats[base + _ST_BUSY] += time.perf_counter() - t0
            if not isinstance(ex, dict):
                # non-dict results (token arrays, scalars) ride the same
                # transport under a wrapper key the consumer unwraps
                ex = {_VALUE_KEY: ex}
            planes = [(k, np.ascontiguousarray(v)) for k, v in ex.items()
                      if isinstance(v, np.ndarray)
                      and not v.dtype.hasobject  # object arrays can't be
                      and v.nbytes >= _SHM_MIN_BYTES]  # raw-byte views
            shm_keys = {k for k, _ in planes}
            inline = {k: v for k, v in ex.items() if k not in shm_keys}
            need = sum(_align(a.nbytes) for _, a in planes)
            off = alloc(need) if planes else None
            if planes and off is None:
                # ring full past the wait (or example > ring): queue
                # transport keeps liveness; the overflow gauge tells you
                # to raise DLS_DATA_WORKER_RING_MB
                stats[base + _ST_OVERFLOW] += 1
                if not put(("pkl", j, ex)):
                    return
            elif planes:
                metas = []
                rel = 0
                for k, a in planes:
                    dst = np.frombuffer(buf, dtype=a.dtype, count=a.size,
                                        offset=off + rel).reshape(a.shape)
                    np.copyto(dst, a)
                    metas.append((k, a.dtype.str, a.shape, off + rel))
                    rel += _align(a.nbytes)
                if not put(("shm", j, alloc_id, metas, inline)):
                    return
                alloc_id += 1
            else:
                if not put(("pkl", j, ex)):
                    return
            stats[base + _ST_PRODUCED] += 1
            stats[base + _ST_RING_USED] = ring.used
        put(("end", wid, None))
    except BaseException:  # noqa: BLE001 — forward ANY failure, typed
        put(("err", wid, traceback.format_exc()))


class WorkerPool:
    """``N`` forked processes mapping one ordered source stream.

    ``source_factory``: zero-arg callable returning the source iterable —
    opened *inside each worker* (post-fork), never iterated in the parent.
    ``fn``: the per-example map (None = identity). :meth:`stream` yields
    ``fn(element)`` in exact source order; see the module docstring for the
    determinism / shared-memory / crash contracts.

    Single-use: one :meth:`stream` pass, then the pool is closed (the
    stream's ``finally`` does it; :func:`weakref.finalize` and the daemon
    flag are the backstops, so interpreter exit leaks neither processes
    nor shared-memory segments).
    """

    def __init__(self, source_factory: Callable[[], Iterable[Any]],
                 fn: Callable[[Any], Any] | None, num_workers: int, *,
                 ring_bytes: int | None = None, max_ahead: int | None = None,
                 copy: bool = False, label: str = "",
                 max_retries: int | None = None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if not fork_available():  # pragma: no cover - platform-dependent
            raise RuntimeError(
                "WorkerPool needs the 'fork' start method (the map fn and "
                "source are closures spawn cannot pickle); use num_workers=0")
        self.n = num_workers
        self.label = label
        self._copy = copy or bool(os.environ.get("DLS_DATA_WORKER_COPY"))
        self._t0 = time.perf_counter()
        self._consumed = [0] * num_workers
        #: per-worker ring bytes the consumer currently holds as live
        #: views (one-element lists so release finalizers can decrement)
        self._outstanding = [[0] for _ in range(num_workers)]
        self._closed = False
        self._source_factory = source_factory
        self._fn = fn
        self._respawns_left = input_worker_retries(max_retries)
        self._result_timeout = _RESULT_TIMEOUT_S
        ctx = mp.get_context("fork")
        rb = _ring_bytes(ring_bytes)
        self._ring_bytes = rb
        self._ahead = (max_ahead if max_ahead is not None
                       else _DEFAULT_MAX_AHEAD)
        self._stats = ctx.RawArray("d", num_workers * _ST_STRIDE)
        self._stop = ctx.Event()
        self._shms = [shared_memory.SharedMemory(
            create=True, size=rb,
            name=f"dlsw-{os.getpid()}-{uuid.uuid4().hex[:8]}-{w}")
            for w in range(num_workers)]
        self._out_qs = [ctx.Queue(maxsize=max(2, self._ahead))
                        for _ in range(num_workers)]
        self._free_qs = [ctx.Queue() for _ in range(num_workers)]
        self._retired_qs: list = []   # pre-respawn queues, closed at close()
        self._procs = [
            ctx.Process(
                target=_worker_loop, daemon=True, name=f"dls-worker-{w}",
                args=(w, num_workers, source_factory, fn, self._shms[w],
                      self._out_qs[w], self._free_qs[w], self._stats,
                      self._stop))
            for w in range(num_workers)]
        with _forking():
            for p in self._procs:
                p.start()
        # LIVE lists shared with the finalizer: respawned workers and
        # their fresh arenas append here, so interpreter-exit teardown
        # reaps them too — not just the children alive at registration
        self._all_procs = list(self._procs)
        self._all_shms = list(self._shms)
        self._finalizer = weakref.finalize(
            self, WorkerPool._cleanup, self._stop, self._all_procs,
            self._all_shms)
        _LIVE_POOLS.add(self)

    # -- consumer side ------------------------------------------------------

    def stream(self) -> Iterator[Any]:
        """The mapped stream, in exact source order. Closes the pool on
        exhaustion, on error, and on generator close."""
        try:
            j = 0
            while True:
                w = j % self.n
                rec = self._next_record(w)
                kind = rec[0]
                if kind == "end":
                    # worker (j % n) exhausted ⇒ the source has ≤ j elements
                    # ⇒ no worker holds an element ≥ j: the stream is done.
                    return
                if kind == "err":
                    raise WorkerCrashed(
                        f"input worker {rec[1]} raised:\n{rec[2]}",
                        worker=rec[1])
                yield self._materialize(w, rec)
                self._consumed[w] += 1
                j += 1
        finally:
            self.close()

    def _next_record(self, w: int):
        waited_since = time.monotonic()
        silent = False
        while True:
            q = self._out_qs[w]
            try:
                return q.get(timeout=_POLL_S)
            except queue_lib.Empty:
                silent = (time.monotonic() - waited_since > self._result_timeout)
                if self._procs[w].is_alive() and not silent:
                    continue
            except Exception:  # noqa: BLE001 — a frame the dying feeder
                # tore mid-write surfacing on the PRIMARY get (unpickle/
                # EOF error). Survivable only when the producer is dead:
                # a live worker handing up garbage is a real bug. (A tear
                # that splits the frame HEADER can still wedge recv
                # inside this get.)
                if self._procs[w].is_alive():
                    raise
            try:  # drain race: a whole record may have landed meanwhile
                return q.get_nowait()
            except queue_lib.Empty:
                pass
            except Exception:  # noqa: BLE001 — the torn frame again
                pass
            if silent and self._procs[w].is_alive():
                # alive, but nothing for the whole deadline: stuck (a lock
                # fork copied held, say); it counts as dead
                self._procs[w].kill()
                self._procs[w].join(timeout=5.0)
            rc = self._procs[w].exitcode
            why = (f"was alive but sent nothing for {self._result_timeout:g} s "
                   f"and was killed" if silent else
                   f"died (exit code {rc}) without reporting an error — "
                   f"killed (OOM/SIGKILL) or crashed in native code")
            if self._respawns_left > 0:
                self._respawn(w, rc, silent=silent)
                waited_since = time.monotonic()
                silent = False
                continue
            raise WorkerCrashed(
                f"input worker {w} {why} (respawn budget "
                f"{INPUT_RETRIES_ENV} exhausted)", worker=w,
                exitcode=rc) from None

    def _respawn(self, w: int, exitcode: int | None, *, silent: bool = False) -> None:
        """Replace a dead worker in place: fresh arena and
        queues — the dead worker's pipe may hold a frame its feeder tore
        mid-write, and in-flight examples regenerate deterministically —
        same residue class, fast-forwarded past the ``consumed[w]``
        examples already delivered, so ordered byte-identical delivery
        resumes exactly where the stream left off."""
        self._respawns_left -= 1
        writer = telemetry.get()
        if writer is not None:
            writer.recovery(None, "input-worker-respawn", worker=w,
                            exitcode=exitcode, silent=silent,
                            skipped=self._consumed[w],
                            respawns_left=self._respawns_left,
                            label=self.label or None)
        ctx = mp.get_context("fork")
        shm = shared_memory.SharedMemory(
            create=True, size=self._ring_bytes,
            name=f"dlsw-{os.getpid()}-{uuid.uuid4().hex[:8]}-{w}")
        out_q = ctx.Queue(maxsize=max(2, self._ahead))
        free_q = ctx.Queue()
        # rebase the (single-writer, but its writer is dead) produced cell
        # on what the consumer actually took, so `ahead` stays truthful
        self._stats[w * _ST_STRIDE + _ST_PRODUCED] = self._consumed[w]
        self._stats[w * _ST_STRIDE + _ST_RING_USED] = 0
        p = ctx.Process(
            target=_worker_loop, daemon=True, name=f"dls-worker-{w}",
            args=(w, self.n, self._source_factory, self._fn, shm, out_q,
                  free_q, self._stats, self._stop, self._consumed[w]))
        with _forking():
            p.start()
        self._retired_qs.extend((self._out_qs[w], self._free_qs[w]))
        # old arena stays in _all_shms for unlink at close; views the
        # consumer still holds keep its pages alive until they die
        self._shms[w] = shm
        self._out_qs[w] = out_q
        self._free_qs[w] = free_q
        self._outstanding[w] = [0]  # old tokens decrement their own list
        self._procs[w] = p
        self._all_procs.append(p)
        self._all_shms.append(shm)

    def _materialize(self, w: int, rec) -> Any:
        if rec[0] == "pkl":
            ex = rec[2]
            return ex[_VALUE_KEY] if (isinstance(ex, dict)
                                      and _VALUE_KEY in ex) else ex
        _, _j, alloc_id, metas, inline = rec
        ex = dict(inline)
        buf = self._shms[w].buf
        ex_bytes = sum(
            int(np.prod(shape, dtype=np.int64) if shape else 1)
            * np.dtype(dstr).itemsize for _k, dstr, shape, _o in metas)
        # adaptive assembly: hand out views while the consumer's held
        # bytes fit the ring; once a batch would out-hold it (large
        # batch_size / num_workers vs DLS_DATA_WORKER_RING_MB), copy-and-
        # release instead — one memcpy, but the worker keeps streaming
        # through the ring rather than stalling into pickle overflow
        # hold at most a quarter of the ring as live views — the rest must
        # stay available as streaming room for the worker's lookahead, or
        # the worker starves into pickle overflow exactly when batches are
        # big (the case the adaptive copy exists for)
        counter = self._outstanding[w]
        copy = self._copy or (counter[0] + ex_bytes
                              > 0.25 * self._ring_bytes)
        token = _ReleaseToken(self._free_qs[w], alloc_id, counter,
                              0 if copy else ex_bytes)
        if not copy:
            counter[0] += ex_bytes
        for key, dstr, shape, off in metas:
            dt = np.dtype(dstr)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            view = np.frombuffer(buf, dtype=dt, count=count,
                                 offset=off).reshape(shape)
            if copy:
                ex[key] = view.copy()
            else:
                arr = view.view(_ShmArray)
                arr._dls_token = token
                ex[key] = arr
        if copy:
            token.release()
        if len(ex) == 1 and _VALUE_KEY in ex:
            return ex[_VALUE_KEY]
        return ex

    # -- observability ------------------------------------------------------

    def gauges(self) -> dict:
        """Per-worker utilization/queue-depth gauges (pool-lifetime)."""
        wall = max(time.perf_counter() - self._t0, 1e-9)
        per = []
        for w in range(self.n):
            b = w * _ST_STRIDE
            produced = int(self._stats[b + _ST_PRODUCED])
            per.append({
                "util": min(1.0, self._stats[b + _ST_BUSY] / wall),
                "items": produced,
                "overflow": int(self._stats[b + _ST_OVERFLOW]),
                "ring_used_bytes": int(self._stats[b + _ST_RING_USED]),
                "ahead": produced - self._consumed[w],
            })
        return {"workers": self.n, "label": self.label, "wall_s": wall,
                "per_worker": per}

    # -- lifecycle ----------------------------------------------------------

    @staticmethod
    def _cleanup(stop, procs, shms) -> None:
        """Idempotent teardown, callable from finalize/atexit context."""
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
            except BufferError:
                # consumer still holds views into the mapping: detach so
                # __del__ doesn't retry-and-whine — the name is already
                # unlinked above, the pages die with the last view
                s._buf = None
                s._mmap = None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finalizer.detach()
        WorkerPool._cleanup(self._stop, self._all_procs, self._all_shms)
        for q in (*self._out_qs, *self._free_qs, *self._retired_qs):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:  # noqa: BLE001 — best-effort queue teardown
                pass


def pool_gauges() -> dict:
    """Aggregate gauges over every live pool, keyed for the telemetry
    step_metrics record (merged by ``StarvationProbe.snapshot``). Empty dict
    when no pool is running, so the non-worker path emits nothing new."""
    pools = [p for p in list(_LIVE_POOLS) if not p._closed]
    per = [g for p in pools for g in p.gauges()["per_worker"]]
    if not per:
        return {}
    utils = [g["util"] for g in per]
    return {
        "input_workers": len(per),
        "worker_util_mean": round(sum(utils) / len(per), 4),
        "worker_util_min": round(min(utils), 4),
        "worker_items": int(sum(g["items"] for g in per)),
        "worker_overflow": int(sum(g["overflow"] for g in per)),
        "worker_ahead_mean": round(
            sum(g["ahead"] for g in per) / len(per), 2),
        "worker_ring_used_mb": round(
            sum(g["ring_used_bytes"] for g in per) / 1e6, 2),
    }


def _split_budget(total: int, num_partitions: int, index: int) -> int:
    """Workers for partition ``index`` out of a ``total`` budget.

    Rounded UP to at least one per partition once enabled: a partition left
    serial would map on the consumer thread and gate the whole
    round-robin interleave. So the effective floor is one process per
    partition; budgets beyond that spread round-robin. Bytes are
    identical regardless of the split.
    """
    if total <= 0:
        return 0
    k, rem = divmod(total, num_partitions)
    return max(1, k + (1 if index < rem else 0))


class WorkerMappedDataset(PartitionedDataset):
    """A ``map`` whose execution fans out over a process pool per partition.

    Behaves exactly like ``base.map(fn)`` — same partitions, same element
    order, same bytes — but each partition's iterator, when opened, starts
    its share of the ``num_workers`` budget as a :class:`WorkerPool`
    (closed when the iterator is). ``num_workers=None`` defers to
    ``DLS_DATA_WORKERS`` at iteration time; resolved 0 (or no fork) is the
    plain serial map. The feed layer (:func:`.feed.host_batches`) can
    override the count via its ``num_workers=`` knob →
    :meth:`with_num_workers`.
    """

    def __init__(self, base: PartitionedDataset, fn: Callable[[Any], Any],
                 num_workers: int | None = None, *,
                 ring_bytes: int | None = None, max_ahead: int | None = None,
                 label: str = ""):
        self.base = base
        self.fn = fn
        self.num_workers = num_workers
        self._ring_bytes = ring_bytes
        self._max_ahead = max_ahead
        self._label = label
        P = base.num_partitions
        warned: list[bool] = []

        def make(i: int):
            src = base._parts[i]

            def gen() -> Iterator[Any]:
                k = _split_budget(resolve_num_workers(self.num_workers), P, i)
                if k > 0 and not fork_available():  # pragma: no cover
                    if not warned:
                        warned.append(True)
                        warnings.warn(
                            "DLS_DATA_WORKERS requested but the 'fork' start "
                            "method is unavailable; using the in-process map")
                    k = 0
                if k <= 0:
                    return map(fn, src())
                pool = WorkerPool(src, fn, k, ring_bytes=self._ring_bytes,
                                  max_ahead=self._max_ahead,
                                  label=label or f"part{i}")
                return pool.stream()

            return gen

        super().__init__([make(i) for i in range(P)],
                         infinite=base.is_infinite)

    def with_num_workers(self, num_workers: int | None
                         ) -> "WorkerMappedDataset":
        return WorkerMappedDataset(
            self.base, self.fn, num_workers, ring_bytes=self._ring_bytes,
            max_ahead=self._max_ahead, label=self._label)

"""Device prefetch and the starvation probe: the port of ``data/prefetch.py``.

:func:`prefetch_to_device` runs a host-batch iterator in a background
thread (``dls-prefetch``) through a bounded ring, so the host's assembly
of batch N+1 (tokenize, augment, stack) overlaps step N. On CUDA the thread
also pins each batch and issues its copy to the card on a copy stream of
its own, recording an event; the consumer's stream waits on that event
before it uses the batch, and the batch's tensors are recorded on the
consumer's stream, so the allocator keeps them until the step that reads
them has run. The loop's thread never copies. On the CPU the put is the
identity (:func:`~.feed.to_device`).

The thread overlaps the step only with work that frees the interpreter
lock: waits on a worker pool's queues, copies of large arrays, pinning.
Python it runs (packing, masking, a source drawn in Python) holds the
lock against the loop, which releases and retakes it at every op it
dispatches, so such a feed runs no faster in the thread than in the loop
and can run slower; its heavy work belongs in the worker processes
(:mod:`.workers`).

Closing the consumer's generator (``fit`` leaves its loop at ``steps``)
stops the producer: a stop event, puts that wait with a timeout, the host
iterator closed inside the thread (so a :class:`~.workers.WorkerPool`
reaps its workers and unlinks its segments), and the thread joined.

**Starvation probe.** An input-bound step and a compute-bound step look the
same on the wall clock; the difference is whether the *consumer* had to
block for the next batch. :class:`StarvationProbe` measures that (and the
ring's depth and the host's assembly time); the Trainer snapshots it into
each lap's ``step_metrics`` record, which the JAX package's ``dlstatus``
reads.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Iterator

import torch

from distributeddeeplearningspark_tpu_torch.data import workers
from distributeddeeplearningspark_tpu_torch.data.feed import to_device

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.prefetch")

_SENTINEL = object()
#: how often a blocked producer put or consumer get looks up from its wait
#: (at the stop event, at the other side's thread)
_POLL_S = 0.1
#: how long closing the stream waits for the producer to finish the host
#: batch it is assembling
_JOIN_S = 120.0


class StarvationProbe:
    """Thread-safe counters for "how long did training wait on input?".

    Three signals, all cheap:

    - ``record_wait``: consumer-side block, the training loop asked for the
      next batch and the prefetch ring had nothing ready. This is the
      starvation signal proper (it sums into ``input_starved_s``).
    - ``record_depth``: the ring's depth sampled at each consumer get; a
      ring that is persistently empty (min 0, mean ≈ 0) is input-bound,
      one that hovers full is compute-bound.
    - ``record_assembly``: the producer-side cost of building one host
      batch, measured in the background thread; tells you WHY the ring ran
      dry.

    ``clock`` is injectable so tests measure deterministic fake seconds.
    ``snapshot(reset=True)`` returns and clears, giving per-lap gauges.
    """

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self._wait_s = 0.0
        self._waits = 0
        self._wait_max = 0.0
        self._assembly_s = 0.0
        self._assemblies = 0
        self._depth_sum = 0
        self._depth_n = 0
        self._depth_min: int | None = None

    def record_wait(self, dt: float) -> None:
        with self._lock:
            self._wait_s += dt
            self._waits += 1
            self._wait_max = max(self._wait_max, dt)

    def record_assembly(self, dt: float) -> None:
        with self._lock:
            self._assembly_s += dt
            self._assemblies += 1

    def record_depth(self, depth: int) -> None:
        with self._lock:
            self._depth_sum += depth
            self._depth_n += 1
            self._depth_min = (depth if self._depth_min is None
                               else min(self._depth_min, depth))

    def timed(self, it, record=None) -> Iterator:
        """Wrap an iterable so each blocking ``next()`` is timed into
        ``record`` (default: :meth:`record_wait`). Closing the wrapper
        closes the wrapped iterator."""
        record = record or self.record_wait
        it = iter(it)
        try:
            while True:
                t0 = self.clock()
                try:
                    x = next(it)
                except StopIteration:
                    return
                record(self.clock() - t0)
                yield x
        finally:
            _close(it)

    def snapshot(self, *, reset: bool = True) -> dict[str, float]:
        """Gauges since the last snapshot, keyed for the telemetry record.

        While a :mod:`.workers` pool is live its rollup rides along
        (``input_workers``, ``worker_util_mean/min``, ``worker_items``,
        ``worker_overflow``, ``worker_ahead_mean``, ``worker_ring_used_mb``),
        so ``dlstatus`` can tell pool-bound input (util ≈ 1 while the
        consumer still waits) from consumer-bound input (util low, waits
        low). Worker utilizations are pool-lifetime fractions; the wait and
        assembly keys are per lap."""
        with self._lock:
            out = {
                "input_wait_s": self._wait_s,
                "input_waits": self._waits,
                "input_wait_max_s": self._wait_max,
                "input_assembly_s": self._assembly_s,
            }
            if self._depth_n:
                out["prefetch_depth_mean"] = self._depth_sum / self._depth_n
                out["prefetch_depth_min"] = self._depth_min
            if reset:
                self._zero()
        out.update(workers.pool_gauges())
        return out


def prefetch_to_device(
    host_iter: Iterator[dict[str, Any]],
    device: torch.device | str,
    *,
    buffer_size: int = 2,
    background: bool = True,
    probe: StarvationProbe | None = None,
) -> Iterator[dict[str, torch.Tensor]]:
    """Host batches → batches on ``device``, ``buffer_size`` of them built
    and (on CUDA) copied ahead of the consumer in a background thread.

    ``probe`` times the consumer's wait for each batch and samples the
    ring's depth; the producer's assembly time goes into it too.
    ``background=False`` builds and puts each batch in the caller's thread
    when it is asked for (the probe then times that assembly as the wait).
    The stream the caller sees is the host iterator's, in order; an error
    in the producer is raised in the consumer."""
    device = torch.device(device)
    if not background:
        hb = probe.timed(host_iter) if probe is not None else host_iter
        try:
            for batch in hb:
                yield to_device(batch, device)
        finally:
            _close(hb)
        return

    ring: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    # the thread takes the only reference to the host iterator, so that
    # closing it there reaps what the iterator holds (worker pools)
    source = [host_iter]
    del host_iter
    thread = threading.Thread(
        target=_produce, name="dls-prefetch", daemon=True,
        args=(source, device, copy_stream, ring, stop, probe))
    thread.start()
    try:
        while True:
            if probe is not None:
                probe.record_depth(ring.qsize())
            t0 = time.perf_counter()
            item = _get(ring, thread)
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.error
            if probe is not None:
                probe.record_wait(time.perf_counter() - t0)
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch.values():
                    t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        _drain(ring)
        thread.join(_JOIN_S)
        if thread.is_alive():
            logger.warning("the prefetch thread did not end within %.0f s of "
                           "the stream's close: its host iterator is stuck",
                           _JOIN_S)


class _Failure:
    """An exception of the producer, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


def _produce(source: list, device: torch.device, copy_stream, ring: queue.Queue,
             stop: threading.Event, probe: StarvationProbe | None) -> None:
    """The ``dls-prefetch`` thread: assemble, pin and copy each batch, put
    it on the ring; at the end (exhausted, failed or stopped) close the
    host iterator here and put the sentinel."""
    it = source.pop()
    if probe is not None:
        it = probe.timed(it, probe.record_assembly)
    end: Any = _SENTINEL
    try:
        while not stop.is_set():
            try:
                host = next(it)
            except StopIteration:
                break
            if copy_stream is None:
                item = (to_device(host, device), None)
            else:
                with torch.cuda.stream(copy_stream):
                    batch = to_device(host, device)
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                item = (batch, ready)
            del host
            _put(ring, item, stop)
    except BaseException as e:  # noqa: BLE001 — raised again in the consumer
        end = _Failure(e)
    finally:
        try:
            _close(it)
        except Exception:  # noqa: BLE001 — the stream's own end wins
            logger.exception("closing the prefetched host iterator failed")
        _put(ring, end, stop)


def _close(it) -> None:
    """Close a generator (its ``finally`` blocks run now, in this thread);
    a plain iterator has nothing to close."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def _put(ring: queue.Queue, item, stop: threading.Event) -> None:
    """Put ``item`` on the ring unless the consumer stops first."""
    while not stop.is_set():
        try:
            ring.put(item, timeout=_POLL_S)
            return
        except queue.Full:
            continue


def _get(ring: queue.Queue, thread: threading.Thread):
    """The next item; raises if the producer thread ended without one."""
    while True:
        try:
            return ring.get(timeout=_POLL_S)
        except queue.Empty:
            if thread.is_alive():
                continue
        try:
            return ring.get_nowait()
        except queue.Empty:
            raise RuntimeError("the prefetch thread ended without putting "
                               "its end on the ring") from None


def _drain(ring: queue.Queue) -> None:
    try:
        while True:
            ring.get_nowait()
    except queue.Empty:
        pass

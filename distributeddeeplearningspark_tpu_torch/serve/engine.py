"""Dynamic micro-batching request engine — the port of
``distributeddeeplearningspark_tpu/serve/engine.py``.

Concurrent requests wait in a bounded queue for at most ``max_wait_ms`` (or
until ``max_batch`` are waiting), are stacked into one host batch, padded
with copies of row 0 up to the smallest **bucket** of a fixed ladder, and
run through one forward on the device. The bucket ladder keeps the set of
batch shapes the device sees small and fixed, whatever the arrival counts;
``stats()["compiled_batch_shapes"]`` counts the distinct shapes run.

Params are an argument, not a constant: the forward is ``f(params, batch)``
(:meth:`InferenceEngine.for_model` calls the module through
``torch.func.functional_call`` under ``torch.inference_mode()``), so
:meth:`~InferenceEngine.swap_params` replaces the params between batches
and a batch in flight keeps the params it was dispatched with — zero
dropped requests across a swap.

When the queue holds ``max_queue`` requests, :meth:`~InferenceEngine.submit`
fails fast with :class:`OverloadedError`. With a ``workdir`` every request
leaves a ``request`` event and its ``request``/``queue``/``infer`` spans in
the shared telemetry stream, which the JAX package's ``dlstatus`` reads.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.serve")


class OverloadedError(RuntimeError):
    """Load-shed rejection: the admission queue is full. Carries the queue
    evidence so a caller can retry with backoff or spill elsewhere."""

    def __init__(self, queue_depth: int, max_queue: int):
        super().__init__(
            f"engine overloaded: {queue_depth} requests already queued "
            f"(max_queue={max_queue}) — shed, retry with backoff")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class EngineStoppedError(RuntimeError):
    """The engine is not accepting requests (stopped or never started)."""


@dataclass
class _Request:
    rid: int
    example: dict[str, np.ndarray]
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0
    ts_submit: float = 0.0                 # wall-clock twin (span t0)
    trace: dict | None = None              # upstream trace context


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """The bucket ladder: the powers of two below ``max_batch``, then
    ``max_batch``."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    return (*sizes, max_batch)


def _map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of a dict/list/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _row(tree, i: int):
    """Row ``i`` of every array leaf of a host tree."""
    if isinstance(tree, dict):
        return {k: _row(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_row(v, i) for v in tree)
    return tree[i]


class InferenceEngine:
    """Coalesce concurrent single-example requests into device batches.

    ``forward(params, batch) -> outputs``: ``batch`` is a dict of stacked
    tensors on ``device``; outputs may be a tensor or a dict/list/tuple of
    tensors with a leading batch axis (rows are split back per request, as
    numpy). ``device`` is the card unless the caller passes ``"cpu"``.
    ``max_batch``/``max_wait_ms`` are the coalescing knobs (the bucket
    ladder is :func:`default_buckets` of ``max_batch``), ``max_queue`` the
    admission bound. With
    ``workdir`` the engine binds the process-wide telemetry writer there;
    without it the engine is telemetry-silent."""

    def __init__(self, forward: Callable[[Any, dict[str, Any]], Any],
                 params: Any, *, device: str | torch.device = "cuda",
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 workdir: str | None = None, name: str = "engine"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.name = name
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.batch_sizes = default_buckets(self.max_batch)
        self._tele = telemetry.configure(workdir) if workdir else None
        self._forward = forward
        self._params = self._to_device(params)
        self.params_version: int | str = 0
        self._queue: list[_Request] = []
        self._cond = threading.Condition()
        # accepting from construction: requests queue up, nothing runs
        # until start() spawns the worker
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._rid = itertools.count()
        self._stats = {"requests": 0, "shed": 0, "errors": 0, "batches": 0,
                       "rows": 0, "reloads": 0}
        self._bucket_counts: dict[int, int] = {}
        self._shapes_run: set[int] = set()
        self._last_hb = 0.0
        self.heartbeat_interval_s = 1.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceEngine":
        with self._cond:
            if self._thread is not None:
                return self
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name=f"dlserve-{self.name}", daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop accepting requests; by default finish everything queued.
        ``drain=False`` fails queued requests with :class:`EngineStoppedError`."""
        if drain and self._thread is None and self._queue:
            self.start()
        with self._cond:
            if self._stopped and self._thread is None:
                return
            self._stopped = True
            if not drain:
                for req in self._queue:
                    req.future.set_exception(
                        EngineStoppedError("engine stopped before dispatch"))
                    if self._tele is not None:
                        self._tele.clear_span(("req", req.rid))
                self._queue.clear()
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        self._thread = None

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------------

    def submit(self, example: dict[str, Any], *,
               trace: dict | None = None) -> Future:
        """Enqueue one example; returns a Future resolving to its output row.

        ``trace`` is an upstream trace context whose trace the request's
        spans join. Raises :class:`OverloadedError` when the queue is full
        and :class:`EngineStoppedError` when the engine is stopped."""
        req = _Request(rid=next(self._rid),
                       example={k: np.asarray(v) for k, v in example.items()},
                       trace=(trace if isinstance(trace, dict)
                              and trace.get("trace_id") else None))
        req.t_submit = time.monotonic()
        req.ts_submit = time.time()
        with self._cond:
            if self._stopped:
                raise EngineStoppedError("engine is stopped")
            if len(self._queue) >= self.max_queue:
                self._stats["shed"] += 1
                if self._tele is not None:
                    self._tele.emit("request", engine=self.name, id=req.rid,
                                    outcome="shed",
                                    queue_depth=len(self._queue),
                                    **({"trace": req.trace["trace_id"]}
                                       if req.trace else {}))
                raise OverloadedError(len(self._queue), self.max_queue)
            self._queue.append(req)
            self._stats["requests"] += 1
            if self._tele is not None:
                # under the lock: once it drops, the worker may finish and
                # clear the request before a late note re-opens it
                self._tele.note_span(("req", req.rid), "request")
            self._cond.notify_all()
        return req.future

    def infer(self, example: dict[str, Any], *, timeout: float | None = 30.0):
        """Blocking convenience: ``submit`` + ``result``."""
        return self.submit(example).result(timeout=timeout)

    def warmup(self, example: dict[str, Any]) -> int:
        """Run every bucket once up front (returns the bucket count), so the
        first request of each bucket does not pay its one-time costs (the
        kernels' build and load, library autotuning) inside its latency."""
        row = {k: np.asarray(v)[None] for k, v in example.items()}
        for b in self.batch_sizes:
            batch = {k: np.repeat(v, b, axis=0) for k, v in row.items()}
            self._run(self._params, batch)
        return len(self.batch_sizes)

    def stats(self) -> dict[str, Any]:
        with self._cond:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["bucket_counts"] = dict(self._bucket_counts)
            out["compiled_batch_shapes"] = len(self._shapes_run)
        out["params_version"] = self.params_version
        return out

    # -- hot reload ----------------------------------------------------------

    def swap_params(self, params: Any, *, version: int | str | None = None) -> None:
        """Replace the serving params between batches.

        The swap is a reference assignment under the queue lock; the worker
        reads the params once per batch, so a dispatched batch finishes on
        the params it started with."""
        params = self._to_device(params)
        with self._cond:
            self._params = params
            self._stats["reloads"] += 1
            if version is not None:
                self.params_version = version
            elif isinstance(self.params_version, int):
                self.params_version += 1

    # -- worker --------------------------------------------------------------

    def _to_device(self, tree):
        return _map_tensors(lambda t: t.to(self.device), tree)

    def _bucket(self, n: int) -> int:
        return next(b for b in self.batch_sizes if b >= n)

    def _collect(self) -> tuple[list[_Request], Any] | None:
        """Block until a batch is ready (coalescing window) or the engine
        stops. Returns (requests, params), both claimed under one lock."""
        with self._cond:
            while not self._queue:
                if self._stopped:
                    return None
                self._cond.wait(0.1)
            deadline = self._queue[0].t_submit + self.max_wait_s
            while len(self._queue) < self.max_batch and not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            return batch, self._params

    def _run(self, params, stacked: dict[str, np.ndarray]):
        """One forward on the device; returns the outputs as host numpy."""
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in stacked.items()}
        with torch.inference_mode():
            out = self._forward(params, batch)
        host = _map_tensors(lambda t: t.cpu().numpy(), out)
        with self._cond:
            self._shapes_run.add(len(next(iter(stacked.values()))))
        return host

    def _maybe_heartbeat(self) -> None:
        """A rate-limited liveness stamp per batch: it names the oldest
        in-flight request, so a replica wedged inside a forward localizes."""
        if self._tele is None:
            return
        now = time.monotonic()
        if now - self._last_hb < self.heartbeat_interval_s:
            return
        self._last_hb = now
        self._tele.heartbeat()

    def _emit_spans(self, reqs: list[_Request], wts0: float, wts1: float,
                    *, n: int, bucket: int, outcome: str,
                    error: str | None = None) -> None:
        """The per-request span trees of one batch in ONE emit_many flush:
        ``queue`` (submit → batch collect) and ``infer`` (the forward),
        under the upstream trace's parent or a fresh ``request`` root."""
        if self._tele is None:
            return
        recs: list[dict] = []
        for r in reqs:
            buf = trace_lib.SpanBuffer.from_context(r.trace)
            parent = buf.parent_id
            if not buf.joined:
                parent = buf.add("request", r.ts_submit, wts1,
                                 engine=self.name, outcome=outcome,
                                 **({"error": error} if error else {}))
            buf.add("queue", trace_lib.SpanBuffer.upstream_t0(
                r.trace, r.ts_submit), wts0, parent_id=parent)
            buf.add("infer", wts0, wts1, parent_id=parent, batch_size=n,
                    bucket=bucket, **({"error": error} if error else {}))
            recs.extend(buf.records)
        self._tele.emit_many(trace_lib.SPAN_KIND, recs)

    def _loop(self) -> None:
        while True:
            got = self._collect()
            if got is None:
                return
            reqs, params = got
            n = len(reqs)
            bucket = self._bucket(n)
            self._maybe_heartbeat()
            t0 = time.monotonic()
            wts0 = time.time()
            try:
                stacked = {k: np.stack([r.example[k] for r in reqs])
                           for k in reqs[0].example}
                if bucket > n:
                    # pad rows are copies of row 0: shape-stable, numerics
                    # can't overflow, and the rows are dropped below
                    stacked = {k: np.concatenate(
                                   [v, np.repeat(v[:1], bucket - n, axis=0)])
                               for k, v in stacked.items()}
                host = self._run(params, stacked)
                infer_s = time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — one bad batch must not
                # kill the serving loop; every member learns the real error
                logger.exception("serve batch failed (%d requests)", n)
                for r in reqs:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)
                with self._cond:
                    self._stats["errors"] += n
                if self._tele is not None:
                    err = f"{type(e).__name__}: {e}"
                    self._tele.emit_many("request", [
                        dict(engine=self.name, id=r.rid, outcome="error",
                             batch_size=n, error=err,
                             **({"trace": r.trace["trace_id"]}
                                if r.trace else {}))
                        for r in reqs])
                    self._emit_spans(reqs, wts0, time.time(), n=n,
                                     bucket=bucket, outcome="error", error=err)
                    for r in reqs:
                        self._tele.clear_span(("req", r.rid))
                continue
            done_ts = time.monotonic()
            with self._cond:
                self._stats["batches"] += 1
                self._stats["rows"] += n
                self._bucket_counts[bucket] = (
                    self._bucket_counts.get(bucket, 0) + 1)
            # results first (clients unblock), then ONE telemetry append
            for i, r in enumerate(reqs):
                if r.future.set_running_or_notify_cancel():
                    r.future.set_result(_row(host, i))
            if self._tele is not None:
                self._tele.emit_many("request", [
                    dict(engine=self.name, id=r.rid, outcome="ok",
                         queue_wait_s=round(t0 - r.t_submit, 6),
                         infer_s=round(infer_s, 6),
                         latency_s=round(done_ts - r.t_submit, 6),
                         batch_size=n, bucket=bucket,
                         **({"trace": r.trace["trace_id"]}
                            if r.trace else {}))
                    for r in reqs])
                self._emit_spans(reqs, wts0, time.time(), n=n,
                                 bucket=bucket, outcome="ok")
                for r in reqs:
                    self._tele.clear_span(("req", r.rid))

    # -- construction helpers ------------------------------------------------

    @classmethod
    def for_model(cls, model: torch.nn.Module,
                  params: dict[str, torch.Tensor] | None = None,
                  **kw) -> "InferenceEngine":
        """Engine over an ``nn.Module``'s inference forward.

        ``params`` (name → tensor, parameters and buffers) is the swappable
        unit; it defaults to the module's own. The module is put in eval
        mode and called as ``functional_call(model, params, (batch,))``."""
        model.eval()
        if params is None:
            params = {**dict(model.named_parameters()),
                      **dict(model.named_buffers())}

        def forward(params, batch):
            return torch.func.functional_call(model, params, (batch,))

        return cls(forward, params, **kw)

"""Run telemetry — the port's writer of the shared JSONL event stream.

The port's own copy of the part of the JAX package's
``telemetry.EventWriter`` that the serving engine and the trainer use. It
appends the same records to the same place,
``<workdir>/telemetry/events-<process>.jsonl``: one JSON object per line
carrying ``ts``/``kind``/``process``, the host identity (``host``, and
``hosts`` in a gang) from the ``DLS_*`` env contract, and the
``DLS_TENANT``/``DLS_PRIORITY`` stamps. So the JAX package's ``dlstatus``
reads a run of the port unchanged. The engine writes ``request``, ``span``
and ``heartbeat`` events; a heartbeat names the oldest in-flight request
(``phase``/``phase_t0``) so a wedged batch localizes. ``Trainer.fit``
writes the ``run`` phase span, one ``step_metrics`` record per log lap and
heartbeats into the workdir that ``DLS_TELEMETRY_DIR`` names (else its
checkpointer's directory). The checkpointer, which holds no writer, goes
through the process-wide one (:func:`get`): :func:`phase` spans a blocking
phase (``checkpoint``, ``checkpoint-verify``, ``checkpoint-wait``,
``restore``) with begin/end records, the end carrying ``dur_s``, and
:meth:`EventWriter.recovery` writes a ``recovery`` event (``quarantine``).

The port's :class:`~..supervisor.Supervisor` writes its ``attempt``
lifecycle records and ``recovery`` decisions into the same stream, as a
process that is no member of the gang (``host=None``); the trainer's
recovery events (``skip``, ``rollback``) go through
:meth:`~..metrics.MetricLogger.event`. :func:`read_events` merges a
workdir's streams in time order (the supervisor's hang localization reads
it, :mod:`.fleet`).

Writers are append-only and flushed per call; a full disk downgrades
telemetry to one warning, never a serving failure. Size-capped segment
rotation and the incremental reader are not ported.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import threading
import time
from typing import Any

from distributeddeeplearningspark_tpu_torch.utils.env import process_identity

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.telemetry")

#: Subdirectory of the workdir holding the per-process event files.
TELEMETRY_DIRNAME = "telemetry"
#: env var naming a run's workdir (the supervisor exports it to its gang)
WORKDIR_ENV = "DLS_TELEMETRY_DIR"
TENANT_ENV = "DLS_TENANT"
PRIORITY_ENV = "DLS_PRIORITY"


def _priority_from_env() -> int | None:
    raw = os.environ.get(PRIORITY_ENV)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", PRIORITY_ENV, raw)
        return None


class EventWriter:
    """Appends typed events to ``<workdir>/telemetry/events-<process>.jsonl``.

    ``clock`` is injectable (epoch seconds) for tests."""

    _HOST_FROM_ENV = object()  # sentinel: the host identity from DLS_*

    def __init__(self, workdir: str | os.PathLike, *, process: str | None = None,
                 clock=time.time, host: int | None | object = _HOST_FROM_ENV):
        self.workdir = os.path.abspath(os.fspath(workdir))
        self.process = process or f"p{os.environ.get('DLS_PROCESS_ID', '0')}"
        self.path = os.path.join(self.workdir, TELEMETRY_DIRNAME,
                                 f"events-{self.process}.jsonl")
        self.tenant = os.environ.get(TENANT_ENV) or None
        self.priority = _priority_from_env()
        env_host, self.hosts = process_identity()
        # host=None opts a process that is no member of the gang (the
        # supervisor) out of the fleet table
        self.host = env_host if host is EventWriter._HOST_FROM_ENV else host
        self._clock = clock
        self._lock = threading.Lock()
        self._f = None
        self._closed = False
        self._warned = False
        # in-flight request notes, insertion-ordered: the first is the
        # OLDEST, the one a heartbeat names
        self._open_spans: dict[Any, tuple[str, float]] = {}

    def _record(self, kind: str, fields: dict[str, Any]) -> dict[str, Any]:
        rec = {"ts": self._clock(), "kind": kind, "process": self.process,
               **fields}
        if self.host is not None:
            rec.setdefault("host", self.host)
            if self.hosts > 1:
                rec.setdefault("hosts", self.hosts)
        if self.tenant is not None:
            rec.setdefault("tenant", self.tenant)
        if self.priority is not None:
            rec.setdefault("priority", self.priority)
        return rec

    def _write_lines(self, lines: list[str]) -> None:
        """Append + flush under the held lock (one flush per call)."""
        try:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write("\n".join(lines) + "\n")
            self._f.flush()
        except OSError as e:
            if not self._warned:
                logger.warning("telemetry disabled (%s): %s", self.path, e)
                self._warned = True

    def emit(self, kind: str, **fields: Any) -> None:
        rec = self._record(kind, fields)
        with self._lock:
            if self._closed:
                return  # a stale writer must not reopen and fork the stream
            if kind == "heartbeat" and "phase" not in rec and self._open_spans:
                name, t0 = next(iter(self._open_spans.values()))
                rec["phase"] = name
                rec["phase_t0"] = t0
            self._write_lines([json.dumps(rec, default=str)])

    def emit_many(self, kind: str, records: list[dict[str, Any]]) -> None:
        """Append N same-kind events under ONE lock/flush (one per served
        batch). ``phase``/``heartbeat`` are rejected: a heartbeat's
        enrichment is :meth:`emit`'s."""
        if kind in ("phase", "heartbeat"):
            raise ValueError(f"emit_many({kind!r}): use emit()")
        if not records:
            return
        with self._lock:
            if self._closed:
                return
            self._write_lines([json.dumps(self._record(kind, f), default=str)
                               for f in records])

    def note_span(self, key: Any, name: str) -> None:
        """Mark an in-flight request open; nothing is written, later
        heartbeats name the oldest open one. :meth:`clear_span` ends it."""
        with self._lock:
            self._open_spans.pop(key, None)
            self._open_spans[key] = (name, self._clock())

    def clear_span(self, key: Any) -> None:
        with self._lock:
            self._open_spans.pop(key, None)

    def step_metrics(self, step: int, *, steps: int, lap_s: float,
                     metrics: dict[str, float] | None = None,
                     **gauges: Any) -> None:
        self.emit("step_metrics", step=int(step), steps=int(steps),
                  lap_s=float(lap_s), metrics=dict(metrics or {}), **gauges)

    @contextlib.contextmanager
    def phase(self, name: str, **fields: Any):
        """Span a blocking phase: begin/end records, the end carries
        ``dur_s``. A crashed run's unterminated begin is accounted up to
        the stream's last event."""
        t0 = self._clock()
        self.emit("phase", name=name, edge="begin", **fields)
        try:
            yield
        finally:
            self.emit("phase", name=name, edge="end",
                      dur_s=self._clock() - t0, **fields)

    def recovery(self, step: int | None, event: str, **fields: Any) -> None:
        """``step=None`` when the emitter does not know the training step."""
        if step is None:
            self.emit("recovery", event=event, **fields)
        else:
            self.emit("recovery", step=int(step), event=event, **fields)

    def attempt(self, edge: str, ordinal: int, **fields: Any) -> None:
        """A supervisor attempt's lifecycle record (``begin``/``end``/
        ``backoff``)."""
        self.emit("attempt", edge=edge, ordinal=int(ordinal), **fields)

    def heartbeat(self, **fields: Any) -> None:
        self.emit("heartbeat", **fields)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


_writer: EventWriter | None = None
_writer_lock = threading.Lock()


def configure(workdir: str | os.PathLike, *, process: str | None = None,
              clock=time.time) -> EventWriter:
    """Bind the process-wide writer to ``workdir`` (idempotent per workdir);
    rebinding closes the previous writer."""
    global _writer
    wd = os.path.abspath(os.fspath(workdir))
    with _writer_lock:
        if (_writer is not None and _writer.workdir == wd
                and (process is None or _writer.process == process)):
            return _writer
        if _writer is not None:
            _writer.close()
        _writer = EventWriter(wd, process=process, clock=clock)
        return _writer


def get() -> EventWriter | None:
    return _writer


def phase(name: str, **fields: Any):
    """Span context through the process-wide writer (no-op unconfigured)."""
    writer = _writer
    if writer is not None:
        return writer.phase(name, **fields)
    return contextlib.nullcontext()


def read_events(workdir: str | os.PathLike) -> list[dict]:
    """Every process's events under ``workdir`` merged into one stream in
    ``ts`` order (stable, so equal timestamps keep each file's order).
    Torn lines (a writer SIGKILLed mid-append) and lines that are not an
    event object are skipped: a crashed run's stream must parse."""
    events: list[dict] = []
    pattern = os.path.join(os.fspath(workdir), TELEMETRY_DIRNAME,
                           "events-*.jsonl")
    for path in sorted(glob.glob(pattern)):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "ts" in rec and "kind" in rec:
                events.append(rec)
    events.sort(key=lambda e: float(e["ts"]))
    return events


def reset() -> None:
    """Drop the process-wide writer (tests; also ends a run's binding)."""
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.close()
            _writer = None

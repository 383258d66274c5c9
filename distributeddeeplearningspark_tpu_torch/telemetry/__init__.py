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
checkpointer's directory), and with them the device-side events of
:mod:`.anatomy` (``compile``, ``memory``) and the profiler's
``profile-trace`` phase. The checkpointer, which holds no writer, goes
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

The reader half is the JAX package's, copied: :func:`event_files`,
:func:`read_events` (torn and non-event lines skipped, a stable merge by
``ts``), :class:`EventCursor` (the incremental reader ``dlstatus --watch``
and the health engine poll) and :func:`goodput`, the fold of a stream
into its time budget (productive, compile, restore, checkpoint, eval,
input-starved, restart and idle seconds); the port's ``dlstatus``
(:mod:`..status`) reads through them.

Writers are append-only and flushed per call; a full disk downgrades
telemetry to one warning, never a serving failure. Size-capped segment
rotation is not ported: a process writes one file.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import math
import os
import threading
import time
from typing import Any, Iterable

from distributeddeeplearningspark_tpu_torch.utils.env import process_identity

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.telemetry")

#: Subdirectory of the workdir holding the per-process event files.
TELEMETRY_DIRNAME = "telemetry"
#: env var naming a run's workdir (the supervisor exports it to its gang)
WORKDIR_ENV = "DLS_TELEMETRY_DIR"
TENANT_ENV = "DLS_TENANT"
PRIORITY_ENV = "DLS_PRIORITY"


#: phase name -> goodput component it is accounted under. Blocking spans
#: only: async background work (orbax writes, manifest CRC threads) must
#: NOT be listed here — it overlaps training and steals no step time.
PHASE_CATEGORY = {
    "compile": "compile_s",
    "restore": "restore_s",
    "checkpoint": "checkpoint_s",
    "checkpoint-wait": "checkpoint_s",
    "checkpoint-verify": "checkpoint_s",
    "eval": "eval_s",
}

_INTERVAL_COMPONENTS = ("compile_s", "restore_s", "checkpoint_s", "eval_s",
                        "restart_overhead_s", "idle_s")

#: Every goodput component, in display order — the ONE list dlstatus renders
#: and the acceptance tests sum ("components sum to wall-clock"). Extending
#: PHASE_CATEGORY with a new overhead category means extending this too.
GOODPUT_COMPONENTS = ("productive_s", "compile_s", "restore_s",
                      "checkpoint_s", "eval_s", "input_starved_s",
                      "restart_overhead_s", "idle_s")


def telemetry_dir(workdir: str | os.PathLike) -> str:
    """The events directory for ``workdir`` (which may BE the events dir —
    ``dlstatus <workdir>`` and ``dlstatus <workdir>/telemetry`` both work)."""
    workdir = os.fspath(workdir)
    sub = os.path.join(workdir, TELEMETRY_DIRNAME)
    if os.path.isdir(sub):
        return sub
    if os.path.basename(os.path.normpath(workdir)) == TELEMETRY_DIRNAME:
        return workdir
    if glob.glob(os.path.join(workdir, "events-*.jsonl")):
        return workdir
    return sub


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


def emit(kind: str, **fields: Any) -> None:
    """Emit through the process-wide writer; a no-op unconfigured."""
    writer = _writer
    if writer is not None:
        writer.emit(kind, **fields)


def phase(name: str, **fields: Any):
    """Span context through the process-wide writer (no-op unconfigured)."""
    writer = _writer
    if writer is not None:
        return writer.phase(name, **fields)
    return contextlib.nullcontext()


def reset() -> None:
    """Drop the process-wide writer (tests; also ends a run's binding)."""
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.close()
            _writer = None


# -- reader ------------------------------------------------------------------


def event_files(workdir: str | os.PathLike) -> list[str]:
    return sorted(glob.glob(os.path.join(telemetry_dir(workdir),
                                         "events-*.jsonl")))


def _parse_event_line(line: str) -> dict | None:
    """One JSONL line -> event dict, or None for torn/garbage lines.

    A record must be a JSON object carrying ``ts`` and ``kind`` — anything
    else (a half-written tail, an editor's stray newline, a non-event JSON
    value) is not an event."""
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if isinstance(rec, dict) and "ts" in rec and "kind" in rec:
        return rec
    return None


def read_events(workdir: str | os.PathLike) -> list[dict]:
    """Merge every process's event file into one ts-ordered stream.

    Torn lines (a writer SIGKILLed mid-append) and non-JSON garbage are
    skipped — a crashed run's partial stream must parse. The sort is stable,
    so records with equal timestamps keep their per-file order (the
    multi-process merge contract the tests pin)."""
    events: list[dict] = []
    for path in event_files(workdir):
        try:
            with open(path) as f:
                for line in f:
                    rec = _parse_event_line(line)
                    if rec is not None:
                        events.append(rec)
        except OSError:
            continue
    events.sort(key=lambda e: float(e["ts"]))
    return events


class EventCursor:
    """Incremental :func:`read_events`: per-file byte offsets so each poll
    parses only what was appended since the last one.

    ``dlstatus --watch`` and the health engine re-evaluate every few
    seconds; re-parsing a long run's whole JSONL set each tick is O(total
    events) per tick and grows without bound. The cursor keeps one byte
    offset per segment file:

    - **New files/segments** (a rotation, a late-joining process) enter the
      glob on the next poll and are read from byte 0.
    - **Torn tails** — a writer mid-append when we poll — are held back:
      only complete (newline-terminated) lines are consumed, the offset
      stays at the line start, and the finished line parses next poll.
      A torn line is therefore *deferred*, never dropped (the one-shot
      reader, arriving after the crash, skips it instead).
    - **Truncated/replaced files** (offset beyond EOF) reset to 0.

    ``events`` is the accumulated ts-sorted merge (what :func:`read_events`
    would return, minus any still-torn tails); :meth:`poll` returns just the
    newly appended records. ``skipped_lines`` counts complete-but-garbage
    lines — the parseable-but-degraded signal the health engine reports
    when a crashed run's partial segment is all a workdir has."""

    def __init__(self, workdir: str | os.PathLike):
        self.workdir = os.fspath(workdir)
        self._offsets: dict[str, int] = {}
        self.events: list[dict] = []
        self.skipped_lines = 0
        #: total bytes consumed across every poll — the receipt that watch
        #: cost is bounded by the append rate (ci.sh history asserts it).
        self.bytes_read = 0

    @property
    def files(self) -> list[str]:
        """Every segment file seen so far (polled at least once)."""
        return sorted(self._offsets)

    def lag_bytes(self) -> int:
        """Bytes on disk the cursor has not consumed yet: appended-but-
        unpolled data plus still-torn tails (files the glob hasn't seen
        count in full). The health engine records this as its own
        falling-behind gauge."""
        lag = 0
        for path in event_files(self.workdir):
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            lag += max(0, size - self._offsets.get(path, 0))
        return lag

    def poll(self) -> list[dict]:
        """Read appended lines from every segment; return the new events
        (also merged, ts-stably, into :attr:`events`)."""
        new: list[dict] = []
        for path in event_files(self.workdir):
            off = self._offsets.setdefault(path, 0)
            try:
                size = os.path.getsize(path)
                if size < off:
                    off = self._offsets[path] = 0  # truncated/replaced
                if size == off:
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read()
            except OSError:
                continue
            end = data.rfind(b"\n")
            if end < 0:
                continue  # only a torn fragment so far — retry next poll
            self._offsets[path] = off + end + 1
            self.bytes_read += end + 1
            for raw in data[:end + 1].splitlines():
                rec = _parse_event_line(raw.decode("utf-8", errors="replace"))
                if rec is not None:
                    new.append(rec)
                elif raw.strip():
                    self.skipped_lines += 1
        if new:
            self.events.extend(new)
            self.events.sort(key=lambda e: float(e["ts"]))
        return new


# -- goodput accounting ------------------------------------------------------


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total covered length of possibly-overlapping [t0, t1] intervals."""
    total = 0.0
    end = -math.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def _subtract_intervals(
    iv: tuple[float, float], subs: list[tuple[float, float]],
) -> list[tuple[float, float]]:
    """``iv`` minus every interval in ``subs`` (may split it)."""
    out = [iv]
    for s0, s1 in subs:
        nxt: list[tuple[float, float]] = []
        for t0, t1 in out:
            if s1 <= t0 or t1 <= s0:
                nxt.append((t0, t1))
                continue
            if t0 < s0:
                nxt.append((t0, s0))
            if s1 < t1:
                nxt.append((s1, t1))
        out = nxt
    return out


def goodput(events: Iterable[dict]) -> dict[str, float]:
    """Fold an event stream into the run's time budget.

    Returns ``{wall_s, productive_s, compile_s, restore_s, checkpoint_s,
    eval_s, input_starved_s, restart_overhead_s, goodput_frac}``.

    Accounting model: wall-clock is the stream's [first ts, last ts] span.
    Overhead phases are intervals, merged by union — within a category so a
    double-instrumented span counts once, and across ALL categories for the
    productive residual, so a span nested in another is never subtracted
    twice. ``input_starved_s`` is a counter (the per-lap probe snapshots
    summed per process, then the MAX across processes — lockstep SPMD means
    the slowest host's wait is the gang's wait). ``restart_overhead_s``
    is the dead time between one attempt's end and the next one's begin
    (supervisor backoff + teardown). ``idle_s`` is the gap between one
    ``run`` span's end and the next one's begin — a stop-today/resume-
    tomorrow workdir accrues a day of idle, which must be neither
    "productive" nor a restart (gaps already covered by a supervisor
    restart interval are not double-counted). ``productive_s`` is the
    residual: wall − union(all overhead intervals) − input_starved. A
    crashed stream simply ends early — an unterminated phase begin is
    accounted up to the last event seen.
    """
    out = {"wall_s": 0.0, "productive_s": 0.0, "input_starved_s": 0.0,
           "goodput_frac": 0.0}
    for c in _INTERVAL_COMPONENTS:
        out[c] = 0.0
    # alert events are meta-observation (the health engine watching the
    # run), not run activity: a long-lived engine appending edges to a
    # finished workdir must not stretch its wall-clock span
    events = [e for e in events if "ts" in e and e.get("kind") != "alert"]
    if not events:
        return out
    events = sorted(events, key=lambda e: float(e["ts"]))
    t_lo, t_hi = float(events[0]["ts"]), float(events[-1]["ts"])
    wall = t_hi - t_lo
    out["wall_s"] = wall

    intervals: dict[str, list[tuple[float, float]]] = {
        c: [] for c in _INTERVAL_COMPONENTS}
    open_phases: dict[tuple, list[float]] = {}
    last_ts_by_process: dict[str | None, float] = {}
    attempt_ends: list[float] = []
    input_by_process: dict[str | None, float] = {}
    last_attempt_end: float | None = None
    last_end_ordinal = -2  # sentinel: nothing follows it
    last_run_end: float | None = None
    idle_candidates: list[tuple[float, float]] = []
    for e in events:
        kind, ts = e.get("kind"), float(e["ts"])
        proc = e.get("process")
        prev_proc_ts = last_ts_by_process.get(proc)
        last_ts_by_process[proc] = ts
        if kind == "phase":
            name = e.get("name", "")
            cat = PHASE_CATEGORY.get(name)
            key = (proc, name)
            if e.get("edge") == "begin":
                if name == "run":
                    starts = open_phases.get(key)
                    if starts:
                        # a NEW run span while this process's previous one
                        # never closed: that session crashed — it effectively
                        # ended at the process's last prior event, and the
                        # gap from there to this resume is idle, not
                        # productive residual
                        starts.clear()
                        if prev_proc_ts is not None and ts > prev_proc_ts:
                            idle_candidates.append((prev_proc_ts, ts))
                    elif last_run_end is not None and ts > last_run_end:
                        # gap since the previous run span closed cleanly =
                        # a stopped workdir sitting idle between sessions
                        idle_candidates.append((last_run_end, ts))
                    last_run_end = None
                open_phases.setdefault(key, []).append(ts)
            elif e.get("edge") == "end":
                starts = open_phases.get(key)
                t0 = starts.pop() if starts else ts - float(e.get("dur_s", 0.0))
                if cat:
                    intervals[cat].append((min(t0, ts), ts))
                if name == "run":
                    last_run_end = ts
        elif kind == "step_metrics":
            input_by_process[proc] = (input_by_process.get(proc, 0.0)
                                      + float(e.get("input_wait_s", 0.0) or 0.0))
        elif kind == "attempt":
            if e.get("edge") == "end":
                last_attempt_end = ts
                last_end_ordinal = int(e.get("ordinal", -1))
                attempt_ends.append(ts)
            elif e.get("edge") == "begin" and last_attempt_end is not None:
                # restart overhead only pairs WITHIN one supervisor session
                # (ordinals increment per relaunch); an ordinal that does
                # not follow the last end is a fresh supervisor invocation
                # on the same workdir — that gap is idle time between
                # sessions, not the price of a restart
                if (int(e.get("ordinal", -1)) == last_end_ordinal + 1
                        and ts > last_attempt_end):
                    intervals["restart_overhead_s"].append(
                        (last_attempt_end, ts))
                last_attempt_end = None
    # crash mid-phase: the begin is all we have. Do NOT extend it to the
    # whole stream's end — a relaunched attempt appends hours of events to
    # the same file set, and an orphaned span stretched across them would
    # swallow the relaunch's productive time. The honest bound is the first
    # supervisor attempt-end after the begin (when the death was reaped),
    # falling back to the opening process's own last event (when it went
    # silent) for unsupervised runs.
    for (proc, name), starts in open_phases.items():
        cat = PHASE_CATEGORY.get(name or "")
        if cat:
            proc_last = last_ts_by_process.get(proc, t_hi)
            for t0 in starts:
                reaped = [t for t in attempt_ends if t >= t0]
                t1 = min(reaped) if reaped else proc_last
                intervals[cat].append((t0, max(t0, t1)))

    # idle-between-runs, minus the sub-spans a supervisor restart interval
    # already accounts for (a relaunch IS a run-end→run-begin gap too).
    # SUBTRACTED, not dropped whole: a hang's dwell (worker silent long
    # before the watchdog reaped it) and the relaunch's startup tail extend
    # beyond the restart interval and must not fall back into "productive"
    restarts = intervals["restart_overhead_s"]
    intervals["idle_s"] = [
        piece for cand in idle_candidates
        for piece in _subtract_intervals(cand, restarts)]

    all_iv: list[tuple[float, float]] = []
    for cat, iv in intervals.items():
        out[cat] = _union_seconds(iv)
        all_iv.extend(iv)
    # gang-step SPMD runs in lockstep: the slowest host's input wait gates
    # every step, so the gang-level starvation is the MAX over processes —
    # summing would over-count N-fold exactly like un-unioned intervals
    input_starved = max(input_by_process.values(), default=0.0)
    out["input_starved_s"] = input_starved
    overhead = _union_seconds(all_iv) + input_starved
    out["productive_s"] = max(0.0, wall - overhead)
    out["goodput_frac"] = out["productive_s"] / wall if wall > 0 else 0.0
    return out

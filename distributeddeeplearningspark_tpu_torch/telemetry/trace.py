"""Request-level trace spans on the telemetry stream — the port's copy of
the JAX package's ``telemetry/trace.py``: the writer half the serving
engine uses, and the reader folds the port's ``dlstatus`` calls
(:func:`spans_of`, :func:`spans_from_phases`, :func:`trace_trees`,
:func:`request_anatomy`, :func:`chrome_trace`, which draws ``memory``
events as a counter track).

A ``span`` event carries ``trace_id`` (one request end to end),
``span_id``, ``parent_id``, ``name``, ``t0``/``t1`` (epoch seconds) and
free-form ``attrs``. A trace context ``{"trace_id", "parent_id"[, "t0"]}``
handed in by an upstream layer joins its spans to that trace.
"""

from __future__ import annotations

import os
from typing import Any, Iterable

#: the event kind span records ride the stream under
SPAN_KIND = "span"


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def span(trace_id: str, span_id: str, name: str, t0: float, t1: float | None,
         *, parent_id: str | None = None, **attrs: Any) -> dict[str, Any]:
    """One span record (the fields of a ``span`` event)."""
    rec: dict[str, Any] = {
        "trace_id": trace_id, "span_id": span_id, "name": name,
        "t0": float(t0), "t1": None if t1 is None else float(t1),
    }
    if parent_id is not None:
        rec["parent_id"] = parent_id
    if attrs:
        rec["attrs"] = attrs
    return rec


class SpanBuffer:
    """Per-request span collector: spans append host-side, and the owner
    writes :attr:`records` with one ``emit_many`` at completion."""

    def __init__(self, trace_id: str | None = None,
                 parent_id: str | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.parent_id = parent_id
        self.records: list[dict[str, Any]] = []

    @classmethod
    def from_context(cls, ctx: dict | None) -> "SpanBuffer":
        """Join an upstream trace, or start a fresh one when there is none."""
        if not isinstance(ctx, dict) or not ctx.get("trace_id"):
            return cls()
        return cls(str(ctx["trace_id"]),
                   str(ctx["parent_id"]) if ctx.get("parent_id") else None)

    @property
    def joined(self) -> bool:
        """True when this buffer continues an upstream trace."""
        return self.parent_id is not None

    @staticmethod
    def upstream_t0(ctx: dict | None, default: float) -> float:
        """The upstream context's request-start time ``t0``, clamped to
        ``default`` (the local submit time)."""
        if isinstance(ctx, dict) and ctx.get("t0") is not None:
            try:
                return min(default, float(ctx["t0"]))
            except (TypeError, ValueError):
                pass
        return default

    def add(self, name: str, t0: float, t1: float | None, *,
            parent_id: str | None = None, **attrs: Any) -> str:
        sid = new_span_id()
        self.records.append(span(
            self.trace_id, sid, name, t0, t1,
            parent_id=parent_id if parent_id is not None else self.parent_id,
            **attrs))
        return sid


# -- reader (the JAX package's folds, copied) -----------------------------------


def spans_of(events: Iterable[dict]) -> list[dict]:
    """The well-formed span events of a stream (garbage skipped, never
    raised on — the torn-stream contract of every reader here)."""
    out = []
    for e in events:
        if e.get("kind") != SPAN_KIND:
            continue
        if not e.get("trace_id") or not e.get("span_id") or not e.get("name"):
            continue
        try:
            float(e["t0"])
            if e.get("t1") is not None:
                float(e["t1"])
        except (KeyError, TypeError, ValueError):
            continue
        out.append(e)
    return out


def spans_from_phases(events: Iterable[dict]) -> list[dict]:
    """Lower train-side ``phase`` begin/end pairs into span records.

    One synthetic trace per process (``train:<process>``); nesting follows
    the begin/end stack, so ``checkpoint-wait`` inside ``checkpoint``
    becomes a child span. A ``run`` begin resets the stack (a relaunched
    attempt appending to the same file must not parent into the crashed
    session's spans); a begin with no end becomes an open span
    (``t1=None``) — the honest shape of a crash mid-phase."""
    open_by_proc: dict[str, list[dict]] = {}
    out: list[dict] = []
    for e in events:
        if e.get("kind") != "phase" or not e.get("name") or "ts" not in e:
            continue
        proc = str(e.get("process"))
        stack = open_by_proc.setdefault(proc, [])
        name, edge, ts = e["name"], e.get("edge"), float(e["ts"])
        if edge == "begin":
            if name == "run":
                # crashed session's spans: close them open-ended
                out.extend(s for s in stack)
                stack.clear()
            # identity fields ride along as span attrs, so the chrome
            # export tags e.g. a compile span with its wrapped fn and its
            # originating Plan (parallel/plan.py)
            extra = {k: e[k] for k in ("fn", "plan")
                     if e.get(k) is not None}
            rec = span(f"train:{proc}", new_span_id(), name, ts, None,
                       parent_id=stack[-1]["span_id"] if stack else None,
                       **extra)
            rec["process"] = proc
            stack.append(rec)
        elif edge == "end":
            for i in range(len(stack) - 1, -1, -1):
                if stack[i]["name"] == name:
                    rec = stack.pop(i)
                    rec["t1"] = ts
                    out.append(rec)
                    break
            # an end with no begin (file rotated away / torn head): dropped
    for stack in open_by_proc.values():
        out.extend(stack)  # still-open spans, t1=None
    return out


def trace_trees(events: Iterable[dict], *,
                include_phases: bool = False) -> dict[str, dict]:
    """Group spans by trace and build causal trees — the crash-tolerant
    fold every trace consumer goes through.

    Returns ``{trace_id: {"trace_id", "root", "orphans", "incomplete",
    "num_spans"}}`` where ``root``/``orphans`` are nodes of the shape
    ``{"span": rec, "children": [nodes sorted by t0]}``. A tree is
    ``incomplete`` when it has no root (the root's emit died with the
    process), when spans reference parents that never arrived (they land
    under ``orphans`` so their evidence still renders), or when any span
    is still open (``t1`` missing). Duplicated span ids keep the first
    record. Never throws on torn/interleaved streams."""
    spans = spans_of(events)
    if include_phases:
        spans = spans + spans_from_phases(events)
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(str(s["trace_id"]), []).append(s)
    out: dict[str, dict] = {}
    for tid, recs in by_trace.items():
        nodes: dict[str, dict] = {}
        for s in recs:
            nodes.setdefault(str(s["span_id"]), {"span": s, "children": []})
        roots: list[dict] = []
        orphans: list[dict] = []
        for node in nodes.values():
            pid = node["span"].get("parent_id")
            if pid is None:
                roots.append(node)
            elif str(pid) in nodes and str(pid) != str(node["span"]["span_id"]):
                nodes[str(pid)]["children"].append(node)
            else:
                orphans.append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: float(n["span"]["t0"]))
        roots.sort(key=lambda n: float(n["span"]["t0"]))
        root = roots[0] if roots else None
        orphans.extend(roots[1:])  # two roots: keep the earliest, flag rest
        open_spans = any(s.get("t1") is None for s in recs)
        out[tid] = {
            "trace_id": tid,
            "root": root,
            "orphans": sorted(orphans, key=lambda n: float(n["span"]["t0"])),
            "incomplete": root is None or bool(orphans) or open_spans,
            "num_spans": len(nodes),
        }
    return out


def _dur(s: dict) -> float | None:
    if s.get("t1") is None:
        return None
    return max(0.0, float(s["t1"]) - float(s["t0"]))


#: span names that are stages of a request (the latency decomposition),
#: vs. bookkeeping children (place, failover) that overlap them.
STAGE_NAMES = ("queue", "admission", "prefill", "decode", "stream", "infer")


def request_anatomy(events: Iterable[dict]) -> list[dict]:
    """One record per request trace: end-to-end, per-stage durations, and
    how much of the request the stages account for.

    ``coverage`` is Σ(stage spans) / e2e — the acceptance metric ("the
    decomposition explains ≥95% of the latency"); stages tile the
    replica's residence by construction, so the gap is socket transit +
    dispatch bookkeeping. Incomplete trees still yield a record (flagged)
    so a crash's partial evidence renders instead of vanishing."""
    out = []
    for tid, tree in sorted(trace_trees(events).items()):
        root = tree["root"]
        root_span = root["span"] if root else None
        if root_span is not None and root_span["name"] != "request":
            continue  # not a request trace (future span users)
        nodes = []

        def walk(n):
            nodes.append(n["span"])
            for c in n["children"]:
                walk(c)

        if root:
            walk(root)
        for o in tree["orphans"]:
            walk(o)
        stage_spans = [{"name": s["name"], "dur_s": _dur(s),
                        "process": s.get("process"), "t0": float(s["t0"]),
                        "attrs": s.get("attrs") or {}}
                       for s in nodes if s["name"] in STAGE_NAMES]
        stages: dict[str, float] = {}
        for s in stage_spans:
            if s["dur_s"] is not None:
                stages[s["name"]] = stages.get(s["name"], 0.0) + s["dur_s"]
        e2e = _dur(root_span) if root_span else None
        attrs = (root_span.get("attrs") or {}) if root_span else {}
        out.append({
            "trace_id": tid,
            "process": root_span.get("process") if root_span else None,
            "engine": attrs.get("engine"),
            "tenant": attrs.get("tenant"),
            "outcome": attrs.get("outcome"),
            "hops": attrs.get("hops", 0),
            "t0": float(root_span["t0"]) if root_span else (
                min((s["t0"] for s in stage_spans), default=None)),
            "e2e_s": e2e,
            "stages": stages,
            "stage_spans": stage_spans,
            "coverage": (sum(stages.values()) / e2e
                         if e2e else None),
            "incomplete": tree["incomplete"],
            "num_spans": tree["num_spans"],
        })
    return out


# -- Chrome trace_event export ------------------------------------------------


def chrome_trace(events: Iterable[dict], *,
                 series_buckets: dict[str, list[dict]] | None = None
                 ) -> dict[str, Any]:
    """Both halves of a run — serve request spans and train phase spans —
    as Chrome/Perfetto ``trace_event`` JSON (the "JSON array format":
    ``{"traceEvents": [...]}``, complete ``"X"`` events with microsecond
    ``ts``/``dur``, open spans as lone ``"B"``s, plus ``"M"`` metadata
    naming processes and rows). ``pid`` is the writing process, ``tid``
    one row per trace within it, so a request's stages stack on their own
    line and any run opens in a real trace viewer.

    ``series_buckets`` (a :func:`~.series.read_buckets` result) adds one
    ``"C"`` counter track per series under a synthetic "series" process —
    the goodput/queue-depth/headroom trendlines the history store
    recorded, lined up against the spans and alert markers."""
    events = [e for e in events if "ts" in e]
    serve = spans_of(events)
    train = spans_from_phases(events)
    all_spans = ([("serve", s) for s in serve]
                 + [("train", s) for s in train])
    # memory watermark samples (telemetry/anatomy.py) become a counter
    # track per process — the HBM trendline next to the span timeline
    mems = [e for e in events if e.get("kind") == "memory"]
    # health alert edges (telemetry/health.py) become instant events on an
    # "alerts" row — the raise/clear markers lined up against the spans
    # that explain them
    alerts = [e for e in events if e.get("kind") == "alert"]
    # scheduler edges (scheduler/core.py) share the alerts row: a
    # preemption marker lands right where the victim's spans stop
    sched = [e for e in events if e.get("kind") == "sched"]
    series_buckets = {k: bs for k, bs in (series_buckets or {}).items()
                      if bs}
    if (not all_spans and not mems and not alerts and not sched
            and not series_buckets):
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    epoch = min([float(s["t0"]) for _, s in all_spans]
                + [float(e["ts"]) for e in mems]
                + [float(e["ts"]) for e in alerts]
                + [float(e["ts"]) for e in sched]
                + [float(bs[0]["t"]) for bs in series_buckets.values()])

    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    tid_next: dict[int, int] = {}
    trace_events: list[dict] = []

    def pid_of(proc: str) -> int:
        if proc not in pids:
            pids[proc] = len(pids) + 1
            trace_events.append({
                "name": "process_name", "ph": "M", "pid": pids[proc],
                "tid": 0, "args": {"name": proc}})
        return pids[proc]

    def tid_of(pid: int, row: str) -> int:
        key = (pid, row)
        if key not in tids:
            tids[key] = tid_next.get(pid, 0)
            tid_next[pid] = tids[key] + 1
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tids[key], "args": {"name": row}})
        return tids[key]

    for cat, s in sorted(all_spans, key=lambda cs: float(cs[1]["t0"])):
        proc = str(s.get("process") or "?")
        pid = pid_of(proc)
        row = ("phases" if cat == "train"
               else f"req {str(s['trace_id'])[:8]}")
        tid = tid_of(pid, row)
        args = dict(s.get("attrs") or {})
        args["trace_id"] = s["trace_id"]
        base = {"name": s["name"], "cat": cat, "pid": pid, "tid": tid,
                "ts": (float(s["t0"]) - epoch) * 1e6, "args": args}
        if s.get("t1") is None:
            trace_events.append({**base, "ph": "B"})  # open: begin only
        else:
            trace_events.append({
                **base, "ph": "X",
                "dur": max(0.0, float(s["t1"]) - float(s["t0"])) * 1e6})
    _MEM_GAUGES = ("bytes_in_use_max", "peak_bytes_in_use_max",
                   "live_bytes")
    for e in mems:
        gauges = {k: int(e[k]) for k in _MEM_GAUGES
                  if e.get(k) is not None}
        if not gauges:
            continue
        trace_events.append({
            "name": "memory", "cat": "memory", "ph": "C",
            "pid": pid_of(str(e.get("process") or "?")), "tid": 0,
            "ts": (float(e["ts"]) - epoch) * 1e6, "args": gauges})
    for e in alerts:
        pid = pid_of(str(e.get("process") or "health"))
        trace_events.append({
            "name": f"{e.get('edge', '?')} {e.get('key', '?')}",
            "cat": "alert", "ph": "i", "s": "g",  # global-scope instant
            "pid": pid, "tid": tid_of(pid, "alerts"),
            "ts": (float(e["ts"]) - epoch) * 1e6,
            "args": {k: e[k] for k in ("rule", "key", "severity", "edge",
                                       "summary", "cleared_from", "held")
                     if e.get(k) is not None}})
    for e in sched:
        pid = pid_of(str(e.get("process") or "sched"))
        trace_events.append({
            "name": f"sched-{e.get('edge', '?')} {e.get('job', '?')}",
            "cat": "sched", "ph": "i", "s": "g",
            "pid": pid, "tid": tid_of(pid, "alerts"),
            "ts": (float(e["ts"]) - epoch) * 1e6,
            "args": {k: e[k] for k in ("edge", "job", "tenant", "priority",
                                       "mode", "victim_of", "reason",
                                       "hosts", "step")
                     if e.get(k) is not None}})
    for key in sorted(series_buckets):
        pid = pid_of("series")
        for b in series_buckets[key]:
            trace_events.append({
                "name": key, "cat": "series", "ph": "C",
                "pid": pid, "tid": 0,
                "ts": (float(b["t"]) - epoch) * 1e6,
                "args": {"mean": b["mean"]}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

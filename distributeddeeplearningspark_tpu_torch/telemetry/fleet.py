"""Cross-host telemetry aggregation — the pod-level view of one run.

The port's copy of ``distributeddeeplearningspark_tpu/telemetry/fleet.py``,
as it is: the supervisor's hang localization (:func:`localize_hang`) and
every fold the port's ``dlstatus`` renders (the host table with its
goodput column, the straggler verdict, the serving fleet, the latency
anatomy, the SLO report, the pipeline anatomy). The JAX module's account
follows.

The event bus gives each process a durable stream; in multi-host SPMD the
unit of failure is the *gang*: every host runs the same program, and one
straggler stalls every collective, so the question after an incident is
never "did the run hang" but "WHICH host stalled, in WHAT phase, while the
others waited WHERE". This module folds the merged per-host streams of a
shared workdir into:

- a **host table** (:func:`host_table`) — per host: last step, heartbeat
  age, current phase, comms wait, per-component goodput;
- **step skew** (:func:`step_skew`) — for every step window all hosts
  reported, the spread between the first and last host to reach it, plus a
  **straggler verdict** when one host is persistently the slowest;
- **hang localization** (:func:`localize_hang`) — the host whose stream
  went silent first (the one actually stuck; the others' silence is just
  the collective blocking on it), with the phase it was in and how long.

Like the rest of the reader side this is a pure fold over event dicts: it
works identically on a crashed run's partial streams, needs no jax, and a
host whose file is torn mid-line simply contributes fewer events.

Host identity: the ``host`` field stamped by the writer (the DLS_* process
index); streams from before that field exist fall back to the ``p<k>``
process-name convention. Non-host processes (``supervisor``, ``tpu_watch``,
``bench``) are excluded from the table — their events describe the gang,
they are not members of it.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

from distributeddeeplearningspark_tpu_torch import telemetry

_PROC_HOST_RE = re.compile(r"^p(\d+)$")

#: the culprit host must have gone silent this many× the gang's observed
#: per-step skew (its clock-jitter + normal-straggle baseline) before every
#: other host did (see :func:`localize_hang`).
DEFAULT_STALL_FACTOR = 3.0

#: floor for the silence-lead margin (seconds): below this, clock jitter
#: between hosts could explain the spread and no single host is named.
MIN_STALL_MARGIN_S = 1.0


def host_of(event: dict) -> int | None:
    """The host index an event belongs to, or None for non-host processes."""
    h = event.get("host")
    if isinstance(h, int) and not isinstance(h, bool):
        return h
    m = _PROC_HOST_RE.match(str(event.get("process") or ""))
    return int(m.group(1)) if m else None


def split_hosts(events: Iterable[dict]) -> dict[int, list[dict]]:
    """Group worker events by host index (ts order preserved)."""
    by_host: dict[int, list[dict]] = {}
    for e in events:
        h = host_of(e)
        if h is not None:
            by_host.setdefault(h, []).append(e)
    return by_host


def _fold_host(host: int, events: list[dict]) -> dict[str, Any]:
    """One host's row: liveness, position, phase, comms wait, goodput."""
    last_step = None
    last_step_ts = None
    last_hb_ts = None
    comms_wait = 0.0
    collectives = 0
    open_phases: list[tuple[str, float]] = []
    hb_phase = None
    hb_phase_t0 = None
    process = None
    for e in events:
        ts = float(e["ts"])
        kind = e.get("kind")
        process = e.get("process", process)
        if kind in ("step_metrics", "heartbeat") and e.get("step") is not None:
            last_step = int(e["step"])
            last_step_ts = ts
        if kind == "heartbeat":
            last_hb_ts = ts
            if e.get("phase") is not None:
                hb_phase = e["phase"]
                # a serving replica's heartbeat carries its oldest OPEN
                # request span as phase + phase_t0 (EventWriter.note_span)
                # — the request-side twin of "in restore since ts"
                hb_phase_t0 = e.get("phase_t0")
            else:
                # a phase-LESS heartbeat means the process is in nothing
                # notable NOW: a completed request must not stick as the
                # replica's position for the next hour (request spans,
                # unlike phases, leave no end event to clear it; training
                # heartbeats inside the always-open `run` phase never
                # take this branch)
                hb_phase = None
                hb_phase_t0 = None
        elif kind == "phase":
            name = e.get("name")
            if not name:
                continue
            if e.get("edge") == "begin":
                if name == "run":
                    # a new run span = a relaunched attempt appending to
                    # the same file: spans (and heartbeat phases) left open
                    # by the crashed previous session are stale and must
                    # not leak into this attempt's "current phase"
                    open_phases.clear()
                    hb_phase = None
                    hb_phase_t0 = None
                open_phases.append((name, ts))
            elif e.get("edge") == "end":
                for i in range(len(open_phases) - 1, -1, -1):
                    if open_phases[i][0] == name:
                        del open_phases[i]
                        break
                if hb_phase == name:
                    # the phase a heartbeat last reported has ENDED — a
                    # clean exit must not read as "still in restore"
                    hb_phase = None
                    hb_phase_t0 = None
        elif kind == "collective":
            comms_wait += float(e.get("wait_s", 0.0) or 0.0)
            collectives += 1
    # current phase = innermost still-open span (excluding the outer "run"
    # umbrella when something more specific is open), else the last
    # heartbeat's self-reported phase. phase_since_ts only for a specific
    # inner span: "in run since the attempt began" is the whole attempt's
    # age, not a stall dwell — age questions then fall back to last_ts
    phase, phase_since = None, None
    for name, ts in reversed(open_phases):
        phase = name
        phase_since = ts if name != "run" else None
        if name != "run":
            break
    if phase is None:
        phase = hb_phase
        # a request-span heartbeat knows WHEN the request began: the hang
        # verdict's dwell then measures from the request start, like an
        # open restore measures from its begin
        if hb_phase_t0 is not None:
            try:
                phase_since = float(hb_phase_t0)
            except (TypeError, ValueError):
                pass
    g = telemetry.goodput(events)
    first_ts, last_ts = float(events[0]["ts"]), float(events[-1]["ts"])
    return {
        "host": host,
        "process": process,
        "num_events": len(events),
        "first_ts": first_ts,
        "last_ts": last_ts,
        "last_step": last_step,
        "last_step_ts": last_step_ts,
        "last_heartbeat_ts": last_hb_ts,
        "phase": phase,
        "phase_since_ts": phase_since,
        "comms_wait_s": comms_wait,
        "collectives": collectives,
        "goodput": g,
    }


def host_table(events: Iterable[dict], *, now: float | None = None
               ) -> list[dict[str, Any]]:
    """Per-host rows, host-index order. ``now`` (default: the HOST
    streams' last timestamp, so a crashed workdir analyzed post-hoc doesn't
    read as "everything stalled for a week") anchors the age fields:
    ``heartbeat_age_s``, ``silence_s``, ``phase_age_s``. Non-host events
    (the supervisor's reap records trail the workers' by seconds) never
    move the anchor — ages compare hosts to each other."""
    events = [e for e in events if "ts" in e]
    by_host = split_hosts(events)
    if not by_host:
        return []
    anchor = (max(float(e["ts"]) for evs in by_host.values() for e in evs)
              if now is None else float(now))
    rows = []
    for h in sorted(by_host):
        row = _fold_host(h, by_host[h])
        row["silence_s"] = max(0.0, anchor - row["last_ts"])
        row["heartbeat_age_s"] = (
            max(0.0, anchor - row["last_heartbeat_ts"])
            if row["last_heartbeat_ts"] is not None else None)
        row["phase_age_s"] = (
            max(0.0, anchor - row["phase_since_ts"])
            if row["phase_since_ts"] is not None else None)
        rows.append(row)
    return rows


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])




def step_skew(events: Iterable[dict]) -> dict[str, Any]:
    """Per-step arrival spread across hosts.

    For each step that EVERY host reported (a ``step_metrics`` or
    ``heartbeat`` carrying ``step``), the skew is the gap between the first
    host to reach it and the last — in lockstep SPMD that gap is pure
    straggling (the fast hosts sat in the collective). Clock jitter between
    hosts rides inside the number, which is why verdicts key on a host
    being *persistently* slowest, not on any single window.

    Returns ``{num_hosts, per_step: [{step, skew_s, fastest_host,
    slowest_host}], max_skew_s, median_skew_s, last_common_step,
    step_lag}`` (``step_lag`` = furthest minus most-behind host's last
    step — nonzero the moment one host stops advancing).
    """
    by_host = split_hosts(e for e in events if "ts" in e)
    arrivals: dict[int, dict[int, float]] = {}  # host -> step -> first ts
    last_steps: dict[int, int] = {}
    for h, evs in by_host.items():
        at: dict[int, float] = {}
        for e in evs:
            if e.get("kind") in ("step_metrics", "heartbeat") \
                    and e.get("step") is not None:
                s = int(e["step"])
                at.setdefault(s, float(e["ts"]))
                last_steps[h] = s
        arrivals[h] = at
    out: dict[str, Any] = {"num_hosts": len(by_host), "per_step": [],
                           "max_skew_s": 0.0, "median_skew_s": 0.0,
                           "last_common_step": None, "step_lag": 0}
    if len(by_host) < 2:
        return out
    common = sorted(set.intersection(*(set(a) for a in arrivals.values())))
    skews: list[float] = []
    for s in common:
        at = {h: arrivals[h][s] for h in arrivals}
        fastest = min(at, key=at.get)
        slowest = max(at, key=at.get)
        skew = at[slowest] - at[fastest]
        skews.append(skew)
        out["per_step"].append({"step": s, "skew_s": skew,
                                "fastest_host": fastest,
                                "slowest_host": slowest})
    if common:
        out["last_common_step"] = common[-1]
        out["max_skew_s"] = max(skews)
        out["median_skew_s"] = _median(skews)
    if last_steps:
        out["step_lag"] = max(last_steps.values()) - min(last_steps.values())
    return out


def straggler_verdict(skew: dict[str, Any], *,
                      min_skew_s: float = 1.0,
                      min_windows: int = 2,
                      persistence: float = 0.5) -> dict[str, Any] | None:
    """A straggler call from a :func:`step_skew` result, or None.

    One host must be the slowest in more than ``persistence`` of the common
    step windows (at least ``min_windows`` of them) with a median skew above
    ``min_skew_s`` — a single slow window is noise (GC pause, checkpoint
    write), a *persistent* slowest host is a sick machine.
    """
    per_step = skew.get("per_step") or []
    if len(per_step) < min_windows:
        return None
    counts: dict[int, int] = {}
    for w in per_step:
        counts[w["slowest_host"]] = counts.get(w["slowest_host"], 0) + 1
    host = max(counts, key=counts.get)
    host_windows = [w for w in per_step if w["slowest_host"] == host]
    frac = counts[host] / len(per_step)
    median_skew = _median([w["skew_s"] for w in host_windows])
    if frac <= persistence or len(host_windows) < min_windows \
            or median_skew < min_skew_s:
        return None
    return {
        "host": host,
        "slow_windows": counts[host],
        "windows": len(per_step),
        "median_skew_s": median_skew,
        "verdict": (f"host {host} slowest in {counts[host]}/{len(per_step)} "
                    f"step windows (median skew {median_skew:.1f}s)"),
    }


def localize_hang(events: Iterable[dict], *, now: float | None = None,
                  stall_factor: float = DEFAULT_STALL_FACTOR,
                  margin_s: float | None = None,
                  rows: list[dict] | None = None,
                  skew: dict[str, Any] | None = None
                  ) -> dict[str, Any] | None:
    """Name the host a hang is stuck IN, or None when no single culprit.

    In a hung gang every stream eventually goes silent — the stuck host
    first (it stopped making progress), the rest when their next collective
    blocked on it. So the culprit is the host whose LAST event is oldest,
    provided it leads every other host's silence by a clear margin: by
    default ``stall_factor`` × the gang's median per-step skew (the
    observed clock-jitter + normal-straggle baseline), floored at
    ``MIN_STALL_MARGIN_S``; override with ``margin_s``. A gang that went
    silent together within that margin (network partition, coordinator
    death) returns None — naming an arbitrary host would send the operator
    to drain a healthy machine.

    A single-host "gang" has no one else to compare against: it is named
    only when its own silence exceeds the margin relative to ``now`` — so
    a healthy or finished run inspected with the default stream-anchored
    ``now`` (silence 0) is never flagged, while the supervisor, calling at
    reap time with wall-clock ``now``, sees the hang dwell and names it.

    Returns ``{host, process, phase, stalled_for_s, since_ts,
    others_at_step, verdict}``; ``stalled_for_s`` is measured from the
    culprit's open INNER phase begin when one exists (restore stuck for
    312s), else from its last event (the outer ``run`` umbrella's begin is
    the attempt's age, not a stall dwell). ``rows``/``skew`` accept a
    precomputed :func:`host_table` / :func:`step_skew` (same events, same
    ``now``) so :func:`fleet_report` folds the stream once, not three
    times.
    """
    events = [e for e in events if "ts" in e]
    if rows is None:
        rows = host_table(events, now=now)
    if not rows:
        return None
    # host-stream anchor, like host_table: the supervisor's trailing reap
    # records must not open a fake silence window on a finished run
    anchor = (float(now) if now is not None
              else max(r["last_ts"] for r in rows))
    if margin_s is None:
        if skew is None:
            skew = step_skew(events)
        margin_s = max(MIN_STALL_MARGIN_S,
                       stall_factor * skew["median_skew_s"])
    if len(rows) == 1:
        culprit, others = rows[0], []
        if anchor - culprit["last_ts"] < margin_s:
            return None  # still streaming (or stream-anchored): no stall
    else:
        by_silence = sorted(rows, key=lambda r: r["last_ts"])
        culprit, others = by_silence[0], by_silence[1:]
        if others[0]["last_ts"] - culprit["last_ts"] < margin_s:
            return None  # everyone went quiet together: no single culprit
    since = culprit["phase_since_ts"] if culprit["phase_since_ts"] is not None \
        else culprit["last_ts"]
    stalled_for = max(0.0, anchor - since)
    others_step = max((r["last_step"] for r in others
                       if r["last_step"] is not None), default=None)
    phase = culprit["phase"]
    verdict = (f"host {culprit['host']} stuck in "
               f"phase={phase or 'unknown'} for {stalled_for:.0f}s")
    if others_step is not None:
        verdict += f", all others waiting at step {others_step}"
    return {
        "host": culprit["host"],
        "process": culprit["process"],
        "phase": phase,
        "stalled_for_s": stalled_for,
        "since_ts": since,
        "others_at_step": others_step,
        "verdict": verdict,
    }


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile over an already-sorted list (no numpy — the
    reader side must stay importable without the training stack). The ONE
    percentile definition: ``status.py`` and ``dlserve`` both import it,
    so CLI-printed and rollup p50/p99 can never drift."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def replica_p99(events: Iterable[dict]) -> dict[str, dict[str, Any]]:
    """Per-replica p99 over ok requests: ``{process: {p99_s, requests}}``.

    The ONE per-replica latency fold: the health engine's worst-replica
    naming, its ``request_p99_s{replica=}`` series samples, and the SLO
    rule's evidence all read this, so a windowed caller passes the same
    window-filtered events everywhere."""
    by_proc: dict[str, list[float]] = {}
    for e in events:
        if (e.get("kind") == "request" and e.get("outcome") == "ok"
                and e.get("latency_s") is not None):
            by_proc.setdefault(str(e.get("process")), []).append(
                float(e["latency_s"]))
    out: dict[str, dict[str, Any]] = {}
    for proc, lats in sorted(by_proc.items()):
        p99 = _percentile(sorted(lats), 0.99)
        if p99 is not None:
            out[proc] = {"p99_s": p99, "requests": len(lats)}
    return out


#: gauge keys a replica row copies from its newest ``serve`` gauge, when
#: present. Part of the :func:`serving_fleet` row CONTRACT (below) — the
#: health engine and the future autoscaler read ``queue_depth`` and
#: ``kv_page_occupancy`` from health.json, so removing or renaming one is
#: a schema break the stability test pins.
SERVE_GAUGE_KEYS = (
    "kv_pages_total", "kv_pages_used", "kv_page_occupancy",
    "prefix_hits", "prefix_misses", "prefix_hit_rate",
    "prefix_tokens_saved", "active", "queue_depth", "params_version")

#: request-fold keys every :func:`serving_fleet` replica row carries
#: unconditionally (the gauge keys above join only when a gauge reported
#: them). Exported so the stability test and the docs pin ONE list.
SERVE_ROW_BASE_KEYS = (
    "requests", "ok", "shed", "errors", "shed_rate",
    "latency_p50_s", "latency_p99_s", "requests_per_s", "engines")


def _fold_serving(reqs: list[dict], gauges: list[dict]) -> dict[str, Any]:
    """One serving row from request events + the newest ``serve`` gauge."""
    ok = [e for e in reqs if e.get("outcome") == "ok"]
    lat = sorted(float(e["latency_s"]) for e in ok
                 if e.get("latency_s") is not None)
    span = (float(reqs[-1]["ts"]) - float(reqs[0]["ts"])) if reqs else 0.0
    row = {
        "requests": len(reqs),
        "ok": len(ok),
        "shed": sum(e.get("outcome") == "shed" for e in reqs),
        "errors": sum(e.get("outcome") == "error" for e in reqs),
        "shed_rate": (sum(e.get("outcome") == "shed" for e in reqs)
                      / len(reqs)) if reqs else None,
        "latency_p50_s": _percentile(lat, 0.50),
        "latency_p99_s": _percentile(lat, 0.99),
        "requests_per_s": (len(ok) / span) if span > 0 else None,
        "engines": sorted({str(e["engine"]) for e in reqs
                           if e.get("engine") is not None}),
    }
    if gauges:
        g = gauges[-1]  # latest snapshot answers "what is the state NOW"
        row.update({k: g.get(k) for k in SERVE_GAUGE_KEYS
                    if g.get(k) is not None})
    return row


def serving_fleet(events: Iterable[dict]) -> dict[str, Any] | None:
    """Per-replica serving rollup (what ``dlstatus --fleet-serve`` renders).

    Replica identity is the writer ``process`` field — the fleet launcher
    exports ``DLS_PROCESS_ID`` per replica, so replica k's events are
    ``p<k>``'s; the router's tenant-budget sheds ride under its own
    ``router`` process row. Each row folds that process's ``request``
    events (p50/p99, shed rate, throughput) with its newest ``serve``
    gauge (KV page occupancy, prefix-cache hit rate, active slots).
    None when the run served nothing."""
    events = [e for e in events if "ts" in e]
    reqs = [e for e in events if e.get("kind") == "request"]
    gauges = [e for e in events if e.get("kind") == "serve"]
    if not reqs and not gauges:
        return None
    procs: dict[str, dict[str, list]] = {}
    for e in reqs:
        procs.setdefault(str(e.get("process")), {"r": [], "g": []})["r"].append(e)
    for e in gauges:
        procs.setdefault(str(e.get("process")), {"r": [], "g": []})["g"].append(e)
    replicas = []
    for proc in sorted(procs):
        row = _fold_serving(procs[proc]["r"], procs[proc]["g"])
        row["process"] = proc
        replicas.append(row)
    totals = _fold_serving(reqs, [])
    totals.pop("engines", None)
    # fleet-level cache/arena view: sums of the per-replica counters, and
    # the worst (highest) page occupancy — the replica closest to paging
    # pressure is the one an operator acts on
    hits = sum(r.get("prefix_hits", 0) or 0 for r in replicas)
    misses = sum(r.get("prefix_misses", 0) or 0 for r in replicas)
    totals["prefix_hits"] = hits
    totals["prefix_misses"] = misses
    totals["prefix_hit_rate"] = (round(hits / (hits + misses), 4)
                                 if hits + misses else None)
    totals["prefix_tokens_saved"] = sum(
        r.get("prefix_tokens_saved", 0) or 0 for r in replicas)
    occ = [r["kv_page_occupancy"] for r in replicas
           if r.get("kv_page_occupancy") is not None]
    totals["kv_page_occupancy_max"] = max(occ) if occ else None
    # router-level accounting the replica rows can't see: failover hops
    # (a replica died mid-request and the router re-dispatched — counted
    # from its `failover` spans) and per-tenant shed rates (tenant-budget
    # sheds carry `tenant` on the router's request events; completed
    # requests carry it on their root span)
    spans = [e for e in events if e.get("kind") == "span"]
    totals["failovers"] = sum(e.get("name") == "failover" for e in spans)
    tenants: dict[str, dict] = {}

    def _tenant_row(t: str) -> dict:
        return tenants.setdefault(
            str(t), {"requests": 0, "ok": 0, "shed": 0, "errors": 0})

    for e in spans:
        if e.get("name") != "request" or e.get("parent_id"):
            continue
        attrs = e.get("attrs") or {}
        if attrs.get("tenant") is None:
            continue
        row = _tenant_row(attrs["tenant"])
        row["requests"] += 1
        oc = attrs.get("outcome")
        if oc == "ok":
            row["ok"] += 1
        elif oc == "shed":
            row["shed"] += 1
        else:
            row["errors"] += 1
    for e in reqs:
        if e.get("outcome") == "shed" and e.get("tenant") is not None:
            row = _tenant_row(e["tenant"])
            row["requests"] += 1
            row["shed"] += 1
    for row in tenants.values():
        row["shed_rate"] = (round(row["shed"] / row["requests"], 4)
                            if row["requests"] else None)
    totals["tenants"] = tenants or None
    return {"replicas": replicas, "totals": totals}


def latency_anatomy(events: Iterable[dict], *, slow_n: int = 3
                    ) -> dict[str, Any] | None:
    """Per-stage latency decomposition from request traces — what
    ``dlstatus --traces`` renders.

    Folds :func:`~.trace.request_anatomy` into: per-stage p50/p99 across
    all requests, the same broken out per writing process (replica), the
    median stage coverage (Σ stages / e2e — how much of the latency the
    decomposition explains), and the ``slow_n`` slowest complete requests
    as exemplar records (their full stage spans, for the tree render).
    Incomplete traces (crash mid-request) are counted, never fatal. None
    when the run has no request traces."""
    from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib

    events = [e for e in events if "ts" in e]
    reqs = trace_lib.request_anatomy(events)
    if not reqs:
        return None
    complete = [r for r in reqs if not r["incomplete"]
                and r["e2e_s"] is not None]
    # the latency pools fold SERVED requests only: a shed's root-only
    # trace (closed root, zero stage spans, few-ms e2e) is complete but
    # would drag coverage toward 0 and p50 toward 0 exactly during the
    # shed-heavy incident the operator is debugging
    served = [r for r in complete if r["outcome"] == "ok" and r["stages"]]

    def _stage_fold(rows: list[dict]) -> dict[str, dict]:
        by_name: dict[str, list[float]] = {}
        for r in rows:
            for name, dur in r["stages"].items():
                by_name.setdefault(name, []).append(dur)
        return {
            name: {"count": len(durs),
                   "p50_s": _percentile(sorted(durs), 0.50),
                   "p99_s": _percentile(sorted(durs), 0.99),
                   "total_s": sum(durs)}
            for name, durs in sorted(by_name.items())}

    by_proc: dict[str, list[dict]] = {}
    for r in reqs:
        procs = {s["process"] for s in r["stage_spans"]
                 if s["process"] is not None}
        for p in procs:
            sub = {"stages": {}}
            for s in r["stage_spans"]:
                if s["process"] == p and s["dur_s"] is not None:
                    sub["stages"][s["name"]] = (
                        sub["stages"].get(s["name"], 0.0) + s["dur_s"])
            by_proc.setdefault(str(p), []).append(sub)
    e2e = sorted(r["e2e_s"] for r in served)
    coverage = sorted(r["coverage"] for r in served
                      if r["coverage"] is not None)
    slowest = sorted(served, key=lambda r: -r["e2e_s"])[:slow_n]
    return {
        "requests": len(reqs),
        "complete": len(complete),
        "incomplete": len(reqs) - len(complete),
        "e2e_p50_s": _percentile(e2e, 0.50),
        "e2e_p99_s": _percentile(e2e, 0.99),
        "coverage_median": _percentile(coverage, 0.50),
        "stages": _stage_fold(served),
        "per_process": {p: _stage_fold(rows)
                        for p, rows in sorted(by_proc.items())},
        "slowest": slowest,
    }


#: burn-rate ladder for the SLO verdict: spending the error budget at
#: ≤1× is sustainable (GOOD); above it the budget is BURNING; at ≥10×
#: the period's budget is effectively gone (EXHAUSTED) — the SRE-workbook
#: fast-burn threshold shape.
SLO_EXHAUST_BURN = 10.0

#: exact key set of every :func:`slo_report` tenant row and the totals row —
#: a CONTRACT, not documentation: ``health.json`` copies ``burn_rate``/
#: ``violation_frac``/``verdict`` per tenant and the future autoscaler
#: scales on ``burn_rate``, so a rename here silently breaks machine
#: consumers. The stability test pins this tuple against a live fold;
#: extending the row means extending the tuple (append-only).
SLO_ROW_KEYS = ("requests", "ok", "shed", "errors", "slow", "violations",
                "violation_frac", "burn_rate", "p99_s", "verdict")


def slo_report(events: Iterable[dict], *, target_p99_s: float,
               budget: float = 0.01,
               exhaust_burn: float = SLO_EXHAUST_BURN) -> dict[str, Any] | None:
    """Judge served traffic against a latency SLO — ``dlstatus --slo``.

    A request **violates** when it was shed, errored, or completed slower
    than ``target_p99_s``. ``budget`` is the violation fraction the SLO
    tolerates (0.01 = "99% of requests in target"); the **burn rate** is
    ``violation_frac / budget`` — 1.0 means spending exactly the budget.
    Verdicts: ``GOOD`` (≤1×), ``BURNING`` (>1×), ``EXHAUSTED``
    (≥``exhaust_burn``× — the error budget for the observed window is
    gone many times over; page, don't ticket).

    Attribution: completed requests come from root ``request`` spans when
    the run was traced (they carry ``tenant``/``outcome``/duration);
    tenant-budget sheds from the router's ``request`` events. An untraced
    run (no spans) falls back to plain ``request`` events under one
    ``default`` tenant, so the sentinel still judges a bare single-engine
    run. None when nothing was served."""
    events = [e for e in events if "ts" in e]
    roots = [e for e in events
             if e.get("kind") == "span" and e.get("name") == "request"
             and not e.get("parent_id") and e.get("t1") is not None]
    reqs = [e for e in events if e.get("kind") == "request"]
    tenants: dict[str, dict] = {}

    def row(t) -> dict:
        return tenants.setdefault(str(t), {
            "requests": 0, "ok": 0, "shed": 0, "errors": 0, "slow": 0,
            "lat": []})

    if roots:
        for e in roots:
            attrs = e.get("attrs") or {}
            r = row(attrs.get("tenant") or "default")
            r["requests"] += 1
            oc = attrs.get("outcome")
            if oc == "shed":
                r["shed"] += 1
            elif oc != "ok":
                r["errors"] += 1
            else:
                lat = max(0.0, float(e["t1"]) - float(e["t0"]))
                r["lat"].append(lat)
                if lat > target_p99_s:
                    r["slow"] += 1
                else:
                    r["ok"] += 1
        # sheds that never became traces: the router's tenant-budget
        # rejections (pre-dispatch, carry `tenant`) and a bare engine's
        # queue-full sheds (no router, no trace — a traced run of a bare
        # engine must still see its own overload). Replica-side sheds
        # INSIDE a traced fleet request carry `trace`: their root span
        # already counted the violation, so they are skipped here.
        for e in reqs:
            if e.get("outcome") == "shed" and e.get("trace") is None:
                r = row(e.get("tenant") or "default")
                r["requests"] += 1
                r["shed"] += 1
    else:
        for e in reqs:
            r = row(e.get("tenant") or "default")
            r["requests"] += 1
            oc = e.get("outcome")
            if oc == "shed":
                r["shed"] += 1
            elif oc == "error":
                r["errors"] += 1
            elif e.get("latency_s") is not None:
                lat = float(e["latency_s"])
                r["lat"].append(lat)
                if lat > target_p99_s:
                    r["slow"] += 1
                else:
                    r["ok"] += 1
            else:
                r["ok"] += 1
    if not tenants:
        return None

    def judge(r: dict) -> dict:
        violations = r["shed"] + r["errors"] + r["slow"]
        frac = violations / r["requests"] if r["requests"] else 0.0
        burn = (frac / budget if budget > 0
                else (float("inf") if frac else 0.0))
        verdict = ("GOOD" if burn <= 1.0
                   else "EXHAUSTED" if burn >= exhaust_burn else "BURNING")
        lat = sorted(r.pop("lat"))
        return {
            **r,
            "violations": violations,
            "violation_frac": round(frac, 4),
            "burn_rate": round(burn, 2),
            "p99_s": _percentile(lat, 0.99),
            "verdict": verdict,
        }

    # the TOTAL row goes through the same judge() as every tenant — one
    # verdict ladder, never two copies that can drift. Accumulate before
    # judging: judge() consumes each row's lat list.
    total = {"requests": 0, "ok": 0, "shed": 0, "errors": 0, "slow": 0,
             "lat": []}
    for r in tenants.values():
        for k in ("requests", "ok", "shed", "errors", "slow"):
            total[k] += r[k]
        total["lat"].extend(r["lat"])
    per_tenant = {t: judge(r) for t, r in sorted(tenants.items())}
    totals = judge(total)
    return {
        "target_p99_s": target_p99_s,
        "budget": budget,
        "tenants": per_tenant,
        "totals": totals,
    }


def fleet_report(events: Iterable[dict], *, now: float | None = None
                 ) -> dict[str, Any]:
    """The full pod-level report (what ``dlstatus --hosts`` renders).

    ``now`` anchors the age fields AND the hang margin — pass wall-clock
    for a live run, leave None for a post-mortem on a copied-out workdir.
    Expected host count comes from the writers' own ``hosts`` stamp, so a
    host that never wrote a single event still shows up as missing.
    """
    events = [e for e in events if "ts" in e]
    rows = host_table(events, now=now)
    expected = max((int(e.get("hosts", 0)) for e in events
                    if isinstance(e.get("hosts"), int)), default=0)
    expected = max(expected, len(rows))
    missing = sorted(set(range(expected)) - {r["host"] for r in rows}) \
        if expected else []
    skew = step_skew(events)
    return {
        "num_hosts": len(rows),
        "expected_hosts": expected,
        "missing_hosts": missing,
        "hosts": rows,
        "skew": skew,
        "straggler": straggler_verdict(skew),
        "hang": localize_hang(events, now=now, rows=rows, skew=skew),
    }


# -- MPMD pipeline anatomy (bubble accounting) --------------------------------

#: span names of the pipeline trainer (train/pipeline_trainer.py): busy =
#: the stage was computing; wait = it sat on the transport. A step's
#: bubble is 1 − busy/wall per stage — what the (P−1)/(M+P−1) bound caps.
PIPE_BUSY_SPANS = ("pipe-fwd", "pipe-bwd", "pipe-loss", "pipe-embed",
                   "pipe-embed-bwd", "pipe-opt")
PIPE_WAIT_SPANS = ("pipe-recv-wait", "pipe-send-wait")
PIPE_STEP_SPAN = "pipe-step"


def pipeline_anatomy(events: Iterable[dict]) -> dict[str, Any] | None:
    """Fold pipeline spans into per-stage busy/wait anatomy and the
    measured bubble fraction vs. the theoretical (P−1)/(M+P−1) bound —
    the ``dlstatus --traces`` pipeline block.

    Per (stage, step): ``wall`` = that stage's ``pipe-step`` span,
    ``busy`` = Σ of its compute spans, bubble = 1 − busy/wall. The run's
    ``measured_bubble_frac`` averages over stages and steps, EXCLUDING
    warmup: the first observed step (jit compiles inside the first
    fwd/bwd/loss spans) and any step whose wall exceeds 5× the median
    (a mid-run recompile after a stage restart looks exactly like that).
    None when the stream has no pipeline spans."""
    from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib

    spans = [s for s in trace_lib.spans_of(events)
             if str(s.get("name", "")).startswith("pipe-")
             or s.get("name") == "microbatch"]
    steps = [s for s in spans if s.get("name") == PIPE_STEP_SPAN
             and s.get("t1") is not None]
    if not steps:
        return None

    def attr(s, key, default=None):
        return (s.get("attrs") or {}).get(key, default)

    m = max((int(attr(s, "m", 0) or 0) for s in steps), default=0)
    p = max((int(attr(s, "p", 0) or 0) for s in steps), default=0)
    schedule = next((attr(s, "schedule") for s in steps
                     if attr(s, "schedule")), None)
    # (stage, step) -> {wall, busy, wait, fwd, bwd, ...}
    cells: dict[tuple[int, int], dict[str, float]] = {}
    for s in steps:
        stage, step = int(attr(s, "stage", -1)), int(attr(s, "step", -1))
        wall = max(0.0, float(s["t1"]) - float(s["t0"]))
        cell = cells.setdefault((stage, step), {"busy": 0.0, "wait": 0.0})
        cell["wall"] = cell.get("wall", 0.0) + wall
    for s in spans:
        name = s.get("name")
        if s.get("t1") is None or name == PIPE_STEP_SPAN:
            continue
        stage, step = int(attr(s, "stage", -1)), int(attr(s, "step", -1))
        cell = cells.get((stage, step))
        if cell is None:
            continue
        dur = max(0.0, float(s["t1"]) - float(s["t0"]))
        if name in PIPE_BUSY_SPANS:
            cell["busy"] += dur
            cell[name] = cell.get(name, 0.0) + dur
        elif name in PIPE_WAIT_SPANS:
            cell["wait"] += dur
            cell[name] = cell.get(name, 0.0) + dur
    all_steps = sorted({step for _, step in cells})
    warmup = {all_steps[0]} if all_steps else set()
    walls = sorted(c["wall"] for (st, sp), c in cells.items()
                   if sp not in warmup and c.get("wall"))
    wall_cap = 5.0 * _median(walls) if walls else float("inf")
    judged = {k: c for k, c in cells.items()
              if k[1] not in warmup and 0.0 < c.get("wall", 0.0) <= wall_cap}
    skipped = len(cells) - len(judged)
    bubbles = [max(0.0, min(1.0, 1.0 - c["busy"] / c["wall"]))
               for c in judged.values()]
    measured = (sum(bubbles) / len(bubbles)) if bubbles else None
    theoretical = ((p - 1) / float(m + p - 1)) if m and p else None
    stages: dict[str, dict] = {}
    for stage in sorted({st for st, _ in cells}):
        mine = [c for (st, _), c in judged.items() if st == stage]
        if not mine:
            mine = [c for (st, _), c in cells.items() if st == stage]
        tot = {k: round(sum(c.get(k, 0.0) for c in mine), 6)
               for k in ("wall", "busy", "wait", "pipe-fwd", "pipe-bwd",
                         "pipe-loss", "pipe-embed", "pipe-embed-bwd",
                         "pipe-opt", "pipe-recv-wait", "pipe-send-wait")}
        stages[str(stage)] = {
            "steps": len(mine),
            "wall_s": tot["wall"],
            "busy_s": tot["busy"],
            "wait_s": tot["wait"],
            "fwd_s": tot["pipe-fwd"],
            "bwd_s": tot["pipe-bwd"],
            "loss_s": tot["pipe-loss"] + tot["pipe-embed"]
            + tot["pipe-embed-bwd"] + tot["pipe-opt"],
            "recv_wait_s": tot["pipe-recv-wait"],
            "send_wait_s": tot["pipe-send-wait"],
            "bubble_frac": (round(1.0 - tot["busy"] / tot["wall"], 4)
                            if tot["wall"] > 0 else None),
        }
    mbs = [s for s in spans if s.get("name") == "microbatch"
           and s.get("t1") is not None]
    return {
        "m": m or None,
        "p": p or None,
        "schedule": schedule,
        "steps": len(all_steps),
        "steps_judged": len({k[1] for k in judged}),
        "cells_skipped_warmup_or_outlier": skipped,
        "microbatch_traces": len(mbs),
        "measured_bubble_frac": (round(measured, 4)
                                 if measured is not None else None),
        "theoretical_bubble_frac": (round(theoretical, 4)
                                    if theoretical is not None else None),
        "stages": stages,
    }

"""Continuous health engine — one evaluated ruleset over the event stream.

The port's copy of ``distributeddeeplearningspark_tpu/telemetry/health.py``,
the rules, the engine and the incident timeline as they are; the
multi-workdir :func:`cluster_report` and the scheduler's ledger it reads
are refused by name (:data:`CLUSTER_NOT_PORTED`) until the scheduler is
ported. The JAX module's account follows.

Every report surface before this module (goodput accountant, per-host
fleet table, SLO sentinel, latency anatomy, compile/MFU/HBM anatomy,
shuffle recovery rollup, resharding, supervisor attempts) is a one-shot,
one-workdir, human-read verdict. Nothing watched the stream continuously,
nothing emitted a durable signal when a verdict *flipped*, and nothing saw
across workdirs — exactly what the SLO autoscaler, the multi-tenant
scheduler, and the online production loop need. This module closes that
gap in three layers, all pure folds over the same JSONL stream:

- :func:`evaluate_health` — run the RULES registry over an event stream
  once and assemble the machine-readable health report (per-rule raw
  verdicts, burn rate, per-replica queue depth, per-tenant rows,
  worst-severity rollup). One-shot, stateless: what ``dlstatus --health``
  and the cluster view call.
- :class:`HealthEngine` — the continuous wrapper: an incremental
  :class:`~.EventCursor` read per tick, **flap damping** (a rule must hold
  its new state for ``damping`` consecutive evaluations before the edge
  emits, so a jittery SLO doesn't storm the bus), ``alert`` telemetry
  events on every confirmed state *transition* (raise/clear edge, dedup
  key — one live alert per key, identical re-raises emit nothing), and an
  atomic rewrite of ``<workdir>/health.json`` (schema-versioned, the
  contract consumers parse instead of JSONL).
- :func:`incident_timeline` / :func:`cluster_report` — the fold of alert
  edges + ``recovery`` events + failed supervisor attempts into the
  ordered "what happened, attributed to whom" view (``dlstatus
  --incidents``), and the multi-workdir fold ``dlstatus --cluster``
  renders (per-tenant/per-job goodput, serve occupancy, worst alert,
  heartbeat age).

Severity is a three-rung ladder: ``OK`` < ``WARN`` < ``CRIT``. Rules wrap
the existing producers rather than re-deriving them — the SLO rule maps
the sentinel's GOOD/BURNING/EXHAUSTED ladder, the hang rule wraps
:func:`~.fleet.localize_hang`, the HBM rule reads the anatomy fold — so
there is ONE severity policy and the render surfaces stay byte-stable.

Rate-shaped rules (SLO burn, shed rate, restart storms, shuffle retries)
judge only the trailing ``window_s`` of *event time*, so a clean rerun
appended to a workdir genuinely clears the alert; structural rules (hang,
missing hosts, degraded stream, recompiles) judge the whole stream.

Like the rest of the reader side: no jax import, works on a crashed run's
partial stream, and a workdir whose only events are a torn mid-rotation
segment is reported as *parseable-but-degraded* (a WARN with evidence),
never a crash.
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from typing import Any, Callable, Iterable

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.telemetry import anatomy as anatomy_lib
from distributeddeeplearningspark_tpu_torch.telemetry import fleet as fleet_lib
from distributeddeeplearningspark_tpu_torch.telemetry import series as series_lib

#: schema version stamped into every health.json — consumers MUST check it;
#: any key removal/rename bumps it (additions don't).
HEALTH_SCHEMA = 1

#: the machine contract file, rewritten atomically on every evaluation.
HEALTH_FILENAME = "health.json"

#: severity ladder (rollups take the max).
SEVERITIES = ("OK", "WARN", "CRIT")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

#: env knobs (read at evaluation time so a live engine retunes on restart).
DAMPING_ENV = "DLS_HEALTH_DAMPING"              # default 3 evaluations
WINDOW_ENV = "DLS_HEALTH_WINDOW_S"              # default 300s of event time
SLO_TARGET_ENV = "DLS_HEALTH_SLO_P99_S"         # no default: rule off unless set
HB_WARN_ENV = "DLS_HEALTH_HB_WARN_S"            # default 60s
HB_CRIT_ENV = "DLS_HEALTH_HB_CRIT_S"            # default 300s
QUEUE_WARN_ENV = "DLS_HEALTH_QUEUE_WARN"        # default 8 waiting requests
QUEUE_CRIT_ENV = "DLS_HEALTH_QUEUE_CRIT"        # default 32
SHED_WARN_ENV = "DLS_HEALTH_SHED_WARN"          # default 0.05
SHED_CRIT_ENV = "DLS_HEALTH_SHED_CRIT"          # default 0.25
GOODPUT_WARN_ENV = "DLS_HEALTH_GOODPUT_WARN"    # default 0.5 fraction
TREND_N_ENV = "DLS_HEALTH_TREND_N"              # default 3 consecutive moves
STEPS_DROP_ENV = "DLS_HEALTH_STEPS_DROP"        # default 0.15 below peak


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def worst_severity(severities: Iterable[str]) -> str:
    worst = "OK"
    for s in severities:
        if _SEV_RANK.get(s, 0) > _SEV_RANK[worst]:
            worst = s
    return worst


def _json_safe(obj):
    """Non-finite floats -> None (health.json must be strict JSON — the
    same NaN hazard :mod:`..status` documents: divergence incidents put
    real NaNs in evidence dicts)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _verdict(rule: str, key: str, severity: str, summary: str,
             **evidence: Any) -> dict[str, Any]:
    return {"rule": rule, "key": key, "severity": severity,
            "summary": summary, "evidence": evidence}


# -- the ruleset --------------------------------------------------------------
#
# Each rule is ``fn(ctx) -> list[verdict]`` where a verdict names its dedup
# ``key`` (one live alert per key: ``slo:tenant0``, ``hang:host2``), its
# ``severity``, a one-line operator ``summary``, and the measured
# ``evidence`` behind it. A rule that is healthy returns [] — the engine
# treats every key it doesn't mention as OK. ``ctx`` carries the stream and
# the producer folds computed ONCE per evaluation (see _build_ctx).


def _rule_stream(ctx: dict) -> list[dict]:
    """Parseable-but-degraded stream: event files exist but nothing in them
    parses (a crashed run's partial segment mid-rotation). WARN — the
    workdir is observable (the files say a run was here) but blind."""
    st = ctx["stream"]
    if st["files"] and not st["events"]:
        return [_verdict(
            "stream", "stream:degraded", "WARN",
            f"{st['files']} event file(s) but 0 parseable events — "
            f"degraded stream (crashed run's partial segment?)",
            files=st["files"], skipped_lines=st["skipped_lines"])]
    return []


def _rule_heartbeat(ctx: dict) -> list[dict]:
    """Stale heartbeat on a run that never closed its ``run`` phase.

    A finished run (every ``run`` span ended) stops heartbeating forever
    and must not alarm; an open run whose heartbeats age past the
    thresholds is dying or wedged. Age is measured against the
    evaluation's ``now`` anchor, so a stream-anchored post-mortem (age≈0
    at stream end) stays quiet and a wall-clock engine sees the dwell."""
    hbs = [e for e in ctx["events"] if e.get("kind") == "heartbeat"]
    if not hbs:
        return []
    open_runs = 0
    for e in ctx["events"]:
        if e.get("kind") == "phase" and e.get("name") == "run":
            open_runs += 1 if e.get("edge") == "begin" else -1
    if open_runs <= 0:
        return []
    age = ctx["now"] - float(hbs[-1]["ts"])
    warn = _env_float(HB_WARN_ENV, 60.0)
    crit = _env_float(HB_CRIT_ENV, 300.0)
    if age < warn:
        return []
    sev = "CRIT" if age >= crit else "WARN"
    return [_verdict(
        "heartbeat", "heartbeat:run", sev,
        f"last heartbeat {age:.0f}s ago with the run phase still open",
        age_s=round(age, 1), last_step=hbs[-1].get("step"),
        warn_s=warn, crit_s=crit)]


def _rule_hosts(ctx: dict) -> list[dict]:
    """A host the writers' own gang-size stamp expected never reported."""
    fl = ctx["fleet"]
    if not fl or not fl["missing_hosts"]:
        return []
    missing = fl["missing_hosts"]
    return [_verdict(
        "hosts", "hosts:missing", "CRIT",
        f"{len(missing)}/{fl['expected_hosts']} host(s) never reported: "
        f"{missing}",
        missing_hosts=missing, expected_hosts=fl["expected_hosts"],
        reporting=fl["num_hosts"])]


def _rule_hang(ctx: dict) -> list[dict]:
    """The fleet fold localized a hang to one host -> CRIT naming it."""
    fl = ctx["fleet"]
    hang = fl and fl.get("hang")
    if not hang:
        return []
    # the localizer's margin floors at seconds — right for the
    # supervisor's reap-time call (the gang is already dead) but a live
    # wall-clock engine must not page on a quiet-but-healthy stream, so
    # the dwell has to clear the heartbeat WARN threshold first
    if hang["stalled_for_s"] < _env_float(HB_WARN_ENV, 60.0):
        return []
    return [_verdict(
        "hang", f"hang:host{hang['host']}", "CRIT", hang["verdict"],
        host=hang["host"], process=hang["process"], phase=hang["phase"],
        stalled_for_s=round(hang["stalled_for_s"], 1),
        others_at_step=hang["others_at_step"])]


def _rule_straggler(ctx: dict) -> list[dict]:
    """A persistent slowest host (the gang runs at its pace) -> WARN."""
    fl = ctx["fleet"]
    st = fl and fl.get("straggler")
    if not st:
        return []
    return [_verdict(
        "straggler", f"straggler:host{st['host']}", "WARN", st["verdict"],
        host=st["host"], slow_windows=st["slow_windows"],
        windows=st["windows"], median_skew_s=st["median_skew_s"])]


def _rule_slo(ctx: dict) -> list[dict]:
    """Per-tenant SLO burn over the trailing window: the sentinel's ladder
    mapped onto severities (BURNING -> WARN, EXHAUSTED -> CRIT), with the
    worst replica named from per-replica windowed p99 so a CRIT is
    actionable without a second query."""
    slo = ctx["slo"]
    if not slo:
        return []
    out = []
    for tenant, row in slo["tenants"].items():
        if row["verdict"] == "GOOD":
            continue
        sev = "CRIT" if row["verdict"] == "EXHAUSTED" else "WARN"
        worst = ctx["worst_replica"]
        summary = (
            f"tenant {tenant} burning error budget at {row['burn_rate']}x "
            f"({row['violations']}/{row['requests']} violations, p99 "
            f"{row['p99_s']:.3f}s vs {slo['target_p99_s']:.3f}s target)"
            if row["p99_s"] is not None else
            f"tenant {tenant} burning error budget at {row['burn_rate']}x "
            f"({row['violations']}/{row['requests']} violations)")
        if worst:
            summary += (f"; worst replica {worst['process']} "
                        f"(p99 {worst['p99_s']:.3f}s)")
        out.append(_verdict(
            "slo", f"slo:{tenant}", sev, summary,
            tenant=tenant, burn_rate=row["burn_rate"],
            violation_frac=row["violation_frac"], p99_s=row["p99_s"],
            target_p99_s=slo["target_p99_s"], verdict=row["verdict"],
            worst_replica=(worst or {}).get("process"),
            worst_replica_p99_s=(worst or {}).get("p99_s")))
    return out


def _rule_queue(ctx: dict) -> list[dict]:
    """Per-replica queue depth from the newest ``serve`` gauge — the
    backlog signal the autoscaler scales on, alarmed here first."""
    warn = _env_float(QUEUE_WARN_ENV, 8.0)
    crit = _env_float(QUEUE_CRIT_ENV, 32.0)
    out = []
    for proc, depth in sorted(ctx["queue_depth"].items()):
        if depth is None or depth < warn:
            continue
        sev = "CRIT" if depth >= crit else "WARN"
        out.append(_verdict(
            "queue", f"queue:{proc}", sev,
            f"replica {proc} queue depth {depth:.0f} "
            f"(warn≥{warn:.0f}, crit≥{crit:.0f})",
            process=proc, queue_depth=depth, warn=warn, crit=crit))
    return out


def _rule_shed(ctx: dict) -> list[dict]:
    """Fleet-wide shed rate over the trailing window (per-tenant sheds are
    the SLO rule's job; this one catches an untenanted overload)."""
    reqs = [e for e in ctx["window_events"] if e.get("kind") == "request"]
    if not reqs:
        return []
    shed = sum(e.get("outcome") == "shed" for e in reqs)
    rate = shed / len(reqs)
    warn = _env_float(SHED_WARN_ENV, 0.05)
    crit = _env_float(SHED_CRIT_ENV, 0.25)
    if rate < warn:
        return []
    sev = "CRIT" if rate >= crit else "WARN"
    return [_verdict(
        "shed", "shed:fleet", sev,
        f"shedding {100.0 * rate:.1f}% of requests "
        f"({shed}/{len(reqs)} in window)",
        shed=shed, requests=len(reqs), shed_rate=round(rate, 4))]


def _rule_recompile(ctx: dict) -> list[dict]:
    """The compile ledger flagged recompiles (a signature compiled twice,
    or more signatures than the wrapper pinned) -> WARN naming the fns."""
    an = ctx["anatomy"]
    cl = an and an.get("compile_ledger")
    if not cl or not cl.get("flagged_recompiles"):
        return []
    fns = sorted(fn for fn, row in cl["by_fn"].items()
                 if row["flagged_recompiles"])
    return [_verdict(
        "recompile", "recompile:ledger", "WARN",
        f"{cl['flagged_recompiles']} flagged recompile(s) in {fns} "
        f"({cl['total_compile_s']:.1f}s total compile)",
        flagged_recompiles=cl["flagged_recompiles"], fns=fns,
        total_compile_s=cl["total_compile_s"])]


def _rule_hbm(ctx: dict) -> list[dict]:
    """HBM headroom from the allocator watermarks (memory_stats source
    only — the live-buffer CPU fallback has no limit to judge against)."""
    an = ctx["anatomy"]
    mem = an and an.get("memory")
    if not mem or mem.get("source") != "memory_stats":
        return []
    headroom = mem.get("headroom_bytes")
    limit = mem.get("bytes_limit_min")
    if headroom is None or not limit:
        return []
    frac = headroom / float(limit)
    if frac >= 0.10:
        return []
    sev = "CRIT" if frac < 0.05 else "WARN"
    return [_verdict(
        "hbm", "hbm:headroom", sev,
        f"HBM headroom {100.0 * frac:.1f}% of limit "
        f"({headroom / 2**30:.2f}GiB free)",
        headroom_bytes=headroom, bytes_limit_min=limit,
        headroom_frac=round(frac, 4))]


def _rule_restarts(ctx: dict) -> list[dict]:
    """A restart storm in the window: one restart is the supervisor doing
    its job; repeated ones mean the fault survives the remedy."""
    restarts = [e for e in ctx["window_events"]
                if e.get("kind") == "recovery"
                and e.get("event") in ("restart", "geometry_change")]
    if len(restarts) < 2:
        return []
    sev = "CRIT" if len(restarts) >= 4 else "WARN"
    classes = sorted({str(e.get("classification"))
                      for e in restarts if e.get("classification")})
    return [_verdict(
        "restarts", "restarts:storm", sev,
        f"{len(restarts)} restart/geometry event(s) in the last "
        f"{ctx['window_s']:.0f}s ({', '.join(classes) or 'unclassified'})",
        restarts=len(restarts), classifications=classes,
        window_s=ctx["window_s"])]


def _rule_shuffle(ctx: dict) -> list[dict]:
    """Shuffle self-healing churn in the window: retries/speculations are
    absorbed faults; a blacklist or a retry pile-up is worth a WARN
    before it escalates to WorkerCrashed."""
    retries = blacklists = 0
    for e in ctx["window_events"]:
        if e.get("kind") != "shuffle":
            continue
        if e.get("edge") == "retry":
            retries += 1
        elif e.get("edge") == "blacklist":
            blacklists += 1
    if blacklists == 0 and retries < 3:
        return []
    return [_verdict(
        "shuffle", "shuffle:recovery", "WARN",
        f"shuffle recovery churn: {retries} retry(ies), "
        f"{blacklists} blacklist(s) in window",
        retries=retries, blacklists=blacklists)]


def _rule_goodput(ctx: dict) -> list[dict]:
    """Whole-stream goodput floor, gated on enough wall-clock that the
    startup compile can't dominate the fraction."""
    g = ctx["goodput"]
    floor = _env_float(GOODPUT_WARN_ENV, 0.5)
    has_steps = any(e.get("kind") == "step_metrics" for e in ctx["events"])
    if not has_steps or g["wall_s"] < 120.0 or g["goodput_frac"] >= floor:
        return []
    overhead = {k: round(g[k], 1) for k in telemetry.GOODPUT_COMPONENTS
                if k != "productive_s" and g.get(k, 0.0) > 0.0}
    biggest = max(overhead, key=overhead.get, default=None)
    return [_verdict(
        "goodput", "goodput:run", "WARN",
        f"goodput {g['goodput_frac']:.2f} below {floor:.2f} floor"
        + (f" — biggest overhead {biggest} ({overhead[biggest]}s)"
           if biggest else ""),
        goodput_frac=round(g["goodput_frac"], 4), floor=floor,
        overhead=overhead)]


# -- predictive trend rules ---------------------------------------------------
#
# Level rules above fire when a threshold is ALREADY crossed; these fire
# when the recorded history says it is ABOUT to be — a WARN with the
# projection as evidence, strictly before the damped level CRIT. They read
# ``ctx["trend"]``: per-series (ts, value) tails the engine seeds from its
# :class:`~.series.SeriesStore` (history + this evaluation's sample). A
# stateless caller (one-shot --health, the cluster fold) has no history,
# so the trend rules simply return [] — prediction needs memory. Each rule
# is hysteretic twice over: the movement must repeat ``DLS_HEALTH_TREND_N``
# evaluations straight AND the projection must land inside the trailing
# window; and each goes quiet once the level it predicts has arrived (the
# level rule owns the incident from there).


def _trend_tail(ctx: dict, key: str) -> list[tuple[float, float]]:
    return list(ctx.get("trend", {}).get(key) or ())


def _moves(points: list[tuple[float, float]], n: int, sign: int) -> bool:
    """Did the series move strictly in ``sign`` direction for the last
    ``n`` consecutive deltas (needs n+1 points)?"""
    if n < 1 or len(points) < n + 1:
        return False
    vals = [v for _, v in points[-(n + 1):]]
    return all(sign * (b - a) > 0 for a, b in zip(vals, vals[1:]))


def _trend_n() -> int:
    return max(1, int(_env_float(TREND_N_ENV, 3.0)))


def _rule_trend_queue(ctx: dict) -> list[dict]:
    """Queue depth growing N evaluations straight and projected to cross
    the CRIT threshold within the window -> predictive WARN."""
    n = _trend_n()
    crit = _env_float(QUEUE_CRIT_ENV, 32.0)
    out = []
    for proc in sorted(ctx["queue_depth"]):
        key = series_lib.series_key(series_lib.QUEUE_SERIES, replica=proc)
        pts = _trend_tail(ctx, key)
        if not _moves(pts, n, +1):
            continue
        cur = pts[-1][1]
        if cur >= crit:
            continue  # already there: the level rule owns it
        fit = series_lib.linear_trend(pts[-(n + 1):])
        if not fit or fit["slope_per_s"] <= 0:
            continue
        eta = (crit - cur) / fit["slope_per_s"]
        if eta > ctx["window_s"]:
            continue
        out.append(_verdict(
            "trend_queue", f"trend:queue:{proc}", "WARN",
            f"replica {proc} queue depth rising {n} evaluations straight "
            f"({cur:.0f} now, projected ≥{crit:.0f} in ~{eta:.0f}s)",
            process=proc, queue_depth=cur,
            slope_per_s=round(fit["slope_per_s"], 6),
            projected_crit_in_s=round(eta, 1), crit=crit, consecutive=n))
    return out


def _rule_trend_slo(ctx: dict) -> list[dict]:
    """Burn-rate slope projecting EXHAUSTED within the window -> WARN
    before the level rule's damped CRIT."""
    slo = ctx["slo"]
    if not slo:
        return []
    n = _trend_n()
    exhaust = fleet_lib.SLO_EXHAUST_BURN
    out = []
    for tenant, row in slo["tenants"].items():
        if row["verdict"] == "EXHAUSTED":
            continue  # already there: the level rule owns it
        key = series_lib.series_key(series_lib.BURN_SERIES, tenant=tenant)
        pts = _trend_tail(ctx, key)
        if not _moves(pts, n, +1):
            continue
        cur = pts[-1][1]
        fit = series_lib.linear_trend(pts[-(n + 1):])
        if not fit or fit["slope_per_s"] <= 0:
            continue
        eta = max(0.0, (exhaust - cur) / fit["slope_per_s"])
        if eta > ctx["window_s"]:
            continue
        out.append(_verdict(
            "trend_slo", f"trend:slo:{tenant}", "WARN",
            f"tenant {tenant} burn rate rising {n} evaluations straight "
            f"({cur:.1f}x now, projecting EXHAUSTED ≥{exhaust:.0f}x "
            f"in ~{eta:.0f}s)",
            tenant=tenant, burn_rate=cur,
            slope_per_s=round(fit["slope_per_s"], 6),
            projected_exhausted_in_s=round(eta, 1),
            exhaust_burn=exhaust, consecutive=n))
    return out


def _rule_trend_hbm(ctx: dict) -> list[dict]:
    """HBM headroom trending to zero within the window -> WARN while the
    level rule still reads it as survivable (≥5%)."""
    n = _trend_n()
    pts = _trend_tail(ctx, series_lib.HBM_SERIES)
    if not _moves(pts, n, -1):
        return []
    cur = pts[-1][1]
    if cur < 0.05:
        return []  # already there: the level rule owns it
    fit = series_lib.linear_trend(pts[-(n + 1):])
    if not fit or fit["slope_per_s"] >= 0:
        return []
    eta = cur / -fit["slope_per_s"]
    if eta > ctx["window_s"]:
        return []
    return [_verdict(
        "trend_hbm", "trend:hbm", "WARN",
        f"HBM headroom falling {n} evaluations straight "
        f"({100.0 * cur:.1f}% now, projected exhausted in ~{eta:.0f}s)",
        headroom_frac=round(cur, 4),
        slope_per_s=round(fit["slope_per_s"], 8),
        projected_zero_in_s=round(eta, 1), consecutive=n)]


def _rule_trend_steps(ctx: dict) -> list[dict]:
    """In-run steps/sec decline: N straight drops AND the current rate a
    configurable fraction below the tail's peak (same judgment
    perf_guard --series makes post-hoc, raised live here)."""
    n = _trend_n()
    drop = _env_float(STEPS_DROP_ENV, 0.15)
    pts = _trend_tail(ctx, series_lib.STEPS_SERIES)
    if not _moves(pts, n, -1):
        return []
    vals = [v for _, v in pts]
    peak, cur = max(vals), vals[-1]
    if peak <= 0 or cur > (1.0 - drop) * peak:
        return []
    return [_verdict(
        "trend_steps", "trend:steps", "WARN",
        f"steps/sec declining {n} evaluations straight "
        f"({cur:.2f} now, {100.0 * (1.0 - cur / peak):.0f}% below "
        f"peak {peak:.2f})",
        steps_per_sec=round(cur, 4), peak_steps_per_sec=round(peak, 4),
        drop_frac=round(1.0 - cur / peak, 4), floor_frac=drop,
        consecutive=n)]


def _rule_trend_engine(ctx: dict) -> list[dict]:
    """The engine watching itself: unread backlog (cursor lag) growing N
    evaluations straight means evaluations are falling behind the
    writers' append rate — today a slow engine is invisible."""
    n = _trend_n()
    pts = _trend_tail(ctx, series_lib.ENGINE_LAG_SERIES)
    if not _moves(pts, n, +1):
        return []
    cur = pts[-1][1]
    if cur <= 0:
        return []
    return [_verdict(
        "trend_engine", "trend:engine", "WARN",
        f"health engine falling behind the append rate: unread backlog "
        f"grew {n} evaluations straight to {cur:.0f} bytes",
        lag_bytes=cur, consecutive=n)]


#: the registry, evaluation order = display order. Names are part of the
#: health.json contract (the ``rules`` map is keyed by them; additions
#: don't bump the schema).
RULES: tuple[tuple[str, Callable[[dict], list[dict]]], ...] = (
    ("stream", _rule_stream),
    ("heartbeat", _rule_heartbeat),
    ("hosts", _rule_hosts),
    ("hang", _rule_hang),
    ("straggler", _rule_straggler),
    ("slo", _rule_slo),
    ("queue", _rule_queue),
    ("shed", _rule_shed),
    ("recompile", _rule_recompile),
    ("hbm", _rule_hbm),
    ("restarts", _rule_restarts),
    ("shuffle", _rule_shuffle),
    ("goodput", _rule_goodput),
    ("trend_queue", _rule_trend_queue),
    ("trend_slo", _rule_trend_slo),
    ("trend_hbm", _rule_trend_hbm),
    ("trend_steps", _rule_trend_steps),
    ("trend_engine", _rule_trend_engine),
)


def _build_ctx(events: list[dict], *, now: float | None,
               window_s: float, slo_target_s: float | None,
               slo_budget: float, stream: dict | None) -> dict:
    """Compute every producer fold ONCE; rules read, never re-fold.

    ``now`` None anchors on the stream's end (the post-mortem-safe default
    the whole reader side uses); an explicit ``now`` also BOUNDS the
    stream to events at or before it, so an injected-clock engine
    replaying history evaluates each tick exactly as a live engine would
    have seen it (a live engine's poll can't return the future anyway —
    the bound only bites on replays). The engine's own ``alert`` events
    are excluded from the anchor and from rule inputs so the engine never
    reacts to itself."""
    events = [e for e in events if "ts" in e and e.get("kind") != "alert"]
    if now is not None:
        events = [e for e in events if float(e["ts"]) <= float(now)]
    anchor = (float(now) if now is not None
              else (float(events[-1]["ts"]) if events else 0.0))
    window_events = [e for e in events
                     if float(e["ts"]) >= anchor - window_s]
    replica_p99 = fleet_lib.replica_p99(window_events)
    worst = None
    for proc, row in replica_p99.items():
        if worst is None or row["p99_s"] > worst["p99_s"]:
            worst = {"process": proc, **row}
    serving = fleet_lib.serving_fleet(events)
    queue_depth: dict[str, Any] = {}
    if serving:
        for r in serving["replicas"]:
            if r.get("queue_depth") is not None:
                queue_depth[r["process"]] = r["queue_depth"]
    return {
        "events": events,
        "window_events": window_events,
        "now": anchor,
        "window_s": window_s,
        "stream": stream or {"files": 0, "events": len(events),
                             "skipped_lines": 0},
        "fleet": fleet_lib.fleet_report(events, now=now) if events else None,
        "serving": serving,
        "queue_depth": queue_depth,
        "replica_p99": replica_p99,
        "worst_replica": worst,
        "slo": (fleet_lib.slo_report(window_events,
                                     target_p99_s=slo_target_s,
                                     budget=slo_budget)
                if slo_target_s is not None else None),
        "anatomy": anatomy_lib.anatomy_report(events) if events else None,
        "goodput": telemetry.goodput(events),
    }


def _tenant_rows(ctx: dict) -> dict[str, dict]:
    """Per-tenant rows: serve tenants (requests/sheds, burn when the SLO
    rule is armed) + the env-stamped attribution tenants (``DLS_TENANT``
    -> every record), with the run's goodput attributed to the latter so a
    training workdir has a per-tenant row too."""
    rows: dict[str, dict] = {}

    def row(t: str) -> dict:
        return rows.setdefault(str(t), {})

    # bare engines stamp `tenant` on their own request events (no router
    # fold to read); count those first so a single-engine workdir still
    # gets requests/shed per tenant
    reqs = [e for e in ctx["events"] if e.get("kind") == "request"
            and e.get("tenant") is not None]
    for t in sorted({str(e["tenant"]) for e in reqs}):
        mine = [e for e in reqs if str(e["tenant"]) == t]
        shed = sum(e.get("outcome") == "shed" for e in mine)
        row(t).update(requests=len(mine), shed=shed,
                      shed_rate=round(shed / len(mine), 4))
    serving = ctx["serving"]
    if serving and serving["totals"].get("tenants"):
        for t, r in serving["totals"]["tenants"].items():
            row(t).update(requests=r["requests"], shed=r["shed"],
                          shed_rate=r["shed_rate"])
    if ctx["slo"]:
        for t, r in ctx["slo"]["tenants"].items():
            row(t).update(requests=r["requests"],
                          burn_rate=r["burn_rate"],
                          slo_verdict=r["verdict"])
    stamped = sorted({str(e["tenant"]) for e in ctx["events"]
                      if e.get("tenant") is not None})
    for t in stamped:
        row(t).setdefault("stamped", True)
        row(t).setdefault("goodput_frac",
                          round(ctx["goodput"]["goodput_frac"], 4))
    return rows


def _series_samples(ctx: dict) -> dict[str, float]:
    """The per-evaluation sample batch the engine records into its
    :class:`~.series.SeriesStore` — every value re-read from the folds
    the rules already consumed, so history costs nothing extra. Keys are
    the canonical series names (:mod:`.series`); a signal with no
    evidence this evaluation is simply absent (no phantom zeros)."""
    s: dict[str, float] = {}
    if ctx["events"]:
        s[series_lib.GOODPUT_SERIES] = ctx["goodput"]["goodput_frac"]
    laps = [e for e in ctx["window_events"]
            if e.get("kind") == "step_metrics" and e.get("lap_s")]
    lap_s = sum(float(e["lap_s"]) for e in laps)
    if lap_s > 0:
        s[series_lib.STEPS_SERIES] = (
            sum(int(e.get("steps", 0) or 0) for e in laps) / lap_s)
    an = ctx["anatomy"]
    if an:
        mfu_doc = an.get("mfu") or {}
        mfu = mfu_doc.get("mfu_last_lap")
        if mfu is None:
            mfu = mfu_doc.get("mfu")
        if mfu is not None:
            s[series_lib.MFU_SERIES] = float(mfu)
        mem = an.get("memory")
        if (mem and mem.get("source") == "memory_stats"
                and mem.get("headroom_bytes") is not None
                and mem.get("bytes_limit_min")):
            s[series_lib.HBM_SERIES] = (
                mem["headroom_bytes"] / float(mem["bytes_limit_min"]))
    hbs = [e for e in ctx["events"] if e.get("kind") == "heartbeat"]
    if hbs:
        s[series_lib.HEARTBEAT_SERIES] = ctx["now"] - float(hbs[-1]["ts"])
    reqs = [e for e in ctx["window_events"] if e.get("kind") == "request"]
    if reqs:
        s[series_lib.SHED_SERIES] = (
            sum(e.get("outcome") == "shed" for e in reqs) / len(reqs))
    if any(e.get("kind") == "shuffle" for e in ctx["events"]):
        spills = sum(1 for e in ctx["window_events"]
                     if e.get("kind") == "shuffle"
                     and e.get("edge") == "spill")
        s[series_lib.SPILL_SERIES] = spills / max(ctx["window_s"], 1e-9)
    for proc, depth in ctx["queue_depth"].items():
        if depth is not None:
            s[series_lib.series_key(series_lib.QUEUE_SERIES,
                                    replica=proc)] = float(depth)
    for proc, row in ctx["replica_p99"].items():
        s[series_lib.series_key(series_lib.P99_SERIES,
                                replica=proc)] = row["p99_s"]
    if ctx["slo"]:
        for tenant, row in ctx["slo"]["tenants"].items():
            s[series_lib.series_key(series_lib.BURN_SERIES,
                                    tenant=tenant)] = row["burn_rate"]
    return {k: float(v) for k, v in s.items()
            if v is not None and math.isfinite(float(v))}


def evaluate_health(events: list[dict], *, workdir: str | None = None,
                    now: float | None = None,
                    window_s: float | None = None,
                    slo_target_s: float | None = None,
                    slo_budget: float = 0.01,
                    stream: dict | None = None,
                    trend_tails: dict[str, list] | None = None) -> dict:
    """One stateless evaluation: the raw (undamped) health report.

    Returns the health.json body MINUS the engine-state keys
    (``evaluations``, ``alerts_active``, damped ``worst_severity``) — the
    engine adds those; one-shot callers (``--health`` with ``damping=1``,
    the cluster fold) use the raw verdicts directly. ``stream`` is the
    reader's file/skip accounting (``{files, events, skipped_lines}``)
    when the caller has it (the cursor tracks it; a bare events list
    can't know how many files it came from). ``trend_tails`` is the
    engine's per-series history ({key: [(ts, value), ...]}); the current
    evaluation's samples are appended before the predictive trend rules
    read them, and the batch is returned under ``_series_samples`` for
    the engine to record. None (the stateless default) disarms the trend
    rules — prediction needs memory."""
    if window_s is None:
        window_s = _env_float(WINDOW_ENV, 300.0)
    if slo_target_s is None:
        raw = os.environ.get(SLO_TARGET_ENV)
        slo_target_s = float(raw) if raw else None
    ctx = _build_ctx(events, now=now, window_s=window_s,
                     slo_target_s=slo_target_s, slo_budget=slo_budget,
                     stream=stream)
    samples = _series_samples(ctx)
    trend: dict[str, list] = {}
    if trend_tails is not None:
        trend = {k: list(v) for k, v in trend_tails.items()}
        for key, val in samples.items():
            trend.setdefault(key, []).append((ctx["now"], val))
    ctx["trend"] = trend
    rules: dict[str, dict] = {}
    verdicts: list[dict] = []
    for name, fn in RULES:
        vs = fn(ctx)
        verdicts.extend(vs)
        rules[name] = {
            "severity": worst_severity(v["severity"] for v in vs),
            "verdicts": vs,
        }
    hbs = [e for e in ctx["events"] if e.get("kind") == "heartbeat"]
    stepped = [e for e in ctx["events"]
               if e.get("kind") in ("step_metrics", "heartbeat")
               and e.get("step") is not None]
    st = dict(ctx["stream"])
    st["degraded"] = bool(st["files"] and not st["events"])
    return {
        "schema": HEALTH_SCHEMA,
        "generated_ts": ctx["now"],
        "workdir": workdir,
        "worst_severity": worst_severity(v["severity"] for v in verdicts),
        "rules": rules,
        "goodput": ctx["goodput"],
        "slo": ctx["slo"],
        "queue_depth": ctx["queue_depth"],
        "tenants": _tenant_rows(ctx),
        "last_step": int(stepped[-1]["step"]) if stepped else None,
        "last_heartbeat_age_s": (
            round(ctx["now"] - float(hbs[-1]["ts"]), 1) if hbs else None),
        "stream": st,
        "_verdicts": verdicts,  # engine-internal; stripped before writing
        "_series_samples": samples,  # engine-internal, recorded to series
    }


def write_health_json(report: dict, workdir: str | os.PathLike,
                      path: str | None = None) -> str:
    """Atomically rewrite ``<workdir>/health.json`` (temp + rename: a
    consumer polling the file never reads a torn JSON body)."""
    path = path or os.path.join(os.fspath(workdir), HEALTH_FILENAME)
    body = {k: v for k, v in report.items() if not k.startswith("_")}
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(_json_safe(body), f, default=str)
    os.replace(tmp, path)
    return path


class HealthEngine:
    """The continuous evaluator: incremental reads, flap damping, alert
    edges, atomic health.json.

    State machine per dedup ``key``: a *confirmed* severity (OK when the
    key is absent) plus at most one *pending* candidate. A raw verdict that
    differs from the confirmed state must repeat for ``damping``
    consecutive evaluations before the transition commits — at which point
    ONE ``alert`` event emits (``edge="raise"`` into WARN/CRIT with the
    held count as its receipt, ``edge="clear"`` back to OK carrying
    ``cleared_from``) and health.json flips. A raw state that flaps back
    before holding resets the candidate, so an oscillating rule emits
    nothing; a steady raised state re-evaluating raised emits nothing
    (dedup); a severity change on a live alert (WARN->CRIT) emits a raise
    with ``prev``. Clears always pair with their raise by ``key``.

    ``clock=None`` (default) anchors every evaluation on the stream's end
    — deterministic for tests and drills, and self-advancing on a live
    stream; pass ``time.time`` for wall-clock anchoring (ages measured to
    real now even when the stream stops — the live-daemon mode).
    ``write_alerts=False`` inspects without appending to the stream (the
    one-shot ``--health`` surface)."""

    def __init__(self, workdir: str | os.PathLike, *,
                 damping: int | None = None,
                 window_s: float | None = None,
                 slo_target_s: float | None = None,
                 slo_budget: float = 0.01,
                 clock: Callable[[], float] | None = None,
                 write_alerts: bool = True,
                 health_path: str | None = None):
        self.workdir = os.fspath(workdir)
        self.damping = max(1, int(damping if damping is not None
                                  else _env_float(DAMPING_ENV, 3.0)))
        self.window_s = window_s
        self.slo_target_s = slo_target_s
        self.slo_budget = slo_budget
        self._clock = clock
        self._write_alerts = write_alerts
        self._health_path = health_path
        self._cursor = telemetry.EventCursor(workdir)
        #: the history plane: one sample batch per evaluation, downsampled
        #: into multi-resolution buckets. Tails double as the memory the
        #: predictive trend rules fit their slope on.
        self.series = series_lib.SeriesStore(workdir)
        self._writer: telemetry.EventWriter | None = None
        # key -> confirmed non-OK state {rule, severity, summary, evidence,
        #                                since_ts, held}
        self._state: dict[str, dict] = {}
        # key -> pending candidate {severity, count, verdict}
        self._pending: dict[str, dict] = {}
        self.evaluations = 0

    # -- internals --

    def _emit_alert(self, fields: dict) -> None:
        if not self._write_alerts:
            return
        if self._writer is None:
            # host=None keeps the engine out of the fleet table, exactly
            # like the supervisor's stream
            self._writer = telemetry.EventWriter(
                self.workdir, process="health", host=None,
                clock=self._clock or time.time)
        self._writer.emit("alert", **fields)

    def _transition(self, key: str, verdict: dict | None, held: int,
                    now: float) -> None:
        prev = self._state.get(key)
        if verdict is None:  # -> OK: clear
            if prev is not None:
                self._emit_alert({
                    "edge": "clear", "rule": prev["rule"], "key": key,
                    "severity": "OK", "cleared_from": prev["severity"],
                    "summary": f"cleared: {prev['summary']}",
                    "held": held})
                del self._state[key]
            return
        edge = {
            "edge": "raise", "rule": verdict["rule"], "key": key,
            "severity": verdict["severity"], "summary": verdict["summary"],
            "evidence": verdict["evidence"], "held": held,
        }
        if prev is not None:
            edge["prev"] = prev["severity"]
        self._emit_alert(edge)
        self._state[key] = {
            "rule": verdict["rule"], "severity": verdict["severity"],
            "summary": verdict["summary"], "evidence": verdict["evidence"],
            "since_ts": now, "held": held,
        }

    def evaluate(self) -> dict:
        """One tick: poll appended events, run the rules, damp, emit edges,
        rewrite health.json. Returns the written report (plus the raw
        verdict list under ``_verdicts``)."""
        t_tick0 = time.perf_counter()
        self._cursor.poll()
        now = self._clock() if self._clock is not None else None
        # the engine's own alert stream must not count as "the workdir has
        # events": a degraded workdir would otherwise raise, append the
        # alert, then read its own edge as recovery and clear — forever
        stream = {"files": len(telemetry.event_files(self.workdir)),
                  "events": sum(e.get("kind") != "alert"
                                for e in self._cursor.events),
                  "skipped_lines": self._cursor.skipped_lines}
        report = evaluate_health(
            self._cursor.events, workdir=self.workdir, now=now,
            window_s=self.window_s, slo_target_s=self.slo_target_s,
            slo_budget=self.slo_budget, stream=stream,
            trend_tails=self.series.tails)
        self.evaluations += 1
        anchor = report["generated_ts"]
        raw = {v["key"]: v for v in report["_verdicts"]}
        for key in sorted(set(raw) | set(self._state) | set(self._pending)):
            verdict = raw.get(key)
            tgt = verdict["severity"] if verdict else "OK"
            cur = self._state.get(key, {}).get("severity", "OK")
            if tgt == cur:
                self._pending.pop(key, None)
                continue
            p = self._pending.get(key)
            if p is None or p["severity"] != tgt:
                p = {"severity": tgt, "count": 0, "verdict": verdict}
            p["count"] += 1
            p["verdict"] = verdict
            if p["count"] >= self.damping:
                self._pending.pop(key, None)
                self._transition(key, verdict, p["count"], anchor)
            else:
                self._pending[key] = p
        report["evaluations"] = self.evaluations
        report["worst_severity"] = worst_severity(
            s["severity"] for s in self._state.values())
        report["alerts_active"] = [
            {"key": key, **st} for key, st in sorted(self._state.items())]
        # self-telemetry (tick wall time is always real — even an
        # injected-clock drill wants the engine's actual cost), then the
        # whole batch lands in the series store; record() no-ops when the
        # anchor didn't advance, so a stalled stream records nothing twice
        tick_s = time.perf_counter() - t_tick0
        lag = self._cursor.lag_bytes()
        report["engine"] = {
            "tick_s": round(tick_s, 6), "lag_bytes": lag,
            "rules_evaluated": len(RULES),
            "bytes_read": self._cursor.bytes_read,
        }
        samples = dict(report.get("_series_samples") or {})
        samples[series_lib.ENGINE_TICK_SERIES] = tick_s
        samples[series_lib.ENGINE_LAG_SERIES] = float(lag)
        samples[series_lib.ENGINE_RULES_SERIES] = float(len(RULES))
        self.series.record(anchor, samples)
        write_health_json(report, self.workdir, self._health_path)
        return report

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


# -- incident timeline --------------------------------------------------------


def _who(e: dict) -> str | None:
    """Attribute an event to the host/replica/stage/tenant it names."""
    for field, fmt in (("culprit_host", "host{}"), ("dead_host", "host{}"),
                      ("replica", "replica {}"), ("stage", "stage {}"),
                      ("tenant", "tenant {}")):
        if e.get(field) is not None:
            return fmt.format(e[field])
    ev = e.get("evidence") or {}
    if isinstance(ev, dict):
        if ev.get("worst_replica") is not None:
            return f"replica {ev['worst_replica']}"
        if ev.get("host") is not None:
            return f"host{ev['host']}"
        if ev.get("process") is not None:
            return f"replica {ev['process']}"
        if ev.get("tenant") is not None:
            return f"tenant {ev['tenant']}"
    if e.get("host") is not None:
        return f"host{e['host']}"
    return None


def incident_timeline(events: list[dict]) -> list[dict]:
    """Fold alert edges + ``recovery`` events + failed supervisor attempt
    ends into one ts-ordered timeline: "what happened, in order, attributed
    to whom" (``dlstatus --incidents``)."""
    rows: list[dict] = []
    for e in events:
        kind, ts = e.get("kind"), e.get("ts")
        if ts is None:
            continue
        if kind == "alert":
            rows.append({
                "ts": float(ts),
                "type": f"alert-{e.get('edge', '?')}",
                "severity": e.get("severity"),
                "rule": e.get("rule"), "key": e.get("key"),
                "who": _who(e), "summary": e.get("summary"),
                "step": e.get("step"),
                "cleared_from": e.get("cleared_from"),
            })
        elif kind == "recovery":
            extra = {k: e[k] for k in ("classification", "transport",
                                       "reason", "ordinal", "replica")
                     if e.get(k) is not None}
            rows.append({
                "ts": float(ts), "type": "recovery",
                "severity": None, "rule": None,
                "key": e.get("event"), "who": _who(e),
                "summary": e.get("event", "") + (
                    " " + json.dumps(extra, default=str) if extra else ""),
                "step": e.get("step"), "cleared_from": None,
            })
        elif kind == "sched":
            edge = e.get("edge", "?")
            bits = [e.get("job") or "?"]
            if e.get("mode"):
                bits.append(e["mode"])
            if e.get("victim_of"):
                bits.append(f"for {e['victim_of']}")
            if e.get("reason"):
                bits.append(e["reason"])
            if e.get("hosts") is not None:
                bits.append(f"hosts={e['hosts']}")
            rows.append({
                "ts": float(ts), "type": f"sched-{edge}",
                "severity": ("WARN" if edge in ("preempt", "requeue", "fail")
                             else None),
                "rule": None, "key": e.get("job"),
                "who": _who(e), "summary": " ".join(str(b) for b in bits),
                "step": e.get("step"), "cleared_from": None,
            })
        elif (kind == "attempt" and e.get("edge") == "end"
              and e.get("classification") not in (None, "clean")):
            rows.append({
                "ts": float(ts), "type": "attempt-end",
                "severity": None, "rule": None,
                "key": f"attempt#{e.get('ordinal')}", "who": _who(e),
                "summary": (f"attempt {e.get('ordinal')} ended: "
                            f"{e.get('classification')} "
                            f"(codes {e.get('returncodes')})"),
                "step": None, "cleared_from": None,
            })
    rows.sort(key=lambda r: r["ts"])
    return rows


# -- cluster view -------------------------------------------------------------

#: why the multi-workdir fold and the scheduler's ledger are refused
CLUSTER_NOT_PORTED = (
    "cluster_report and the scheduler's ledger (the JAX package's "
    "telemetry/health.py:1113-1210) wait for the port's copy of the "
    "scheduler: ROADMAP Queue 1 item 7")


def cluster_report(root, **kwargs):
    """Refused: :data:`CLUSTER_NOT_PORTED`."""
    raise NotImplementedError(CLUSTER_NOT_PORTED)

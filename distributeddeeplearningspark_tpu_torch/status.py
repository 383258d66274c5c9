"""``dlstatus`` — render a run report from a run directory's telemetry alone.

The port's own ``dlstatus``, a copy of ``distributeddeeplearningspark_tpu/
status.py`` over the port's reader (:mod:`.telemetry` and its
``anatomy``, ``fleet``, ``health`` and ``series`` folds); it runs as
``python -m distributeddeeplearningspark_tpu_torch.status <workdir>`` and
gives the JAX package's report of the same stream. ``--cluster`` is
refused by name until the scheduler is ported (ROADMAP Queue 1 item 7).
The JAX module's account follows.

The terminal counterpart of the Spark UI's job page, sibling of
``dlprofile`` (which answers "where did the *device* time go" from a trace;
this answers "where did the *wall-clock* go" from the JSONL event stream —
see docs/OBSERVABILITY.md). It needs nothing but the files: a crashed or
still-running run reports exactly as well as a finished one, which is the
point — the first question after an incident is "what fraction of the run
was productive, and what ate the rest".

::

    dlstatus <workdir>                # goodput table, attempts, recovery
    dlstatus <workdir> --json         # machine-readable report
    dlstatus <workdir> --hosts        # + per-host fleet table, skew, verdicts
    dlstatus <workdir> --fleet-serve  # + per-replica serving table
    dlstatus <workdir> --traces       # + request latency anatomy (trace fold)
    dlstatus <workdir> --slo 0.25     # + SLO sentinel: p99 target, burn rate
    dlstatus <workdir> --anatomy      # + compile ledger, device/host/input
                                      #   split, MFU, memory watermarks
    dlstatus <workdir> --health       # + rule-evaluated health verdicts
                                      #   (rewrites <workdir>/health.json)
    dlstatus <workdir> --incidents    # + the ordered incident timeline
                                      #   (alert edges + recovery + attempts)
    dlstatus --cluster ROOT           # refused in the port (no scheduler yet)
    dlstatus <workdir> --watch        # live-follow: re-render on an interval
    dlstatus <workdir> --export-trace out.json  # Chrome/Perfetto trace_event

A workdir that served traffic (:mod:`..serve` — ``request`` events in the
stream) additionally gets the serving rollup: request counts by outcome
(ok/shed/error), p50/p99/max latency, queue-wait percentiles, mean batch
size, and throughput.

``--hosts`` adds the pod-level view (:mod:`..telemetry.fleet`): one row per
host with last step / heartbeat age / current phase / comms wait / goodput,
the step-skew timeline, and — when the evidence supports one — a straggler
or hang verdict naming the culprit host. Like the rest of the report it is
a pure fold over the JSONL streams, so it works on crashed and partial
streams (a silent host is exactly what it localizes).

``--fleet-serve`` adds the serving-fleet view
(:func:`..telemetry.fleet.serving_fleet`): one row per replica process
with request counts, p50/p99, shed rate, KV page occupancy, and
prefix-cache hit rate — the table that names which replica is shedding,
paging-pressured, or dead-silent (docs/POD_PLAYBOOK.md "A serving replica
died").
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.telemetry import anatomy as anatomy_lib
from distributeddeeplearningspark_tpu_torch.telemetry import fleet as fleet_lib
from distributeddeeplearningspark_tpu_torch.telemetry import health as health_lib
from distributeddeeplearningspark_tpu_torch.telemetry import series as series_lib

#: goodput components rendered in the breakdown table, in display order.
_COMPONENTS = telemetry.GOODPUT_COMPONENTS


def attempts_from(events: list[dict]) -> list[dict]:
    """Fold ``attempt`` records into one row per gang launch.

    Rows carry ``(session, ordinal)``: a second supervisor invocation on
    the same workdir restarts ordinals at 0, and the earlier session's
    history must stay in the timeline, not be overwritten — a repeated
    ``begin`` for an ordinal already begun starts a new session. A crashed
    supervisor can leave a begin with no end — the row then reports
    ``end_ts: None`` and no classification, which is itself diagnostic
    (the supervisor died mid-attempt). A row with a backoff but NO begin
    means the supervisor was killed during the backoff sleep — that
    attempt never launched (render says so, so nobody hunts for a gang
    that never existed)."""
    rows: list[dict] = []
    current: dict[int, dict] = {}
    session = 0

    def flush() -> None:
        rows.extend(current[k] for k in sorted(current))
        current.clear()

    for e in events:
        if e.get("kind") != "attempt":
            continue
        ordinal = int(e.get("ordinal", -1))
        edge = e.get("edge")
        if (edge == "begin" and ordinal in current
                and current[ordinal]["begin_ts"] is not None):
            # the same ordinal launching again = a fresh supervisor session
            flush()
            session += 1
        row = current.setdefault(ordinal, {
            "session": session, "ordinal": ordinal, "begin_ts": None,
            "end_ts": None, "duration_s": None, "returncodes": None,
            "classification": None, "made_progress": None, "backoff_s": None,
            "num_processes": None, "dead_host": None,
        })
        if edge == "begin":
            row["begin_ts"] = float(e["ts"])
            if "num_processes" in e:
                row["num_processes"] = e["num_processes"]
        elif edge == "end":
            row["end_ts"] = float(e["ts"])
            for k in ("duration_s", "returncodes", "classification",
                      "made_progress", "num_processes", "dead_host"):
                if k in e:
                    row[k] = e[k]
        elif edge == "backoff":
            row["backoff_s"] = e.get("delay_s")
    flush()
    return rows


# the ONE percentile definition (nearest-rank, jax-free) now lives beside
# the serving-fleet rollup that also needs it; re-exported here because
# dlserve and the tests import it as status._percentile
_percentile = fleet_lib._percentile


def serving_from(events: list[dict]) -> dict | None:
    """Fold ``request`` events (:mod:`..serve`) into the latency rollup.

    None when the run served nothing. Latency percentiles cover completed
    requests only; shed/error counts ride alongside so a load-shedding
    incident can't hide inside a pretty p50 (the shed requests never got a
    latency to report)."""
    reqs = [e for e in events if e.get("kind") == "request"]
    if not reqs:
        return None
    ok = [e for e in reqs if e.get("outcome") == "ok"]
    lat = sorted(float(e["latency_s"]) for e in ok
                 if e.get("latency_s") is not None)
    queue = sorted(float(e["queue_wait_s"]) for e in ok
                   if e.get("queue_wait_s") is not None)
    sizes = [float(e["batch_size"]) for e in ok if e.get("batch_size")]
    span = float(reqs[-1]["ts"]) - float(reqs[0]["ts"])
    return {
        "requests": len(reqs),
        "ok": len(ok),
        "shed": sum(e.get("outcome") == "shed" for e in reqs),
        "errors": sum(e.get("outcome") == "error" for e in reqs),
        "engines": sorted({str(e["engine"]) for e in reqs
                           if e.get("engine") is not None}),
        "latency_p50_s": _percentile(lat, 0.50),
        "latency_p99_s": _percentile(lat, 0.99),
        "latency_max_s": lat[-1] if lat else None,
        "queue_wait_p50_s": _percentile(queue, 0.50),
        "queue_wait_p99_s": _percentile(queue, 0.99),
        "mean_batch_size": (sum(sizes) / len(sizes)) if sizes else None,
        "requests_per_s": (len(ok) / span) if span > 0 else None,
    }


#: worker-pool gauge keys a step_metrics event may carry (emitted by
#: StarvationProbe.snapshot when a data/workers.py pool is live).
_WORKER_KEYS = ("input_workers", "worker_util_mean", "worker_util_min",
                "worker_items", "worker_overflow", "worker_ahead_mean",
                "worker_ring_used_mb")


def input_workers_from(events: list[dict]) -> dict | None:
    """The newest input-worker-pool gauge set, or None when the run never
    used a pool. The latest snapshot (not an average) is what answers "is
    the pool or the consumer the bottleneck *now*" — utilizations are
    pool-lifetime fractions already."""
    for e in reversed(events):
        if e.get("kind") == "step_metrics" and e.get("input_workers"):
            return {k: e[k] for k in _WORKER_KEYS if e.get(k) is not None}
    return None


def shuffle_from(events: list[dict]) -> dict | None:
    """Fold ``shuffle`` events (:mod:`..data.exchange`) into the shuffle
    block, or None when the run never shuffled. Totals sum every exchange
    in the stream; ``last`` keeps the newest summary whole (its per-bucket
    row counts are what skew is judged from)."""
    done = [e for e in events
            if e.get("kind") == "shuffle" and e.get("edge") == "done"]
    spill_events = sum(e.get("kind") == "shuffle"
                       and e.get("edge") == "spill" for e in events)
    retry_events = [e for e in events if e.get("kind") == "shuffle"
                    and e.get("edge") == "retry"]
    spec_events = sum(e.get("kind") == "shuffle"
                      and e.get("edge") == "speculate" for e in events)
    bl_events = sum(e.get("kind") == "shuffle"
                    and e.get("edge") == "blacklist" for e in events)
    if not done:
        return None
    last = done[-1]
    rows = [int(r) for r in (last.get("bucket_rows") or [])]
    mean_rows = (sum(rows) / len(rows)) if rows else 0.0
    max_rows = max(rows) if rows else 0
    skew = (max_rows / mean_rows) if mean_rows > 0 else None
    if skew is None:
        verdict = "no rows"
    elif skew < 2.0:
        verdict = f"balanced (max/mean {skew:.2f}x)"
    else:
        verdict = (f"SKEWED — bucket {rows.index(max_rows)} holds "
                   f"{skew:.1f}x the mean; pre-bucket or salt the hot key")
    def _fmt_total(key: str) -> int:
        return sum(int(e.get(key, 0) or 0) for e in done)

    # per-format split: which bytes/keys rode which transport.
    # Pre-columnar events carry no per-format fields — their pairs/bytes
    # fold under "tuple" (which is what they were) so totals still tie out
    formats = {
        "columnar": {
            "pairs": _fmt_total("columnar_pairs"),
            "bytes": _fmt_total("columnar_bytes"),
            "buckets": _fmt_total("columnar_buckets"),
        },
        "tuple": {
            "pairs": sum(
                int(e.get("tuple_pairs",
                          e.get("pairs_in", 0)) or 0) for e in done),
            "bytes": sum(
                int(e.get("tuple_bytes",
                          e.get("bytes_moved", 0)) or 0) for e in done),
            "buckets": _fmt_total("tuple_buckets"),
        },
    }
    return {
        "ops": len(done),
        "pairs_in": _fmt_total("pairs_in"),
        "rows_out": _fmt_total("rows_out"),
        "bytes_moved": _fmt_total("bytes_moved"),
        "spills": _fmt_total("spills"),
        "spill_events": spill_events,
        "overflow": _fmt_total("overflow"),
        "formats": formats,
        # self-healing rollup: every retry/speculation/
        # blacklist decision the exchanges took, folded from their edges
        "recovery": {
            "retries": len(retry_events),
            "mapper_retries": sum(
                e.get("role") == "mapper" for e in retry_events),
            "reducer_retries": sum(
                e.get("role") == "reducer" for e in retry_events),
            "speculations": spec_events,
            "blacklists": bl_events,
        },
        "last": {
            "op": last.get("op"),
            "workers": last.get("workers"),
            "buckets": last.get("buckets"),
            "map_s": last.get("map_s"),
            "merge_s": last.get("merge_s"),
            "spills": last.get("spills"),
            "mem_budget_mb": last.get("mem_budget_mb"),
            "transport": last.get("transport", "tuple"),
            "bucket_rows_max": max_rows,
            "bucket_rows_mean": round(mean_rows, 1),
            "skew": round(skew, 3) if skew is not None else None,
            "verdict": verdict,
        },
    }


def reshard_from(events: list[dict]) -> dict | None:
    """Fold ``reshard`` recovery events into one block, or None when the
    run never resharded. The split the operator cares about is transport:
    ``collectives``/``handoff`` moves are checkpoint-free (the run kept its
    current step), ``checkpoint`` moves are restore-time walk-backs. Totals
    sum every move; ``last`` keeps the newest move whole."""
    moves = [e for e in events if e.get("kind") == "recovery"
             and e.get("event") == "reshard"]
    if not moves:
        return None
    live = [e for e in moves if not e.get("walk_back")]
    last = moves[-1]
    return {
        "moves": len(moves),
        "live_moves": len(live),
        "walk_back_moves": len(moves) - len(live),
        "bytes_moved": sum(int(e.get("bytes_moved", 0) or 0) for e in moves),
        "by_transport": {
            t: sum(e.get("transport") == t for e in moves)
            for t in ("collectives", "handoff", "checkpoint")},
        "last": {
            "step": last.get("step"),
            "transport": last.get("transport"),
            "walk_back": bool(last.get("walk_back")),
            "reason": last.get("reason"),
            "bytes_moved": last.get("bytes_moved"),
            "rounds": last.get("rounds"),
            "peak_inflight_bytes": last.get("peak_inflight_bytes"),
            "mem_budget_mb": last.get("mem_budget_mb"),
            "wall_s": last.get("wall_s"),
            "leaves_moved": last.get("leaves_moved"),
            "verified": last.get("verified"),
        },
    }


def report(workdir: str, *, now: float | None = None,
           hosts: bool = False, fleet_serve: bool = False,
           traces: bool = False, slo_target: float | None = None,
           slo_budget: float = 0.01, anatomy: bool = False,
           events: list[dict] | None = None) -> dict:
    """The full run report as a plain dict (what ``--json`` prints).
    ``hosts=True`` adds the ``fleet`` key (per-host table, skew, verdicts);
    ``fleet_serve=True`` adds ``fleet_serve`` (per-replica serving table);
    ``traces=True`` adds ``traces`` (the per-stage latency anatomy);
    ``slo_target`` (p99 seconds) adds ``slo`` (per-tenant burn rates and
    GOOD/BURNING/EXHAUSTED verdicts against ``slo_budget``);
    ``anatomy=True`` adds ``anatomy`` (compile ledger, device/host/input
    split, MFU, memory watermarks — :func:`..telemetry.anatomy
    .anatomy_report`); ``events`` skips the stream read when the caller
    already holds it."""
    if events is None:
        events = telemetry.read_events(workdir)
    heartbeats = [e for e in events if e.get("kind") == "heartbeat"]
    # the MOST RECENT step-bearing event, not the max step: a divergence
    # rollback legitimately rewinds the step counter, and the honest "where
    # is the run now" after one is the rewound position
    stepped = [e for e in events
               if e.get("kind") in ("step_metrics", "heartbeat")
               and e.get("step") is not None]
    last_hb = float(heartbeats[-1]["ts"]) if heartbeats else None
    # fleet ages anchor on the STREAM's end (now=None), not wall-clock: the
    # table must read the same on a live run and a week-old post-mortem
    # copy — who fell silent first, and by how much, is stream-relative
    rep_fleet = fleet_lib.fleet_report(events, now=now) if hosts else None
    return {
        **({"fleet": rep_fleet} if hosts else {}),
        **({"fleet_serve": fleet_lib.serving_fleet(events)}
           if fleet_serve else {}),
        **({"traces": fleet_lib.latency_anatomy(events)} if traces else {}),
        **({"pipeline": fleet_lib.pipeline_anatomy(events)}
           if traces else {}),
        **({"slo": fleet_lib.slo_report(events, target_p99_s=slo_target,
                                        budget=slo_budget)}
           if slo_target is not None else {}),
        **({"anatomy": anatomy_lib.anatomy_report(events)}
           if anatomy else {}),
        "workdir": workdir,
        "event_files": telemetry.event_files(workdir),
        "num_events": len(events),
        "first_ts": float(events[0]["ts"]) if events else None,
        "last_ts": float(events[-1]["ts"]) if events else None,
        "last_step": int(stepped[-1]["step"]) if stepped else None,
        "last_heartbeat_ts": last_hb,
        "last_heartbeat_age_s": (
            ((now if now is not None else time.time()) - last_hb)
            if last_hb is not None else None),
        "goodput": telemetry.goodput(events),
        "input_workers": input_workers_from(events),
        "shuffle": shuffle_from(events),
        "reshard": reshard_from(events),
        "serving": serving_from(events),
        "attempts": attempts_from(events),
        "recovery_events": [e for e in events if e.get("kind") == "recovery"],
    }


def _json_safe(obj):
    """Replace non-finite floats with None so ``--json`` output is STRICT
    JSON. Divergence incidents put real NaNs in the stream (a skip event's
    ``nonfinite={'loss': nan}``); python's json would pass them through as
    bare ``NaN`` literals, breaking every spec-compliant consumer (jq,
    browsers) exactly in the incident case this tool exists for."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _fmt_s(v: float | None) -> str:
    return "-" if v is None else f"{v:.1f}s"


def render_fleet(fl: dict) -> list[str]:
    """The ``--hosts`` section: host table, skew, verdict lines."""
    lines: list[str] = []
    lines.append(
        f"fleet: {fl['num_hosts']}/{fl['expected_hosts'] or fl['num_hosts']} "
        f"host(s) reporting"
        + (f"; MISSING hosts {fl['missing_hosts']}"
           if fl["missing_hosts"] else ""))
    header = (f"  {'host':>4}  {'last step':>9}  {'hb age':>8}  "
              f"{'phase':<18} {'comms':>8}  {'goodput':>7}")
    lines.append(header)
    for r in fl["hosts"]:
        hb = (f"{r['heartbeat_age_s']:.1f}s"
              if r["heartbeat_age_s"] is not None else "-")
        step = r["last_step"] if r["last_step"] is not None else "-"
        phase = r["phase"] or "-"
        lines.append(
            f"  {r['host']:>4}  {step:>9}  {hb:>8}  {phase:<18} "
            f"{r['comms_wait_s']:>7.2f}s  {r['goodput']['goodput_frac']:>7.3f}")
    sk = fl["skew"]
    if sk["per_step"]:
        lines.append(
            f"  step skew: max {sk['max_skew_s']:.2f}s / median "
            f"{sk['median_skew_s']:.2f}s over {len(sk['per_step'])} common "
            f"step window(s), last common step {sk['last_common_step']}, "
            f"step lag {sk['step_lag']}")
        tail = sk["per_step"][-8:]
        lines.append("  skew timeline (last windows): " + "  ".join(
            f"s{w['step']}:{w['skew_s']:.2f}s(h{w['slowest_host']})"
            for w in tail))
    elif sk["step_lag"]:
        lines.append(f"  step lag: {sk['step_lag']} (no common step windows)")
    if fl["straggler"]:
        lines.append(f"  straggler: {fl['straggler']['verdict']}")
    if fl["hang"]:
        lines.append(f"  hang: {fl['hang']['verdict']}")
    return lines


def _fmt_pct(v: float | None) -> str:
    return "-" if v is None else f"{100.0 * v:.0f}%"


def render_fleet_serve(fs: dict) -> list[str]:
    """The ``--fleet-serve`` section: one serving row per replica process."""
    lines: list[str] = []
    t = fs["totals"]
    lines.append(
        f"serving fleet: {len(fs['replicas'])} process(es), "
        f"{t['ok']}/{t['requests']} requests ok"
        + (f"  prefix hit rate {_fmt_pct(t['prefix_hit_rate'])}"
           f" ({t['prefix_tokens_saved']} prompt tokens saved)"
           if t["prefix_hit_rate"] is not None else "")
        + (f"  failovers={t['failovers']}" if t.get("failovers") else ""))
    if t.get("tenants"):
        for name, row in t["tenants"].items():
            lines.append(
                f"  tenant {name}: {row['requests']} request(s), "
                f"shed rate {_fmt_pct(row['shed_rate'])} "
                f"({row['shed']} shed, {row['errors']} error(s))")
    lines.append(
        f"  {'replica':<8}  {'ok':>6}  {'shed':>5}  {'err':>4}  "
        f"{'p50':>8}  {'p99':>8}  {'shed%':>6}  {'kv occ':>6}  {'prefix':>6}")
    for r in fs["replicas"]:
        p50 = (f"{r['latency_p50_s'] * 1e3:.1f}ms"
               if r["latency_p50_s"] is not None else "-")
        p99 = (f"{r['latency_p99_s'] * 1e3:.1f}ms"
               if r["latency_p99_s"] is not None else "-")
        lines.append(
            f"  {r['process']:<8}  {r['ok']:>6}  {r['shed']:>5}  "
            f"{r['errors']:>4}  {p50:>8}  {p99:>8}  "
            f"{_fmt_pct(r['shed_rate']):>6}  "
            f"{_fmt_pct(r.get('kv_page_occupancy')):>6}  "
            f"{_fmt_pct(r.get('prefix_hit_rate')):>6}")
    return lines


def _fmt_ms(v: float | None) -> str:
    return "-" if v is None else f"{v * 1e3:.1f}ms"


def render_traces(tr: dict) -> list[str]:
    """The ``--traces`` section: per-stage latency anatomy + exemplars."""
    lines: list[str] = []
    lines.append(
        f"request traces: {tr['requests']} ({tr['complete']} complete, "
        f"{tr['incomplete']} incomplete)  e2e p50={_fmt_ms(tr['e2e_p50_s'])} "
        f"p99={_fmt_ms(tr['e2e_p99_s'])}"
        + (f"  stage coverage {_fmt_pct(tr['coverage_median'])} of e2e"
           if tr["coverage_median"] is not None else ""))
    if tr["stages"]:
        lines.append(f"  {'stage':<12} {'count':>6}  {'p50':>9}  {'p99':>9}  "
                     f"{'total':>9}")
        for name, s in tr["stages"].items():
            lines.append(
                f"  {name:<12} {s['count']:>6}  {_fmt_ms(s['p50_s']):>9}  "
                f"{_fmt_ms(s['p99_s']):>9}  {s['total_s']:>8.2f}s")
    for p, stages in (tr.get("per_process") or {}).items():
        decomp = "  ".join(f"{n}={_fmt_ms(s['p99_s'])}"
                           for n, s in stages.items())
        lines.append(f"  [{p}] p99 by stage: {decomp}")
    if tr["slowest"]:
        lines.append("  slowest requests:")
        for r in tr["slowest"]:
            chain = " > ".join(
                f"{s['name']} {_fmt_ms(s['dur_s'])}"
                for s in sorted(r["stage_spans"], key=lambda s: s["t0"]))
            where = f" [{r['process']}]" if r.get("process") else ""
            lines.append(
                f"    {r['trace_id']}{where} e2e={_fmt_ms(r['e2e_s'])}"
                + (f" hops={r['hops']}" if r.get("hops") else "")
                + f": {chain}")
    return lines


def _fmt_bytes(v: float | None) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024.0 or unit == "GiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024.0
    return "-"


def render_anatomy(an: dict) -> list[str]:
    """The ``--anatomy`` section: device/host/input split, MFU, compile
    ledger + recompile verdict, memory watermarks."""
    lines: list[str] = []
    st = an.get("steps")
    if st:
        lines.append(
            f"device anatomy: {st['laps']} lap(s) / {st['steps']} step(s), "
            f"lap wall {st['wall_s']:.2f}s")
        fr = st["fractions"]

        def pct(k):
            f = fr.get(k)
            return f"{100.0 * f:5.1f}%" if f is not None else "     -"

        lines.append(
            f"  device       {st['device_s']:10.2f}s  {pct('device')}  "
            f"(dispatch {st['device_dispatch_s']:.2f}s + drain "
            f"{st['device_drain_s']:.2f}s)")
        lines.append(f"  host         {st['host_s']:10.2f}s  {pct('host')}")
        lines.append(
            f"  input-wait   {st['input_wait_s']:10.2f}s  "
            f"{pct('input_wait')}")
        lines.append(
            f"  compile      {st['compile_s']:10.2f}s  {pct('compile')}  "
            f"(in-lap)")
        if an["verdicts"].get("bound"):
            lines.append(f"  verdict: {an['verdicts']['bound']}")
    mfu = an.get("mfu")
    if mfu and mfu.get("mfu") is not None:
        lines.append(
            f"  MFU {100.0 * mfu['mfu']:.3f}%"
            + (f" (last lap {100.0 * mfu['mfu_last_lap']:.3f}%)"
               if mfu.get("mfu_last_lap") is not None else "")
            + (f" — {mfu['flops_per_step']:.2e} flops/step"
               if mfu.get("flops_per_step") else "")
            + f" over {mfu.get('num_chips') or 1} chip(s), peak "
              f"{mfu['peak_flops_per_chip']:.2e}/chip "
              f"[{mfu.get('peak_source')}]")
    cl = an.get("compile_ledger")
    if cl and cl["compiles"]:
        lines.append(
            f"compile ledger: {cl['compiles']} compile(s), "
            f"{cl['distinct_signatures']} signature(s), "
            f"{cl['total_compile_s']:.2f}s total — "
            f"{an['verdicts']['recompile']}")
        for fn, row in sorted(cl["by_fn"].items()):
            lines.append(
                f"  {fn:<16} {row['compiles']:>3} compile(s)  "
                f"{row['signatures']:>3} sig(s)  {row['compile_s']:8.2f}s"
                + (f"  flops={row['flops']:.2e}" if row.get("flops") else "")
                + (f"  plan={row['plan']}[{row.get('plan_sig') or '?'}]"
                   if row.get("plan") else "")
                + (f"  RECOMPILES={row['flagged_recompiles']}"
                   if row["flagged_recompiles"] else ""))
    mem = an.get("memory")
    if mem:
        if mem["source"] == "memory_stats":
            lines.append(
                f"memory (memory_stats): in use "
                f"{_fmt_bytes(mem.get('bytes_in_use_max'))}  peak "
                f"{_fmt_bytes(mem.get('peak_bytes_in_use_max'))}  limit "
                f"{_fmt_bytes(mem.get('bytes_limit_min'))}  headroom "
                f"{_fmt_bytes(mem.get('headroom_bytes'))}")
        else:
            lines.append(
                f"memory (live-buffers): "
                f"{_fmt_bytes(mem.get('live_bytes'))} in live arrays "
                f"(backend exposes no allocator stats)")
    return lines


def render_pipeline(pl: dict) -> list[str]:
    """The ``--traces`` pipeline block: per-stage span anatomy + measured
    bubble fraction vs the (P−1)/(M+P−1) theoretical bound."""
    lines: list[str] = []
    meas, theo = pl["measured_bubble_frac"], pl["theoretical_bubble_frac"]
    verdict = ""
    if meas is not None and theo is not None:
        verdict = (" — within bound" if meas <= theo + 0.10
                   else " — ABOVE bound+10%: transport or stage imbalance "
                        "is eating the overlap")
    lines.append(
        f"pipeline: {pl['p'] or '?'} stage(s) x {pl['m'] or '?'} "
        f"microbatch(es) [{pl.get('schedule') or '?'}], "
        f"{pl['steps_judged']}/{pl['steps']} step(s) judged"
        + (f", {pl['microbatch_traces']} cross-stage microbatch trace(s)"
           if pl.get("microbatch_traces") else ""))
    if meas is not None:
        lines.append(
            f"  bubble fraction: measured {meas:.3f} vs theoretical "
            f"(P-1)/(M+P-1) = {theo if theo is not None else float('nan'):.3f}"
            f"{verdict}")
    lines.append(
        f"  {'stage':>5}  {'steps':>5}  {'fwd':>8}  {'bwd':>8}  "
        f"{'loss+opt':>8}  {'recv-wait':>9}  {'send-wait':>9}  {'bubble':>6}")
    for stage, r in pl["stages"].items():
        bub = f"{r['bubble_frac']:.3f}" if r["bubble_frac"] is not None else "-"
        lines.append(
            f"  {stage:>5}  {r['steps']:>5}  {_fmt_s(r['fwd_s']):>8}  "
            f"{_fmt_s(r['bwd_s']):>8}  {_fmt_s(r['loss_s']):>8}  "
            f"{_fmt_s(r['recv_wait_s']):>9}  {_fmt_s(r['send_wait_s']):>9}  "
            f"{bub:>6}")
    return lines


def render_slo(s: dict) -> list[str]:
    """The ``--slo`` section: per-tenant burn rate and verdict."""
    lines: list[str] = []
    lines.append(
        f"SLO: p99 target {_fmt_ms(s['target_p99_s'])}, error budget "
        f"{100.0 * s['budget']:.1f}% of requests")
    lines.append(
        f"  {'tenant':<10} {'req':>6} {'ok':>6} {'shed':>5} {'err':>4} "
        f"{'slow':>5}  {'viol%':>6}  {'burn':>6}  {'p99':>9}  verdict")
    rows = list(s["tenants"].items()) + [("TOTAL", s["totals"])]
    for name, r in rows:
        lines.append(
            f"  {name:<10} {r['requests']:>6} {r['ok']:>6} {r['shed']:>5} "
            f"{r['errors']:>4} {r['slow']:>5}  "
            f"{100.0 * r['violation_frac']:>5.1f}%  {r['burn_rate']:>5.1f}x  "
            f"{_fmt_ms(r['p99_s']):>9}  {r['verdict']}")
    return lines


def render_health(h: dict) -> list[str]:
    """The ``--health`` section: worst-severity rollup, per-rule verdicts,
    active (damped) alerts."""
    lines: list[str] = []
    st = h.get("stream") or {}
    lines.append(
        f"health: {h['worst_severity']}  "
        f"(schema v{h['schema']}, evaluation {h.get('evaluations', 1)})"
        + ("  DEGRADED STREAM" if st.get("degraded") else ""))
    for name, r in h["rules"].items():
        if not r["verdicts"]:
            continue
        for v in r["verdicts"]:
            lines.append(f"  [{v['severity']:<4}] {v['key']}: {v['summary']}")
    if all(not r["verdicts"] for r in h["rules"].values()):
        lines.append("  all rules OK")
    for a in h.get("alerts_active") or []:
        lines.append(
            f"  active alert {a['key']} [{a['severity']}] since "
            f"t={a['since_ts']:.1f} (held {a['held']} eval(s))")
    return lines


def render_incidents(rows: list[dict], first_ts: float | None) -> list[str]:
    """The ``--incidents`` section: the ordered timeline, one line each."""
    lines = [f"incident timeline: {len(rows)} event(s)"]
    t0 = first_ts if first_ts is not None else (rows[0]["ts"] if rows else 0.0)
    for r in rows:
        sev = f" [{r['severity']}]" if r.get("severity") else ""
        who = f" <{r['who']}>" if r.get("who") else ""
        step = f" step={r['step']}" if r.get("step") is not None else ""
        lines.append(
            f"  t+{r['ts'] - t0:8.1f}s  {r['type']:<12}{sev}{who}"
            f"{step}  {r['summary']}")
    return lines


_TREND_ARROWS = {"rising": "↗", "falling": "↘", "flat": "→"}


def _trend_arrow(t: dict | str | None) -> str:
    """Cell for a trend verdict (or a workdir's trend dict; '-' when the
    workdir has no series store)."""
    if not t:
        return "-"
    verdict = t if isinstance(t, str) else t.get("trend")
    return _TREND_ARROWS.get(verdict, "?")


def _parse_duration(raw: str) -> float:
    """``90s`` / ``10m`` / ``2h`` / ``1d`` / bare seconds -> seconds."""
    raw = str(raw).strip()
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}.get(
        raw[-1:].lower())
    if mult is not None:
        return float(raw[:-1]) * mult
    return float(raw)


def _fmt_sig(v: float | None) -> str:
    if v is None:
        return "-"
    return f"{v:.4g}"


def render_history(hist: dict) -> str:
    """The ``--history`` view: one sparkline row per series with
    min/mean/max/last and the fitted trend verdict."""
    lines = [
        f"history: {hist['workdir']}  resolution {hist['resolution_s']:g}s "
        f"over last {hist['since_s']:g}s  ({len(hist['series'])} series)"]
    for r in hist["series"]:
        lines.append(
            f"  {r['key']:<34} {r['spark']}  "
            f"min {_fmt_sig(r['min'])}  mean {_fmt_sig(r['mean'])}  "
            f"max {_fmt_sig(r['max'])}  last {_fmt_sig(r['last'])}  "
            f"{_trend_arrow(r['trend'])} {r['trend']}")
    if not hist["series"]:
        lines.append("  (no buckets in range — is the health engine "
                     "recording? try a longer --since)")
    return "\n".join(lines)


def render(rep: dict) -> str:
    """Human-readable report (the default output)."""
    lines: list[str] = []
    g = rep["goodput"]
    lines.append(f"run report: {rep['workdir']}")
    lines.append(
        f"  {rep['num_events']} events from {len(rep['event_files'])} "
        f"process file(s); wall-clock {_fmt_s(g['wall_s'])}"
        + (f"; last step {rep['last_step']}"
           if rep["last_step"] is not None else ""))
    if rep["last_heartbeat_ts"] is not None:
        lines.append(
            f"  last heartbeat: {_fmt_s(rep['last_heartbeat_age_s'])} ago")
    if rep.get("health"):
        lines.append("")
        lines.extend(render_health(rep["health"]))
    if rep.get("fleet"):
        lines.append("")
        lines.extend(render_fleet(rep["fleet"]))
    if rep.get("fleet_serve"):
        lines.append("")
        lines.extend(render_fleet_serve(rep["fleet_serve"]))
    if rep.get("traces"):
        lines.append("")
        lines.extend(render_traces(rep["traces"]))
    if rep.get("pipeline"):
        lines.append("")
        lines.extend(render_pipeline(rep["pipeline"]))
    if rep.get("slo"):
        lines.append("")
        lines.extend(render_slo(rep["slo"]))
    if rep.get("anatomy"):
        lines.append("")
        lines.extend(render_anatomy(rep["anatomy"]))
    lines.append("")
    lines.append("goodput breakdown")
    wall = g["wall_s"] or float("inf")
    for comp in _COMPONENTS:
        lines.append(f"  {comp:<20} {g[comp]:10.2f}s  "
                     f"{100.0 * g[comp] / wall:6.1f}%")
    lines.append(f"  goodput_frac         {g['goodput_frac']:10.3f}")
    iw = rep.get("input_workers")
    if iw:
        starved = (g.get("input_starved_s") or 0.0) > 0.05 * (g["wall_s"] or 1)
        util = iw.get("worker_util_mean", 0.0)
        if util >= 0.85 and starved:
            verdict = "pool-bound — workers saturated; add workers/cores"
        elif starved:
            verdict = ("source-bound — training waits but workers idle; "
                       "the raw source (IO) is the limit")
        else:
            verdict = "keeping up — consumer/device is the bottleneck"
        lines.append("")
        lines.append(
            f"input workers: {iw['input_workers']} process(es)  "
            f"util mean={util:.2f}"
            + (f" min={iw['worker_util_min']:.2f}"
               if iw.get("worker_util_min") is not None else "")
            + f"  items={iw.get('worker_items', 0)}"
            + f"  ahead={iw.get('worker_ahead_mean', 0.0):.1f}"
            + (f"  OVERFLOW={iw['worker_overflow']} (raise "
               f"DLS_DATA_WORKER_RING_MB)" if iw.get("worker_overflow")
               else ""))
        lines.append(f"  verdict: {verdict}")
    sh = rep.get("shuffle")
    if sh:
        last = sh["last"]
        lines.append("")
        lines.append(
            f"shuffle: {sh['ops']} op(s)  pairs={sh['pairs_in']}  "
            f"rows out={sh['rows_out']}  "
            f"moved={sh['bytes_moved'] / 1e6:.1f}MB  "
            f"spills={sh['spills']}"
            + (f"  OVERFLOW={sh['overflow']} (raise DLS_SHUFFLE_MEM_MB)"
               if sh.get("overflow") else ""))
        fmts = sh.get("formats") or {}
        fmt_bits = [
            f"{name}: keys={f['pairs']} moved={f['bytes'] / 1e6:.1f}MB"
            + (f" buckets={f['buckets']}" if f.get("buckets") else "")
            for name, f in fmts.items() if f.get("pairs")]
        if fmt_bits:
            lines.append("  by format  " + "   ".join(fmt_bits))
        rec = sh.get("recovery") or {}
        if any(rec.values()):
            lines.append(
                f"  recovery: retries={rec['retries']} "
                f"(mapper {rec['mapper_retries']}, "
                f"reducer {rec['reducer_retries']})  "
                f"speculations={rec['speculations']}  "
                f"blacklisted={rec['blacklists']} — self-healed; "
                f"escalations would have raised WorkerCrashed instead")
        lines.append(
            f"  last op {last['op']}: transport={last.get('transport')} "
            f"workers={last['workers']} "
            f"buckets={last['buckets']} map={_fmt_s(last['map_s'])} "
            f"merge={_fmt_s(last['merge_s'])} spills={last['spills']}"
            + (f" budget={last['mem_budget_mb']}MB"
               if last.get("mem_budget_mb") is not None else ""))
        lines.append(
            f"  bucket rows max={last['bucket_rows_max']} "
            f"mean={last['bucket_rows_mean']}  verdict: {last['verdict']}")
    rs = rep.get("reshard")
    if rs:
        last = rs["last"]
        lines.append("")
        lines.append(
            f"resharding: {rs['moves']} move(s)  "
            f"live={rs['live_moves']}  walk-back={rs['walk_back_moves']}  "
            f"moved={rs['bytes_moved'] / 1e6:.1f}MB")
        mode = ("walk-back (checkpoint)" if last["walk_back"]
                else "checkpoint-free (live)")
        lines.append(
            f"  last move: {mode} transport={last.get('transport')} "
            f"step={last.get('step', '-')}"
            + (f" reason={last['reason']}" if last.get("reason") else "")
            + (f" moved={last['bytes_moved'] / 1e6:.1f}MB"
               if last.get("bytes_moved") is not None else "")
            + (f" rounds={last['rounds']}"
               if last.get("rounds") is not None else "")
            + (f" peak={last['peak_inflight_bytes'] / 1e6:.1f}MB"
               f"/{last['mem_budget_mb']:.0f}MB budget"
               if last.get("peak_inflight_bytes") is not None
               and last.get("mem_budget_mb") is not None else "")
            + (f" wall={_fmt_s(last['wall_s'])}"
               if last.get("wall_s") is not None else "")
            + ("" if last.get("verified") is None
               else f" verified={str(bool(last['verified'])).lower()}"))
    sv = rep.get("serving")
    if sv:
        lines.append("")
        lines.append("serving"
                     + (f" ({', '.join(sv['engines'])})"
                        if sv["engines"] else ""))
        lines.append(
            f"  {sv['ok']}/{sv['requests']} requests ok"
            f"  shed={sv['shed']}  errors={sv['errors']}"
            + (f"  throughput={sv['requests_per_s']:.1f} req/s"
               if sv["requests_per_s"] is not None else ""))
        if sv["latency_p50_s"] is not None:
            lines.append(
                f"  latency p50={sv['latency_p50_s'] * 1e3:.1f}ms "
                f"p99={sv['latency_p99_s'] * 1e3:.1f}ms "
                f"max={sv['latency_max_s'] * 1e3:.1f}ms"
                + (f"  queue p50={sv['queue_wait_p50_s'] * 1e3:.1f}ms "
                   f"p99={sv['queue_wait_p99_s'] * 1e3:.1f}ms"
                   if sv["queue_wait_p50_s"] is not None else ""))
        if sv["mean_batch_size"] is not None:
            lines.append(f"  mean batch size {sv['mean_batch_size']:.1f}")
    if rep["attempts"]:
        lines.append("")
        lines.append("attempts")
        multi_session = any(a["session"] for a in rep["attempts"])
        for a in rep["attempts"]:
            codes = a["returncodes"]
            if a["begin_ts"] is None and a["end_ts"] is None:
                # backoff recorded, launch never happened: the supervisor
                # died during the backoff sleep
                state = "never launched (supervisor died in backoff)"
            else:
                state = a["classification"] or "in-flight"
            tag = (f"s{a['session']}#{a['ordinal']}" if multi_session
                   else f"#{a['ordinal']}")
            lines.append(
                f"  {tag}: {state}"
                f"  dur={_fmt_s(a['duration_s'])}"
                f"  codes={codes if codes is not None else '-'}"
                + (f"  np={a['num_processes']}"
                   if a.get("num_processes") is not None else "")
                + (f"  dead_host={a['dead_host']}"
                   if a.get("dead_host") is not None else "")
                + (f"  backoff={_fmt_s(a['backoff_s'])}"
                   if a["backoff_s"] is not None else ""))
        # an elastic run's shrinks, summarized where the operator looks
        # first: one line per geometry change, between the attempt rows
        # it separates (the events also appear in the recovery list below)
        drains = [e for e in rep["recovery_events"]
                  if e.get("event") == "graceful_shutdown"]
        for e in drains:
            lines.append(
                f"  graceful shutdown: host {e.get('dead_host')} drained at "
                f"step {e.get('step', '-')} (attempt "
                f"#{e.get('ordinal', '-')}) — handed off live, no backoff")
        geo = [e for e in rep["recovery_events"]
               if e.get("event") == "geometry_change"]
        for e in geo:
            lines.append(
                f"  geometry change: {e.get('from_processes')} -> "
                f"{e.get('to_processes')} host(s) after "
                f"{e.get('evidence_attempts')} attempt(s) blamed host "
                f"{e.get('dead_host')}; survivors {e.get('hosts')}, "
                f"resume step {e.get('step', '-')} "
                f"({e.get('resume', 'checkpoint')}), batch "
                f"{e.get('batch_policy')}")
    if rep["recovery_events"]:
        lines.append("")
        lines.append("recovery events")
        for e in rep["recovery_events"]:
            extra = {k: v for k, v in e.items()
                     if k not in ("ts", "kind", "process", "event", "step")}
            lines.append(
                f"  t+{float(e['ts']) - rep['first_ts']:.1f}s "
                f"[{e.get('process')}] {e.get('event')} "
                f"step={e.get('step', '-')}"
                + (f" {json.dumps(extra, default=str)}" if extra else ""))
    if rep.get("incidents") is not None:
        lines.append("")
        lines.extend(render_incidents(rep["incidents"], rep["first_ts"]))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dlstatus",
        description="Inspect a run's telemetry: goodput, attempts, recovery.")
    ap.add_argument("workdir", nargs="?", default=None,
                    help="run directory (holds telemetry/) or the "
                         "telemetry directory itself (optional with "
                         "--cluster)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--hosts", action="store_true",
                    help="per-host fleet table, step skew, and straggler/"
                         "hang verdicts (multi-host runs)")
    ap.add_argument("--fleet-serve", action="store_true",
                    help="per-replica serving table: p50/p99, shed rate, "
                         "KV page occupancy, prefix-cache hit rate")
    ap.add_argument("--traces", action="store_true",
                    help="request latency anatomy from span traces: "
                         "per-stage p50/p99 and the slowest exemplars")
    ap.add_argument("--slo", type=float, metavar="P99_S", default=None,
                    help="judge served traffic against this p99 target "
                         "(seconds): per-tenant burn rate and "
                         "GOOD/BURNING/EXHAUSTED verdicts")
    ap.add_argument("--slo-budget", type=float, default=0.01,
                    help="violation fraction the SLO tolerates "
                         "(default 0.01 = 99%% of requests in target)")
    ap.add_argument("--anatomy", action="store_true",
                    help="device-side anatomy: compile ledger + recompile "
                         "verdict, device/host/input lap split, MFU, "
                         "memory watermarks")
    ap.add_argument("--health", action="store_true",
                    help="evaluate the health ruleset (telemetry.health): "
                         "per-rule OK/WARN/CRIT verdicts, worst-severity "
                         "rollup — and rewrite <workdir>/health.json, the "
                         "machine contract")
    ap.add_argument("--incidents", action="store_true",
                    help="ordered incident timeline: alert raise/clear "
                         "edges + recovery events + failed attempts, "
                         "attributed to host/replica/stage/tenant")
    ap.add_argument("--cluster", metavar="ROOT", default=None,
                    help="discover every workdir under ROOT and render the "
                         "cluster table: per-tenant goodput/occupancy, "
                         "worst alert, heartbeat age (composes with "
                         "--json/--watch; --slo arms the SLO rule)")
    ap.add_argument("--history", nargs="?", const="*", metavar="KEY",
                    default=None,
                    help="render the downsampled series history as "
                         "sparklines with min/mean/max/trend verdicts "
                         "(all series, or one KEY like "
                         "'queue_depth{replica=p0}' or a bare name); "
                         "composes with --json (pinned schema) and "
                         "--since")
    ap.add_argument("--since", type=_parse_duration, default="1h",
                    metavar="DUR",
                    help="--history span: 90s / 10m / 2h / 1d or bare "
                         "seconds (default 1h); picks the finest "
                         "resolution whose ring covers it")
    ap.add_argument("--resolution", type=float, default=None, metavar="S",
                    help="--history: force a bucket width in seconds "
                         "instead of auto-picking from --since")
    ap.add_argument("--serve-metrics", type=int, metavar="PORT",
                    default=None,
                    help="serve an OpenMetrics/Prometheus text exposition "
                         "of the newest series buckets + health.json "
                         "verdicts on http://127.0.0.1:PORT/metrics "
                         "(0 = ephemeral port, printed to stderr; "
                         "--watch-count N answers N scrapes then exits)")
    ap.add_argument("--export-trace", metavar="OUT.json", default=None,
                    help="write the run's spans (serve requests + train "
                         "phases) as Chrome/Perfetto trace_event JSON")
    ap.add_argument("--watch", action="store_true",
                    help="live-follow mode: re-read the JSONL stream and "
                         "re-render every --interval seconds (works on an "
                         "in-progress run; ctrl-C to stop)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh period in seconds (default 2)")
    ap.add_argument("--watch-count", type=int, default=0,
                    help="--watch: stop after N renders (0 = until ctrl-C; "
                         "mainly for tests/scripts)")
    args = ap.parse_args(argv)
    if args.watch and args.export_trace:
        ap.error("--watch and --export-trace are mutually exclusive "
                 "(export reads one finished stream)")
    if args.cluster is not None:
        ap.error(f"--cluster is not ported: {health_lib.CLUSTER_NOT_PORTED}")
    if args.workdir is None:
        ap.error("a workdir is required")
    if args.serve_metrics is not None:
        return _serve_metrics_main(args)
    if args.history is not None:
        return _history_main(args)

    # --health runs through ONE engine for the whole invocation: a watch's
    # successive evaluations share its incremental cursor and its flap-
    # damping state (damping=1 one-shot: the report reflects the stream
    # NOW; continuous damping belongs to a long-lived --watch/daemon).
    # write_alerts=False — an inspector must not append to the stream it
    # inspects; health.json is its only write.
    engine = None
    if args.health:
        engine = health_lib.HealthEngine(
            args.workdir, damping=(None if args.watch else 1),
            slo_target_s=args.slo, slo_budget=args.slo_budget,
            write_alerts=False)

    def build(events: list[dict]) -> dict:
        rep = report(args.workdir, hosts=args.hosts,
                     fleet_serve=args.fleet_serve, traces=args.traces,
                     slo_target=args.slo, slo_budget=args.slo_budget,
                     anatomy=args.anatomy, events=events)
        if engine is not None:
            rep["health"] = {k: v for k, v in engine.evaluate().items()
                             if not k.startswith("_")}
        if args.incidents:
            rep["incidents"] = health_lib.incident_timeline(events)
        return rep

    def emit_one(rep: dict) -> None:
        if args.json:
            print(json.dumps(_json_safe(rep), default=str))
        else:
            print(render(rep))

    if args.watch:
        return _watch(args, build, emit_one)
    # ONE stream read shared between the report and the exporter — a
    # rotation-capped long-lived fleet's segments are a real parse cost
    events = telemetry.read_events(args.workdir)
    rep = build(events)
    if not rep["num_events"]:
        if rep["event_files"]:
            # parseable-but-degraded: the files say a run was here (a
            # crashed run's partial segment mid-rotation) — report that,
            # don't die. The health rule says the same thing.
            print(f"dlstatus: {len(rep['event_files'])} event file(s) under "
                  f"{args.workdir} but no parseable events — degraded "
                  f"stream (crashed run's partial segment?)",
                  file=sys.stderr)
            emit_one(rep)
            return 0
        print(f"dlstatus: no telemetry events under {args.workdir} "
              f"(looked in {telemetry.telemetry_dir(args.workdir)})",
              file=sys.stderr)
        return 1
    if args.export_trace:
        from distributeddeeplearningspark_tpu_torch.telemetry import (
            trace as trace_lib,
        )

        ladder = series_lib.list_resolutions(args.workdir)
        series_buckets = (
            series_lib.read_buckets(args.workdir, ladder[0][0])
            if ladder else None)
        data = trace_lib.chrome_trace(events, series_buckets=series_buckets)
        with open(args.export_trace, "w") as f:
            json.dump(_json_safe(data), f)
        n = sum(e.get("ph") in ("X", "B") for e in data["traceEvents"])
        print(f"dlstatus: wrote {n} span(s) to {args.export_trace} "
              f"(open in ui.perfetto.dev or chrome://tracing)",
              file=sys.stderr)
    emit_one(rep)
    return 0


def _history_main(args) -> int:
    """``--history [KEY]``: the series-store view. Reads ONLY the
    downsampled store (never the event stream) — answering "is it
    getting worse?" costs the ring size, not the run length."""
    hist = series_lib.history_report(
        args.workdir, key=(None if args.history == "*" else args.history),
        since_s=args.since, resolution_s=args.resolution)
    if hist is None:
        print(f"dlstatus: no series store under {args.workdir} — history "
              f"is recorded by the health engine (run "
              f"`dlstatus {args.workdir} --health` or a --watch daemon)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(_json_safe(hist), default=str))
    else:
        print(render_history(hist))
    return 0


def _serve_metrics_main(args) -> int:
    """``--serve-metrics PORT``: stdlib-http OpenMetrics exposition.

    Every GET re-reads health.json + the newest series buckets from disk,
    so the endpoint pairs with whatever is producing them (a ``--health
    --watch`` daemon, a supervised run's engine) without sharing a
    process. Binds loopback; PORT 0 picks an ephemeral port — the chosen
    one is printed to stderr. ``--watch-count N`` answers N requests and
    exits (tests/CI); default serves until ctrl-C."""
    import http.server

    workdir = args.workdir

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            if self.path.partition("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = series_lib.openmetrics_exposition(workdir).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             series_lib.OPENMETRICS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *fmt_args):
            pass  # scrape logs belong to the scraper, not stderr

    srv = http.server.HTTPServer(("127.0.0.1", args.serve_metrics), Handler)
    host, port = srv.server_address[0], srv.server_address[1]
    print(f"dlstatus: serving OpenMetrics on http://{host}:{port}/metrics "
          f"for {workdir}", file=sys.stderr, flush=True)
    try:
        if args.watch_count:
            for _ in range(args.watch_count):
                srv.handle_request()
        else:
            srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


def _watch(args, build, emit_one) -> int:
    """``--watch``: tail the stream, re-render on an interval.

    Incremental per tick: an :class:`~..telemetry.EventCursor` keeps one
    byte offset per segment file, so each tick parses only what was
    appended since the last one — a long run's watch tick stops being
    O(total events). The cursor's glob still follows segment rotation and
    newly appearing process files, and a torn mid-append tail is held
    back until its newline lands, so following an in-progress run needs
    no writer cooperation. A workdir whose files hold no parseable events
    (a crashed run's partial segment) renders as a degraded stream and
    keeps following — it does not die. Human mode clears the screen
    between renders on a TTY (a separator line otherwise); ``--json``
    emits one report line per tick, streamable into ``jq``."""
    renders = 0
    cursor = telemetry.EventCursor(args.workdir)
    try:
        while True:
            cursor.poll()
            events = cursor.events
            if not args.json:
                if sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                elif renders:
                    print("\n" + "=" * 72)
                print(f"dlstatus --watch {args.workdir}  "
                      f"(refresh {args.interval:g}s, render "
                      f"{renders + 1}"
                      + (f"/{args.watch_count}" if args.watch_count else "")
                      + ", ctrl-C to stop)")
            if events:
                emit_one(build(events))
            else:
                files = telemetry.event_files(args.workdir)
                if args.json:
                    print(json.dumps({"workdir": args.workdir,
                                      "num_events": 0,
                                      "degraded": bool(files)}))
                elif files:
                    print(f"  {len(files)} event file(s) but no parseable "
                          f"events under {args.workdir} — degraded stream "
                          f"(crashed run's partial segment?); waiting")
                else:
                    print(f"  no telemetry events yet under {args.workdir} "
                          f"(waiting)")
            renders += 1
            if args.watch_count and renders >= args.watch_count:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0
    except BrokenPipeError:
        # the downstream pager/head closed: a follow mode's normal exit.
        # Point fd 1 at devnull before returning — the interpreter's
        # shutdown flush of the buffered stdout would otherwise re-raise
        # and turn the clean rc 0 into exit 120 + "Exception ignored"
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())

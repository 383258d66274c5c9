"""Hang localization over a gang's merged telemetry streams.

The port's copy of the part of ``distributeddeeplearningspark_tpu/
telemetry/fleet.py`` that the supervisor calls when its watchdog kills a
hung gang: :func:`localize_hang` names the host whose stream went silent
first (the one actually stuck; the others' silence is the collective
blocking on it), with the phase it was in and for how long. It folds the
per-host streams (:func:`host_table`, without the JAX package's goodput
column) and the per-step arrival skew (:func:`step_skew`), whose median
sets the margin a culprit's silence must lead by. The fleet report, the
straggler verdict and the serving views are not ported (``dlstatus`` of
the JAX package reads a port run's stream unchanged).

Host identity is the ``host`` field the writer stamps, falling back to
the ``p<k>`` process name; the supervisor's own events (``host=None``)
describe the gang and are no member of it.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

_PROC_HOST_RE = re.compile(r"^p(\d+)$")

#: the culprit must have gone silent this many times the gang's median
#: per-step skew before every other host did
DEFAULT_STALL_FACTOR = 3.0
#: floor of that margin (seconds): below it, clock jitter between hosts
#: could explain the spread and no single host is named
MIN_STALL_MARGIN_S = 1.0


def host_of(event: dict) -> int | None:
    """The host index an event belongs to, or None for non-host processes."""
    h = event.get("host")
    if isinstance(h, int) and not isinstance(h, bool):
        return h
    m = _PROC_HOST_RE.match(str(event.get("process") or ""))
    return int(m.group(1)) if m else None


def split_hosts(events: Iterable[dict]) -> dict[int, list[dict]]:
    """Worker events grouped by host index (ts order preserved)."""
    by_host: dict[int, list[dict]] = {}
    for e in events:
        h = host_of(e)
        if h is not None:
            by_host.setdefault(h, []).append(e)
    return by_host


def _fold_host(host: int, events: list[dict]) -> dict[str, Any]:
    """One host's liveness, position and current phase."""
    last_step = last_step_ts = None
    open_phases: list[tuple[str, float]] = []
    hb_phase = hb_phase_t0 = None
    process = None
    for e in events:
        ts = float(e["ts"])
        kind = e.get("kind")
        process = e.get("process", process)
        if kind in ("step_metrics", "heartbeat") and e.get("step") is not None:
            last_step, last_step_ts = int(e["step"]), ts
        if kind == "heartbeat":
            hb_phase = e.get("phase")
            hb_phase_t0 = e.get("phase_t0") if hb_phase is not None else None
        elif kind == "phase" and e.get("name"):
            name = e["name"]
            if e.get("edge") == "begin":
                if name == "run":
                    # a relaunched attempt appending to the same file: spans
                    # left open by the crashed one are stale
                    open_phases.clear()
                    hb_phase = hb_phase_t0 = None
                open_phases.append((name, ts))
            elif e.get("edge") == "end":
                for i in range(len(open_phases) - 1, -1, -1):
                    if open_phases[i][0] == name:
                        del open_phases[i]
                        break
                if hb_phase == name:
                    hb_phase = hb_phase_t0 = None
    # the innermost open span (the outer "run" only when nothing inner is
    # open, and then with no dwell start), else the last heartbeat's phase
    phase, phase_since = None, None
    for name, ts in reversed(open_phases):
        phase = name
        phase_since = ts if name != "run" else None
        if name != "run":
            break
    if phase is None:
        phase = hb_phase
        if hb_phase_t0 is not None:
            try:
                phase_since = float(hb_phase_t0)
            except (TypeError, ValueError):
                pass
    return {"host": host, "process": process, "num_events": len(events),
            "first_ts": float(events[0]["ts"]), "last_ts": float(events[-1]["ts"]),
            "last_step": last_step, "last_step_ts": last_step_ts,
            "phase": phase, "phase_since_ts": phase_since}


def host_table(events: Iterable[dict], *, now: float | None = None
               ) -> list[dict[str, Any]]:
    """Per-host rows in host order, with ``silence_s`` from ``now``
    (default: the host streams' last timestamp)."""
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
        rows.append(row)
    return rows


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def step_skew(events: Iterable[dict]) -> dict[str, Any]:
    """For each step every host reported, the gap between the first host
    to reach it and the last: ``{num_hosts, max_skew_s, median_skew_s,
    last_common_step}``."""
    by_host = split_hosts(e for e in events if "ts" in e)
    arrivals: dict[int, dict[int, float]] = {}
    for h, evs in by_host.items():
        at: dict[int, float] = {}
        for e in evs:
            if e.get("kind") in ("step_metrics", "heartbeat") \
                    and e.get("step") is not None:
                at.setdefault(int(e["step"]), float(e["ts"]))
        arrivals[h] = at
    out: dict[str, Any] = {"num_hosts": len(by_host), "max_skew_s": 0.0,
                           "median_skew_s": 0.0, "last_common_step": None}
    if len(by_host) < 2:
        return out
    common = sorted(set.intersection(*(set(a) for a in arrivals.values())))
    skews = [max(a[s] for a in arrivals.values()) - min(a[s] for a in arrivals.values())
             for s in common]
    if common:
        out.update(last_common_step=common[-1], max_skew_s=max(skews),
                   median_skew_s=_median(skews))
    return out


def localize_hang(events: Iterable[dict], *, now: float | None = None,
                  stall_factor: float = DEFAULT_STALL_FACTOR,
                  margin_s: float | None = None) -> dict[str, Any] | None:
    """Name the host a hang is stuck IN, or None when there is no single
    culprit: the host whose last event is oldest, provided it leads every
    other host's silence by ``margin_s`` (default ``stall_factor`` × the
    median step skew, floored at ``MIN_STALL_MARGIN_S``). A single host is
    named only when its own silence to ``now`` exceeds the margin.
    Returns ``{host, process, phase, stalled_for_s, since_ts,
    others_at_step, verdict}``."""
    events = [e for e in events if "ts" in e]
    rows = host_table(events, now=now)
    if not rows:
        return None
    anchor = float(now) if now is not None else max(r["last_ts"] for r in rows)
    if margin_s is None:
        margin_s = max(MIN_STALL_MARGIN_S,
                       stall_factor * step_skew(events)["median_skew_s"])
    if len(rows) == 1:
        culprit, others = rows[0], []
        if anchor - culprit["last_ts"] < margin_s:
            return None
    else:
        by_silence = sorted(rows, key=lambda r: r["last_ts"])
        culprit, others = by_silence[0], by_silence[1:]
        if others[0]["last_ts"] - culprit["last_ts"] < margin_s:
            return None
    since = (culprit["phase_since_ts"] if culprit["phase_since_ts"] is not None
             else culprit["last_ts"])
    stalled_for = max(0.0, anchor - since)
    others_step = max((r["last_step"] for r in others
                       if r["last_step"] is not None), default=None)
    phase = culprit["phase"]
    verdict = (f"host {culprit['host']} stuck in "
               f"phase={phase or 'unknown'} for {stalled_for:.0f}s")
    if others_step is not None:
        verdict += f", all others waiting at step {others_step}"
    return {"host": culprit["host"], "process": culprit["process"],
            "phase": phase, "stalled_for_s": stalled_for, "since_ts": since,
            "others_at_step": others_step, "verdict": verdict}

"""Multi-resolution downsampled metrics store — the history plane.

The port's copy of ``distributeddeeplearningspark_tpu/telemetry/series.py``,
as it is (the port's ``dlstatus --history`` and the health engine's trends
read it). The JAX module's account follows.

Every other observability surface (health.json, ``dlstatus``, the SLO
sentinel, the anatomy report) folds the event stream into a point-in-time
snapshot; none can answer "is it getting worse?". This module is the
RRD-style store that makes trends first-class:

- :class:`SeriesStore` keeps fixed-width bucket rings at several
  resolutions (default 10s x 360 / 2m x 360 / 30m x 336 — one hour at
  10s grain, half a day at 2m, a week at 30m). Each bucket folds every
  sample that landed in its span into ``min/max/sum/last/count`` (mean is
  derived as ``sum/count``, so merging buckets stays exact).
- The :class:`~.health.HealthEngine` is the producer: it already folds
  the stream incrementally on a cadence, so it records one sample set
  per evaluation and history costs the append rate, never a re-read.
- Durability mirrors the event bus: finalized buckets are append-only
  JSONL lines (``buckets-<width>s.jsonl``), still-open buckets live in a
  ``header.json`` rewritten atomically (temp + rename). A torn bucket
  line is skipped by readers; a crash between the bucket append and the
  header rewrite replays as a duplicate ``(key, t)`` line, which readers
  dedupe last-wins; a compaction crash leaves only an ignorable temp
  file. Ring capacity is enforced by compaction, not in-place rewrite.

On top of the store: :func:`linear_trend` / :func:`trend_verdict` (the
slope fits the predictive health rules and ``--history`` verdicts read),
:func:`sparkline` (the unicode strip ``dlstatus --history`` renders), and
:func:`openmetrics_exposition` (the Prometheus/OpenMetrics text body
``dlstatus --serve-metrics`` serves).

Keys are flat ``name{label=value,...}`` strings (:func:`series_key` /
:func:`parse_key`) so one store holds per-replica and per-tenant series
without a schema: ``queue_depth{replica=p0}``, ``slo_burn_rate{tenant=t}``.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Iterable

#: schema stamped into header.json — consumers MUST check it; key
#: removal/rename bumps it (additions don't).
SERIES_SCHEMA = 1

#: where the store lives: ``<workdir>/telemetry/series/``.
SERIES_DIRNAME = "series"
HEADER_FILENAME = "header.json"

#: (bucket width seconds, ring capacity) — finest first. 10s x 360 = 1h,
#: 120s x 360 = 12h, 1800s x 336 = 7d.
DEFAULT_RESOLUTIONS: tuple[tuple[float, int], ...] = (
    (10.0, 360), (120.0, 360), (1800.0, 336))

#: derived per-bucket stats every reader/exposition surface exposes.
BUCKET_STATS = ("min", "mean", "max", "last", "count")

#: ``dlstatus --history --json`` pinned contract (schema bumps on key
#: removal/rename; additions don't).
HISTORY_SCHEMA = 1
HISTORY_KEYS = ("schema", "workdir", "resolution_s", "since_s", "now",
                "series")
HISTORY_ROW_KEYS = ("key", "n", "min", "mean", "max", "last", "first_t",
                    "last_t", "slope_per_s", "trend", "spark")

#: canonical series names the health engine records (per-replica /
#: per-tenant ones are templated through :func:`series_key`).
GOODPUT_SERIES = "goodput_frac"
STEPS_SERIES = "steps_per_sec"
MFU_SERIES = "mfu"
HBM_SERIES = "hbm_headroom_frac"
HEARTBEAT_SERIES = "heartbeat_age_s"
SHED_SERIES = "shed_rate"
SPILL_SERIES = "shuffle_spill_rate"
QUEUE_SERIES = "queue_depth"            # {replica=...}
P99_SERIES = "request_p99_s"            # {replica=...}
BURN_SERIES = "slo_burn_rate"           # {tenant=...}
ENGINE_TICK_SERIES = "engine_tick_s"
ENGINE_LAG_SERIES = "engine_lag_bytes"
ENGINE_RULES_SERIES = "engine_rules_evaluated"

_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"

_LABEL_RE = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$")


# -- keys ---------------------------------------------------------------------


def series_key(name: str, **labels: Any) -> str:
    """``series_key("queue_depth", replica="p0")`` -> ``queue_depth{replica=p0}``.

    Labels are sorted so the same (name, labels) always encodes to the
    same key — keys are dict keys and dedup identities."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> tuple[str, dict[str, str]]:
    """Inverse of :func:`series_key` (labels with no ``=`` are dropped)."""
    m = _LABEL_RE.match(key)
    if not m:
        return key, {}
    labels: dict[str, str] = {}
    for part in m.group("labels").split(","):
        k, eq, v = part.partition("=")
        if eq:
            labels[k.strip()] = v
    return m.group("name"), labels


# -- store --------------------------------------------------------------------


def series_dir(workdir: str | os.PathLike) -> str:
    from distributeddeeplearningspark_tpu_torch import telemetry
    return os.path.join(telemetry.telemetry_dir(workdir), SERIES_DIRNAME)


def _fmt_width(width_s: float) -> str:
    return "%g" % float(width_s)


def bucket_filename(width_s: float) -> str:
    return f"buckets-{_fmt_width(width_s)}s.jsonl"


def _parse_bucket_line(raw: str) -> dict | None:
    raw = raw.strip()
    if not raw:
        return None
    try:
        rec = json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return None  # torn tail from a crashed writer
    if not isinstance(rec, dict) or "t" not in rec or "k" not in rec:
        return None
    try:
        rec["t"] = float(rec["t"])
        rec["n"] = int(rec.get("n", 1))
        for f in ("min", "max", "sum", "last"):
            rec[f] = float(rec[f])
    except (KeyError, TypeError, ValueError):
        return None
    return rec


def _read_bucket_file(path: str) -> dict[tuple[str, float], dict]:
    """All finalized buckets in a segment, deduped last-wins by (key, t)
    — the crash-replay duplicate collapses here. Torn lines skipped."""
    out: dict[tuple[str, float], dict] = {}
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for raw in f:
                rec = _parse_bucket_line(raw)
                if rec is not None:
                    out[(str(rec["k"]), rec["t"])] = rec
    except OSError:
        pass
    return out


class SeriesStore:
    """Writer + in-memory tail cache. One instance per producer (the
    health engine); readers use the module-level :func:`read_buckets`.

    ``record(ts, samples)`` is idempotent over replays: a sample batch at
    ``ts <= last_ts`` is dropped, so a stream-anchored engine that
    re-evaluates a finished run records nothing twice. ``tails`` keeps
    the newest raw samples per key (seeded from disk on restart) — the
    window the predictive trend rules fit their slope on."""

    def __init__(self, workdir: str | os.PathLike, *,
                 resolutions: Iterable[tuple[float, int]] | None = None,
                 tail_len: int = 64):
        self.workdir = os.fspath(workdir)
        self.dir = series_dir(workdir)
        header = self._load_header()
        if resolutions is None:
            resolutions = header.get("resolutions") or DEFAULT_RESOLUTIONS
        self.resolutions = tuple(sorted(
            (float(w), int(c)) for w, c in resolutions))
        self.last_ts: float | None = header.get("last_ts")
        #: {width_key: {series_key: open bucket dict}}
        self._open: dict[str, dict[str, dict]] = {
            w: dict(buckets) for w, buckets in
            (header.get("open") or {}).items()}
        self._tail_len = max(2, int(tail_len))
        self.tails: dict[str, list[tuple[float, float]]] = {}
        self._counts: dict[str, int] = {}
        self._seed_tails()

    # -- header (atomic, like health.json) --

    def _header_path(self) -> str:
        return os.path.join(self.dir, HEADER_FILENAME)

    def _load_header(self) -> dict:
        try:
            with open(self._header_path()) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("schema") != SERIES_SCHEMA:
            return {}
        return doc

    def _write_header(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = self._header_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        body = {"schema": SERIES_SCHEMA,
                "resolutions": [list(r) for r in self.resolutions],
                "last_ts": self.last_ts,
                "open": self._open}
        with open(tmp, "w") as f:
            json.dump(body, f)
        os.replace(tmp, path)

    # -- tails --

    def _seed_tails(self) -> None:
        if not self.resolutions:
            return
        finest = self.resolutions[0][0]
        wkey = _fmt_width(finest)
        merged = _read_bucket_file(
            os.path.join(self.dir, bucket_filename(finest)))
        for b in self._open.get(wkey, {}).values():
            merged[(str(b["k"]), float(b["t"]))] = b
        per_key: dict[str, list[tuple[float, float]]] = {}
        for (k, t), b in merged.items():
            per_key.setdefault(k, []).append((t, float(b["last"])))
        for k, pts in per_key.items():
            pts.sort()
            self.tails[k] = pts[-self._tail_len:]

    # -- writes --

    def _bucket_path(self, width_s: float) -> str:
        return os.path.join(self.dir, bucket_filename(width_s))

    def _append_bucket(self, width_s: float, capacity: int,
                       bucket: dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = self._bucket_path(width_s)
        wkey = _fmt_width(width_s)
        n = self._counts.get(wkey)
        if n is None:
            try:
                with open(path, "rb") as f:
                    n = sum(1 for _ in f)
            except OSError:
                n = 0
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(bucket, separators=(",", ":")) + "\n")
        self._counts[wkey] = n + 1
        keys = max(1, len(self._open.get(wkey, {})))
        if self._counts[wkey] > 2 * capacity * keys:
            self._compact(width_s, capacity)

    def _compact(self, width_s: float, capacity: int) -> None:
        """Rewrite the segment keeping the newest ``capacity`` buckets per
        key (the ring bound), via temp + rename so a reader never sees a
        half-written file and a crash leaves only a stale temp."""
        path = self._bucket_path(width_s)
        merged = _read_bucket_file(path)
        per_key: dict[str, list[dict]] = {}
        for (k, _), b in merged.items():
            per_key.setdefault(k, []).append(b)
        keep: list[dict] = []
        for bs in per_key.values():
            bs.sort(key=lambda b: b["t"])
            keep.extend(bs[-capacity:])
        keep.sort(key=lambda b: (b["t"], str(b["k"])))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            for b in keep:
                f.write(json.dumps(b, separators=(",", ":")) + "\n")
        os.replace(tmp, path)
        self._counts[_fmt_width(width_s)] = len(keep)

    def record(self, ts: float, samples: dict[str, Any]) -> bool:
        """Fold one sample batch into every resolution's open buckets.

        Returns False (a no-op) when ``ts`` does not advance past
        ``last_ts`` or no sample is finite — replay idempotence."""
        ts = float(ts)
        if self.last_ts is not None and ts <= self.last_ts:
            return False
        finite: dict[str, float] = {}
        for key, val in samples.items():
            try:
                v = float(val)
            except (TypeError, ValueError):
                continue
            if math.isfinite(v):
                finite[str(key)] = v
        if not finite:
            return False
        for width, capacity in self.resolutions:
            wkey = _fmt_width(width)
            open_b = self._open.setdefault(wkey, {})
            t0 = math.floor(ts / width) * width
            for key, val in finite.items():
                b = open_b.get(key)
                if b is not None and float(b["t"]) == t0:
                    b["n"] = int(b["n"]) + 1
                    b["min"] = min(float(b["min"]), val)
                    b["max"] = max(float(b["max"]), val)
                    b["sum"] = float(b["sum"]) + val
                    b["last"] = val
                    continue
                if b is not None and float(b["t"]) < t0:
                    self._append_bucket(width, capacity, b)
                open_b[key] = {"t": t0, "k": key, "n": 1, "min": val,
                               "max": val, "sum": val, "last": val}
        self.last_ts = ts
        for key, val in finite.items():
            tail = self.tails.setdefault(key, [])
            tail.append((ts, val))
            del tail[:-self._tail_len]
        self._write_header()
        return True

    def flush(self) -> None:
        """Finalize every open bucket to its segment (end-of-run: the
        newest partial buckets become readable without the header)."""
        for width, capacity in self.resolutions:
            wkey = _fmt_width(width)
            for b in self._open.get(wkey, {}).values():
                self._append_bucket(width, capacity, b)
        self._write_header()


# -- readers ------------------------------------------------------------------


def list_resolutions(workdir: str | os.PathLike) -> tuple[
        tuple[float, int], ...]:
    """The store's configured (width_s, capacity) ladder, finest first;
    () when the workdir has no series store."""
    try:
        with open(os.path.join(series_dir(workdir), HEADER_FILENAME)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return ()
    if not isinstance(doc, dict) or doc.get("schema") != SERIES_SCHEMA:
        return ()
    return tuple(sorted((float(w), int(c))
                        for w, c in doc.get("resolutions") or ()))


def pick_resolution(resolutions: Iterable[tuple[float, int]],
                    span_s: float) -> float | None:
    """Finest width whose ring covers ``span_s``; the coarsest when none
    does; None when the ladder is empty."""
    ladder = sorted((float(w), int(c)) for w, c in resolutions)
    if not ladder:
        return None
    for width, capacity in ladder:
        if width * capacity >= span_s:
            return width
    return ladder[-1][0]


def read_buckets(workdir: str | os.PathLike, resolution_s: float, *,
                 keys: Iterable[str] | None = None,
                 since_ts: float | None = None,
                 until_ts: float | None = None) -> dict[str, list[dict]]:
    """{key: t-sorted buckets} at one resolution — finalized segment lines
    (torn-skipped, duplicate (key, t) deduped last-wins) merged with the
    header's still-open buckets. Each bucket: ``t`` (bucket start) plus
    :data:`BUCKET_STATS`."""
    sdir = series_dir(workdir)
    merged = _read_bucket_file(os.path.join(sdir, bucket_filename(
        resolution_s)))
    try:
        with open(os.path.join(sdir, HEADER_FILENAME)) as f:
            header = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        header = {}
    if isinstance(header, dict) and header.get("schema") == SERIES_SCHEMA:
        for b in (header.get("open") or {}).get(
                _fmt_width(resolution_s), {}).values():
            rec = _parse_bucket_line(json.dumps(b))
            if rec is not None:
                merged[(str(rec["k"]), rec["t"])] = rec
    want = set(keys) if keys is not None else None
    out: dict[str, list[dict]] = {}
    for (k, t), b in merged.items():
        if want is not None and k not in want:
            continue
        if since_ts is not None and t + float(resolution_s) <= since_ts:
            continue
        if until_ts is not None and t > until_ts:
            continue
        n = max(1, int(b["n"]))
        out.setdefault(k, []).append({
            "t": t, "count": n, "min": b["min"], "max": b["max"],
            "mean": b["sum"] / n, "last": b["last"]})
    for bs in out.values():
        bs.sort(key=lambda b: b["t"])
    return dict(sorted(out.items()))


# -- trend fitting ------------------------------------------------------------


def linear_trend(points: Iterable[tuple[float, float]]) -> dict | None:
    """Least-squares line over (t, value) points.

    Returns ``{slope_per_s, level, n, first_t, last_t}`` (level = mean
    value) or None when fewer than two distinct timestamps survive the
    finite filter — the caller treats None as "no trend evidence"."""
    pts = sorted((float(t), float(v)) for t, v in points
                 if math.isfinite(float(v)) and math.isfinite(float(t)))
    if len(pts) < 2:
        return None
    n = len(pts)
    mt = sum(t for t, _ in pts) / n
    mv = sum(v for _, v in pts) / n
    var = sum((t - mt) ** 2 for t, _ in pts)
    if var <= 0.0:
        return None
    slope = sum((t - mt) * (v - mv) for t, v in pts) / var
    return {"slope_per_s": slope, "level": mv, "n": n,
            "first_t": pts[0][0], "last_t": pts[-1][0]}


def trend_verdict(trend: dict | None, *, rel_threshold: float = 0.05
                  ) -> str:
    """"rising" / "falling" / "flat": the fitted line's projected change
    over its own span, relative to the level (5% default) — so a noisy
    flat series doesn't read as a trend just because slope != 0."""
    if not trend:
        return "flat"
    span = max(trend["last_t"] - trend["first_t"], 0.0)
    projected = trend["slope_per_s"] * span
    scale = max(abs(trend["level"]), 1e-9)
    if abs(projected) <= rel_threshold * scale:
        return "flat"
    return "rising" if projected > 0 else "falling"


def sparkline(values: Iterable[float | None], *, lo: float | None = None,
              hi: float | None = None) -> str:
    """Unicode strip (▁..█); non-finite/None samples render as ``·`` so a
    gap is visible but never poisons the scale."""
    vals = list(values)
    finite = [float(v) for v in vals
              if v is not None and math.isfinite(float(v))]
    if not finite:
        return "·" * len(vals)
    lo = min(finite) if lo is None else float(lo)
    hi = max(finite) if hi is None else float(hi)
    out = []
    for v in vals:
        if v is None or not math.isfinite(float(v)):
            out.append("·")
            continue
        if hi <= lo:
            out.append(_SPARK_GLYPHS[3])
            continue
        frac = (float(v) - lo) / (hi - lo)
        idx = min(len(_SPARK_GLYPHS) - 1,
                  max(0, int(frac * len(_SPARK_GLYPHS))))
        out.append(_SPARK_GLYPHS[idx])
    return "".join(out)


# -- history report (dlstatus --history) --------------------------------------


def history_report(workdir: str | os.PathLike, *,
                   key: str | None = None,
                   since_s: float = 3600.0,
                   resolution_s: float | None = None,
                   now: float | None = None,
                   spark_width: int = 40) -> dict | None:
    """The ``dlstatus --history [KEY] [--since DUR]`` fold: one row per
    series with min/mean/max/last, the fitted slope, a trend verdict, and
    a sparkline of bucket means. Pinned contract: :data:`HISTORY_KEYS` /
    :data:`HISTORY_ROW_KEYS`. None when the workdir has no series store
    (or no matching resolution)."""
    ladder = list_resolutions(workdir)
    if not ladder:
        return None
    if resolution_s is None:
        resolution_s = pick_resolution(ladder, since_s)
    buckets = read_buckets(workdir, resolution_s)
    anchor = now
    if anchor is None:
        anchor = max((bs[-1]["t"] + resolution_s
                      for bs in buckets.values() if bs), default=0.0)
    rows = []
    for k, bs in buckets.items():
        if key is not None and key not in ("*", k, parse_key(k)[0]):
            continue
        bs = [b for b in bs if b["t"] + resolution_s > anchor - since_s]
        if not bs:
            continue
        trend = linear_trend([(b["t"], b["mean"]) for b in bs])
        spark_bs = bs[-spark_width:]
        rows.append({
            "key": k,
            "n": sum(b["count"] for b in bs),
            "min": min(b["min"] for b in bs),
            "mean": (sum(b["mean"] * b["count"] for b in bs)
                     / max(1, sum(b["count"] for b in bs))),
            "max": max(b["max"] for b in bs),
            "last": bs[-1]["last"],
            "first_t": bs[0]["t"],
            "last_t": bs[-1]["t"],
            "slope_per_s": trend["slope_per_s"] if trend else None,
            "trend": trend_verdict(trend),
            "spark": sparkline([b["mean"] for b in spark_bs]),
        })
    return {
        "schema": HISTORY_SCHEMA,
        "workdir": os.fspath(workdir),
        "resolution_s": float(resolution_s),
        "since_s": float(since_s),
        "now": anchor,
        "series": rows,
    }


# -- OpenMetrics exposition (dlstatus --serve-metrics) ------------------------

_OM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _om_name(name: str) -> str:
    n = _OM_NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _om_escape(value: Any) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _om_value(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)  # repr round-trips exactly -> scrapes tie out bitwise


def _om_sample(name: str, labels: dict[str, Any], value: Any) -> str:
    inner = ",".join(f'{_om_name(str(k))}="{_om_escape(v)}"'
                     for k, v in sorted(labels.items()) if v is not None)
    return (f"{name}{{{inner}}} {_om_value(value)}" if inner
            else f"{name} {_om_value(value)}")


def openmetrics_exposition(workdir: str | os.PathLike) -> str:
    """OpenMetrics text body for one workdir: every numeric health.json
    verdict/gauge (bitwise-identical values — ``repr`` round-trips) plus
    the newest finest-resolution bucket of every series, labelled
    ``stat=min|mean|max|last``. Terminated by ``# EOF`` per the spec."""
    from distributeddeeplearningspark_tpu_torch.telemetry import health as health_lib
    wd = os.fspath(workdir)
    wd_label = {"workdir": wd}
    families: dict[str, list[str]] = {}

    def add(family: str, labels: dict[str, Any], value: Any) -> None:
        if value is None:
            return
        families.setdefault(family, []).append(
            _om_sample(family, labels, value))

    try:
        with open(os.path.join(wd, health_lib.HEALTH_FILENAME)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        doc = None
    if isinstance(doc, dict):
        sev_rank = {s: i for i, s in enumerate(health_lib.SEVERITIES)}
        add("dls_health_worst_severity", wd_label,
            sev_rank.get(doc.get("worst_severity"), 0))
        for rule, row in sorted((doc.get("rules") or {}).items()):
            add("dls_health_rule_severity", {**wd_label, "rule": rule},
                sev_rank.get((row or {}).get("severity"), 0))
        if doc.get("alerts_active") is not None:
            add("dls_health_alerts_active", wd_label,
                len(doc["alerts_active"]))
        if doc.get("evaluations") is not None:
            add("dls_health_evaluations", wd_label, doc["evaluations"])
        g = doc.get("goodput") or {}
        add("dls_goodput_frac", wd_label, g.get("goodput_frac"))
        for proc, depth in sorted((doc.get("queue_depth") or {}).items()):
            add("dls_queue_depth", {**wd_label, "replica": proc}, depth)
        slo = doc.get("slo") or {}
        for tenant, row in sorted((slo.get("tenants") or {}).items()):
            add("dls_slo_burn_rate", {**wd_label, "tenant": tenant},
                (row or {}).get("burn_rate"))
        for tenant, row in sorted((doc.get("tenants") or {}).items()):
            add("dls_tenant_shed_rate", {**wd_label, "tenant": tenant},
                (row or {}).get("shed_rate"))
        add("dls_heartbeat_age_s", wd_label, doc.get("last_heartbeat_age_s"))
        eng = doc.get("engine") or {}
        add("dls_engine_tick_s", wd_label, eng.get("tick_s"))
        add("dls_engine_lag_bytes", wd_label, eng.get("lag_bytes"))
    ladder = list_resolutions(wd)
    if ladder:
        finest = ladder[0][0]
        for key, bs in read_buckets(wd, finest).items():
            if not bs:
                continue
            name, labels = parse_key(key)
            newest = bs[-1]
            for stat in ("min", "mean", "max", "last"):
                add(f"dls_series_{_om_name(name)}",
                    {**wd_label, **labels, "stat": stat}, newest[stat])
    lines = []
    for family in sorted(families):
        lines.append(f"# TYPE {family} gauge")
        lines.extend(families[family])
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


#: the Content-Type --serve-metrics answers with (the OpenMetrics one;
#: Prometheus also accepts plain text/plain).
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

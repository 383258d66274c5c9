"""Device-side observability: the signature ledger, step anatomy, MFU and
memory watermarks — the port of ``distributeddeeplearningspark_tpu/
telemetry/anatomy.py``.

Three instruments land on the run's JSONL bus, in the JAX package's keys,
so the port's ``dlstatus --anatomy`` (:mod:`..status`) and the JAX
package's read a port run alike:

- **Signature ledger** (:func:`instrument` / :class:`InstrumentedFunction`).
  The port's train step is eager: there is no compiled program to lower.
  What JAX's compile ledger watches for — a step that starts again on new
  input shapes — is here a new input *signature* (the tensors' shapes and
  dtypes), and its first call (kernel builds, cuBLAS's heuristics, the
  allocator's growth) is the eager counterpart of a compile. Each new
  signature writes one ``compile`` event in JAX's schema (``fn``, ``sig``,
  ``sig_hash``, ``compile_s`` = the first call's seconds, ``flops``,
  ``recompile``: true once the distinct signatures exceed
  ``expected_signatures``, 1 for a train step), inside a ``compile``
  phase span so goodput accounts the stall. ``aot`` is false: nothing is
  compiled ahead. :meth:`InstrumentedFunction.prepare` supplies
  ``flops_per_step``, as JAX's does, by counting the call itself
  (:func:`~..metrics.measured_flops_per_step`): an eager step is costed
  only by running it, so ``prepare`` returns the call's result.
- **Step anatomy** (:class:`StepAnatomy`): each lap's wall split into
  *device* (the step's calls and the lap's one sync, where the host waits
  for the card), *compile* (first calls of a signature), *input-wait*
  (the starvation probe's) and *host* (the rest); with the step's FLOPs,
  the lap's ``mfu`` (over the wall) and ``mfu_device`` (over device time)
  against the card's peak (:func:`resolve_peak_flops`).
- **Memory watermarks** (:func:`memory_watermarks`): the caching
  allocator's ``memory_stats()`` and ``mem_get_info()`` on the card, the
  process's resident bytes on the CPU; one ``memory`` event a lap.

The reader half (:func:`anatomy_report` and its folds) is copied as it is.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import threading
import time
from typing import Any, Callable, Iterable

import torch

from distributeddeeplearningspark_tpu_torch import metrics as metrics_lib
from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.telemetry.anatomy")

#: Env override for the per-card peak FLOP/s the MFU denominator uses; wins
#: over the spec table.
PEAK_FLOPS_ENV = "DLS_PEAK_FLOPS"

#: Nominal per-core peak for the CPU (order of magnitude: ~8 f32 lanes × 2
#: FMA flops × ~1.25 GHz), the JAX package's: CPU MFU exists so host drills
#: get a finite, comparable number; ``peak_source`` says it is nominal.
CPU_NOMINAL_PEAK_PER_CORE = 2.0e10

_SIG_LEAVES_SHOWN = 4  # leaves spelled out in the human-readable signature

#: newest compile events kept verbatim in the ``--anatomy`` report
MAX_LEDGER_EVENTS_REPORTED = 50


def resolve_peak_flops(device: torch.device | str | None = None
                       ) -> tuple[float | None, str]:
    """(peak FLOP/s per card, source label) for the MFU denominator.

    Resolution order: ``DLS_PEAK_FLOPS`` → the bf16 spec table in
    :mod:`..metrics` by ``torch.cuda.get_device_name`` → a labelled nominal
    figure on the CPU → ``(None, "unknown-device (<name>)")``. ``device``
    defaults to the card where there is one."""
    v = metrics_lib.env_peak_flops_override()
    if v is not None:
        return v, PEAK_FLOPS_ENV
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        peak = metrics_lib.PEAK_FLOPS.get(name)
        if peak:
            return peak, f"spec table ({name})"
        return None, f"unknown-device ({name})"
    if device.type == "cpu":
        cores = os.cpu_count() or 1
        return (cores * CPU_NOMINAL_PEAK_PER_CORE,
                f"nominal-cpu ({cores} cores; set {PEAK_FLOPS_ENV} to "
                f"calibrate)")
    return None, f"unknown-device ({device.type})"


def _leaves(tree: Any) -> list[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _leaf_sig(x: Any) -> tuple[tuple[int, ...], str]:
    """A tensor's (shape, dtype); anything else by its type (the train
    state keeps its shapes, so the batch's leaves make the signature)."""
    if isinstance(x, torch.Tensor):
        return tuple(int(s) for s in x.shape), str(x.dtype).removeprefix("torch.")
    shape, dtype = getattr(x, "shape", None), getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return tuple(int(s) for s in shape), str(dtype)
    return (), type(x).__name__


_DTYPE_SHORT = {"float32": "f32", "float16": "f16", "bfloat16": "bf16",
                "float64": "f64", "int32": "i32", "int64": "i64",
                "int8": "i8", "uint8": "u8", "bool": "b1"}


def _human_sig(leaf_sigs: list[tuple[tuple[int, ...], str]]) -> str:
    parts = [f"{_DTYPE_SHORT.get(dt, dt)}[{','.join(map(str, sh))}]"
             for sh, dt in leaf_sigs[:_SIG_LEAVES_SHOWN]]
    extra = len(leaf_sigs) - _SIG_LEAVES_SHOWN
    return " ".join(parts) + (f" …+{extra} leaves" if extra > 0 else "")


class InstrumentedFunction:
    """Signature-ledger wrapper around an eager step (the module
    docstring). Each call's signature is the (structure, shape, dtype) of
    its arguments' leaves; the first call of a signature is timed as its
    ``compile`` and recorded; every later call's seconds go to the attached
    :class:`StepAnatomy` as device dispatch."""

    def __init__(self, fn: Callable, *, name: str, expected_signatures: int = 1,
                 clock=time.perf_counter, plan=None, device=None):
        self._fn = fn
        self.name = name
        self.plan_name = getattr(plan, "name", None) if plan is not None else None
        self.plan_sig = (plan.signature()
                         if plan is not None and hasattr(plan, "signature")
                         else None)
        self.expected_signatures = max(1, int(expected_signatures))
        self._clock = clock
        self._device = device
        self._lock = threading.Lock()
        self._seen: set[tuple] = set()
        self._sig_compiles: dict[str, int] = {}  # sig_hash → first calls
        self.records: list[dict[str, Any]] = []  # ledger, oldest first
        self._anatomy: "StepAnatomy | None" = None
        #: the newest measured FLOPs of one call, global over the gang
        #: (:func:`~..metrics.measured_flops_per_step`)
        self.flops_per_step: float | None = None

    def attach_anatomy(self, anatomy: "StepAnatomy | None") -> None:
        """Route per-call dispatch/first-call timings into a lap anatomy."""
        self._anatomy = anatomy

    def __getattr__(self, name: str):
        """The wrapped step's own attributes (a guarded step's ``guard``)."""
        fn = self.__dict__.get("_fn")
        if fn is None:
            raise AttributeError(name)
        return getattr(fn, name)

    @staticmethod
    def _dispatch_key(args: tuple) -> tuple:
        leaves = _leaves(args)
        return (len(leaves), tuple(_leaf_sig(x) for x in leaves))

    @staticmethod
    def _reported_sig(key: tuple) -> tuple[str, str, int]:
        sigs = list(key[1])
        sig_hash = hashlib.blake2b(repr(sigs).encode(), digest_size=8).hexdigest()
        return _human_sig(sigs), sig_hash, len(sigs)

    def _record_compile(self, key: tuple, compile_s: float,
                        flops: float | None) -> dict:
        sig, sig_hash, nleaves = self._reported_sig(key)
        with self._lock:
            n = self._sig_compiles.get(sig_hash, 0) + 1
            self._sig_compiles[sig_hash] = n
            distinct = len(self._sig_compiles)
            recompile = n > 1 or distinct > self.expected_signatures
            rec = {
                "fn": self.name, "sig": sig, "sig_hash": sig_hash,
                "nleaves": nleaves, "compile_s": round(compile_s, 6),
                "flops": flops, "bytes_accessed": None,
                **({"plan": self.plan_name, "plan_sig": self.plan_sig}
                   if self.plan_name else {}),
                "sig_compiles": n, "distinct_signatures": distinct,
                "expected_signatures": self.expected_signatures,
                "recompile": recompile, "aot": False,
            }
            self.records.append(rec)
            if flops:
                self.flops_per_step = flops
        if recompile:
            logger.warning(
                "%s ran a new input signature (%s seen %d time(s), %d distinct "
                "vs %d expected): %s", self.name, sig_hash, n, distinct,
                self.expected_signatures, sig)
        telemetry_lib.emit("compile", **rec)
        if self._anatomy is not None:
            self._anatomy.note_compile(compile_s)
        return rec

    def _first_call(self, key: tuple, args: tuple, kwargs: dict, measure: bool):
        """The first call of a signature, inside a ``compile`` phase span,
        counted when ``measure``."""
        with telemetry_lib.phase("compile", fn=self.name,
                                 **({"plan": self.plan_name} if self.plan_name else {})):
            t0 = self._clock()
            if measure:
                out, flops = metrics_lib.measured_flops_per_step(
                    lambda: self._fn(*args, **kwargs), device=self._device)
            else:
                out, flops = self._fn(*args, **kwargs), None
            compile_s = self._clock() - t0
        with self._lock:
            self._seen.add(key)
        return out, self._record_compile(key, compile_s, flops)

    def prepare(self, *args, **kwargs) -> tuple[Any, dict]:
        """``(the call's result, its ledger record)`` with the call's FLOPs
        measured: JAX's ``prepare`` compiles without running, an eager step
        is counted only by running it, so this IS a call (a train step
        advances). On a signature seen before nothing new is recorded: the
        record comes back with the FLOPs, and the counted call's seconds
        (the mode's cost on every op) go to the lap's compile bucket."""
        key = self._dispatch_key((args, kwargs))
        if key not in self._seen:
            return self._first_call(key, args, kwargs, measure=True)
        t0 = self._clock()
        out, flops = metrics_lib.measured_flops_per_step(
            lambda: self._fn(*args, **kwargs), device=self._device)
        if self._anatomy is not None:
            self._anatomy.note_compile(self._clock() - t0)
        self.flops_per_step = flops
        sig_hash = self._reported_sig(key)[1]
        rec = next(r for r in reversed(self.records) if r["sig_hash"] == sig_hash)
        return out, dict(rec, flops=flops)

    def __call__(self, *args, **kwargs):
        key = self._dispatch_key((args, kwargs))
        if key not in self._seen:
            return self._first_call(key, args, kwargs, measure=False)[0]
        t0 = self._clock()
        out = self._fn(*args, **kwargs)
        if self._anatomy is not None:
            self._anatomy.note_dispatch(self._clock() - t0)
        return out


def instrument(fn: Callable, *, name: str, expected_signatures: int = 1,
               plan=None, device=None) -> InstrumentedFunction:
    """Wrap an eager step in the signature ledger (idempotent)."""
    if isinstance(fn, InstrumentedFunction):
        return fn
    return InstrumentedFunction(fn, name=name,
                                expected_signatures=expected_signatures,
                                plan=plan, device=device)


# -- step anatomy -------------------------------------------------------------


class StepAnatomy:
    """Per-lap wall-clock split: device / host / input-wait / compile, the
    JAX package's model. ``device_s`` = the step's calls (dispatch: the
    host's enqueue, and any wait inside the step) + the lap's one sync
    (:meth:`drain`, where the host waits for the card); ``host_s`` the
    lap's residual after the input wait; ``compile_in_lap_s`` the first
    calls of a signature, kept out of all three. The trainer passes the
    Meter's own clock reads to :meth:`reset` and :meth:`lap` (``now``), so
    a lap's ``anatomy_wall_s`` is the Meter's lap to the bit (JAX's reads
    its clock apart and holds the two within 5%); the seconds are not
    rounded, the MFU is to 6 decimals, as JAX's. A first call of a
    signature is the step itself here (JAX times a compiled step's dispatch
    apart from its compile), so a lap holding one has no device time for
    that step: its record carries ``mfu`` but no ``mfu_device``."""

    def __init__(self, clock=time.perf_counter, device=None):
        self._clock = clock
        self._device = device
        self._lock = threading.Lock()
        self._lap_t0 = clock()
        self._dispatch_s = 0.0
        self._drain_s = 0.0
        self._compile_s = 0.0
        self._dispatches = 0

    def reset(self, now: float | None = None) -> None:
        """Restart the lap's clock and counters, at ``now`` (the Meter's
        start) or the clock's reading."""
        with self._lock:
            self._lap_t0 = self._clock() if now is None else now
            self._dispatch_s = self._drain_s = self._compile_s = 0.0
            self._dispatches = 0

    def note_dispatch(self, dt: float) -> None:
        with self._lock:
            self._dispatch_s += dt
            self._dispatches += 1

    def note_compile(self, dt: float) -> None:
        with self._lock:
            self._compile_s += dt

    @contextlib.contextmanager
    def drain(self):
        """Time the lap's sync (the metrics' copy to the host)."""
        t0 = self._clock()
        try:
            yield
        finally:
            with self._lock:
                self._drain_s += self._clock() - t0

    def lap(self, *, steps: int, input_wait_s: float = 0.0,
            flops_per_step: float | None = None,
            num_chips: int = 1, now: float | None = None) -> dict[str, Any]:
        """Close the lap; the gauges the trainer merges into its
        ``step_metrics`` record (JAX's keys and arithmetic)."""
        if now is None:
            now = self._clock()
        with self._lock:
            wall = max(0.0, now - self._lap_t0)
            dispatch, drain = self._dispatch_s, self._drain_s
            compile_s, dispatches = self._compile_s, self._dispatches
            self._lap_t0 = now
            self._dispatch_s = self._drain_s = self._compile_s = 0.0
            self._dispatches = 0
        device = dispatch + drain
        host = max(0.0, wall - device - compile_s - float(input_wait_s or 0.0))
        rec: dict[str, Any] = {
            "anatomy_wall_s": wall,
            "device_s": device,
            "device_dispatch_s": dispatch,
            "device_drain_s": drain,
            "host_s": host,
            "compile_in_lap_s": compile_s,
            "device_dispatches": dispatches,
            "num_chips": int(num_chips),
        }
        peak, source = resolve_peak_flops(self._device)
        rec["peak_flops_per_chip"] = peak
        rec["peak_source"] = source
        if flops_per_step:
            rec["flops_per_step"] = float(flops_per_step)
            if peak and wall > 0 and steps > 0:
                per_chip = flops_per_step * steps / wall / max(1, num_chips)
                rec["mfu"] = round(per_chip / peak, 6)
                if device > 0 and not compile_s:
                    rec["mfu_device"] = round(
                        flops_per_step * steps / device / max(1, num_chips)
                        / peak, 6)
        return rec


# -- memory watermarks -----------------------------------------------------------


def _resident_bytes() -> int:
    """This process's resident set (Linux ``/proc/self/statm``; else the
    peak from ``getrusage``)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def memory_watermarks(device: torch.device | str | None = None) -> dict[str, Any]:
    """Device memory gauges for one ``memory`` event, in JAX's keys.

    On a card (``source="memory_stats"``): ``bytes_in_use_max`` and
    ``peak_bytes_in_use_max`` are the caching allocator's allocated bytes
    now and at their peak (``torch.cuda.max_memory_allocated``),
    ``bytes_limit_min`` the card's total memory (``mem_get_info``),
    ``headroom_bytes`` the limit less the peak. On the CPU there is no allocator to
    ask: ``source="process-rss"`` and ``live_bytes`` the process's resident
    bytes (the JAX fold reads ``live_bytes`` for every source other than
    ``memory_stats``)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        return {"source": "memory_stats", "devices": 1,
                "bytes_in_use_max": in_use, "peak_bytes_in_use_max": peak,
                "bytes_limit_min": int(total), "headroom_bytes": int(total) - peak}
    return {"source": "process-rss", "devices": 1, "live_bytes": _resident_bytes()}


# -- reader (the fold for dlstatus --anatomy) ------------------------------------


def _steps_fold(laps: list[dict]) -> dict[str, Any]:
    out = {"laps": len(laps),
           "steps": sum(int(e.get("steps", 0) or 0) for e in laps)}
    for key, src in (("wall_s", "anatomy_wall_s"), ("device_s", "device_s"),
                     ("device_dispatch_s", "device_dispatch_s"),
                     ("device_drain_s", "device_drain_s"),
                     ("host_s", "host_s"), ("compile_s", "compile_in_lap_s"),
                     ("input_wait_s", "input_wait_s")):
        out[key] = round(sum(float(e.get(src, 0.0) or 0.0) for e in laps), 6)
    wall = out["wall_s"]
    covered = (out["device_s"] + out["host_s"] + out["compile_s"]
               + out["input_wait_s"])
    out["coverage"] = round(covered / wall, 4) if wall > 0 else None
    out["fractions"] = {
        k: (round(out[f"{k}_s"] / wall, 4) if wall > 0 else None)
        for k in ("device", "host", "compile", "input_wait")}
    return out


def _mfu_fold(laps: list[dict]) -> dict[str, Any]:
    peak = source = chips = None
    for e in reversed(laps):
        if e.get("peak_flops_per_chip"):
            peak = float(e["peak_flops_per_chip"])
            source = e.get("peak_source")
            chips = int(e.get("num_chips", 1) or 1)
            break
    flops_laps = [e for e in laps
                  if e.get("flops_per_step") and e.get("steps")]
    total_flops = sum(float(e["flops_per_step"]) * int(e["steps"])
                      for e in flops_laps)
    total_wall = sum(float(e.get("anatomy_wall_s", 0.0) or 0.0)
                     for e in flops_laps)
    mfu = None
    if peak and chips and total_flops > 0 and total_wall > 0:
        mfu = round(total_flops / total_wall / chips / peak, 6)
    last = next((e.get("mfu") for e in reversed(laps)
                 if e.get("mfu") is not None), None)
    newest_flops = next((float(e["flops_per_step"]) for e in reversed(laps)
                         if e.get("flops_per_step")), None)
    return {"mfu": mfu, "mfu_last_lap": last,
            "flops_per_step": newest_flops,
            "peak_flops_per_chip": peak, "peak_source": source,
            "num_chips": chips}


def _memory_fold(mems: list[dict]) -> dict[str, Any] | None:
    if not mems:
        return None
    newest_by_proc: dict[Any, dict] = {}
    for e in mems:
        newest_by_proc[e.get("process")] = e
    rows = list(newest_by_proc.values())
    stats = [e for e in rows if e.get("source") == "memory_stats"]
    if stats:
        in_use = max(int(e.get("bytes_in_use_max", 0) or 0) for e in stats)
        peaks = [int(e["peak_bytes_in_use_max"]) for e in stats
                 if e.get("peak_bytes_in_use_max") is not None]
        limits = [int(e["bytes_limit_min"]) for e in stats
                  if e.get("bytes_limit_min") is not None]
        out: dict[str, Any] = {"source": "memory_stats",
                               "bytes_in_use_max": in_use}
        if peaks:
            out["peak_bytes_in_use_max"] = max(peaks)
        if limits:
            out["bytes_limit_min"] = min(limits)
            out["headroom_bytes"] = min(limits) - max(peaks or [in_use])
        return out
    live = max(int(e.get("live_bytes", 0) or 0) for e in rows)
    return {"source": "live-buffers", "live_bytes": live}


def anatomy_report(events: Iterable[dict]) -> dict[str, Any] | None:
    """Fold a stream into the ``dlstatus --anatomy`` report.

    None when the run carries no anatomy evidence (no ``compile`` /
    ``memory`` events and no anatomy-stamped ``step_metrics``)."""
    events = list(events)
    compiles = [e for e in events if e.get("kind") == "compile"]
    laps = [e for e in events if e.get("kind") == "step_metrics"
            and e.get("anatomy_wall_s") is not None]
    mems = [e for e in events if e.get("kind") == "memory"]
    if not (compiles or laps or mems):
        return None

    flagged = [e for e in compiles if e.get("recompile")]
    sig_seen: dict[tuple, int] = {}
    for e in compiles:
        k = (e.get("fn"), e.get("sig_hash"))
        sig_seen[k] = sig_seen.get(k, 0) + 1
    duplicates = sum(1 for n in sig_seen.values() if n > 1)
    by_fn: dict[str, dict] = {}
    for e in compiles:
        fn = str(e.get("fn"))
        row = by_fn.setdefault(fn, {
            "compiles": 0, "signatures": set(), "flagged_recompiles": 0,
            "compile_s": 0.0, "flops": None, "bytes_accessed": None,
            "plan": None, "plan_sig": None})
        row["compiles"] += 1
        row["signatures"].add(e.get("sig_hash"))
        row["flagged_recompiles"] += bool(e.get("recompile"))
        row["compile_s"] += float(e.get("compile_s", 0.0) or 0.0)
        if e.get("flops"):
            row["flops"] = float(e["flops"])
        if e.get("bytes_accessed"):
            row["bytes_accessed"] = float(e["bytes_accessed"])
        if e.get("plan"):
            row["plan"] = e["plan"]
            row["plan_sig"] = e.get("plan_sig")
    for row in by_fn.values():
        row["signatures"] = len(row["signatures"])
        row["compile_s"] = round(row["compile_s"], 6)
    ledger = {
        "compiles": len(compiles),
        "distinct_signatures": len(sig_seen),
        "flagged_recompiles": len(flagged),
        "duplicate_signatures": duplicates,
        "total_compile_s": round(
            sum(float(e.get("compile_s", 0.0) or 0.0) for e in compiles), 6),
        "by_fn": by_fn,
        # newest-N only: a recompile STORM — the very case this report
        # diagnoses — produces one event per step for hours, and a
        # --watch tick must not serialize megabytes of them (the by_fn
        # rollup and the counters above carry the totals)
        "events": [
            {k: e.get(k) for k in
             ("ts", "process", "fn", "sig", "sig_hash", "compile_s",
              "flops", "bytes_accessed", "plan", "plan_sig", "recompile",
              "aot")}
            for e in compiles[-MAX_LEDGER_EVENTS_REPORTED:]],
        "events_omitted": max(0, len(compiles) - MAX_LEDGER_EVENTS_REPORTED),
    }

    per_process: dict[str, dict] = {}
    for e in laps:
        per_process.setdefault(str(e.get("process")), []).append(e)
    steps = _steps_fold(laps) if laps else None
    mfu = _mfu_fold(laps) if laps else None

    if flagged:
        worst = flagged[-1]
        recompile_verdict = (
            f"RECOMPILES — {len(flagged)} flagged compile(s) (e.g. "
            f"{worst.get('fn')} {worst.get('sig')}): the compile set is "
            f"not pinned; expect multi-second stalls mid-run")
    elif compiles:
        recompile_verdict = "OK — every signature compiled exactly once"
        if duplicates:
            recompile_verdict = (
                f"OK within each process; {duplicates} signature(s) "
                f"re-paid across attempts/processes (restarts re-pay jit "
                f"— see compile_s in goodput)")
    else:
        recompile_verdict = "no compiles recorded"

    bound_verdict = None
    if steps and steps["wall_s"] > 0:
        fr = steps["fractions"]
        ranked = sorted(
            ((fr.get(k) or 0.0), k)
            for k in ("device", "host", "input_wait", "compile"))
        top_frac, top = ranked[-1]
        label = {"device": "device-bound", "host": "host-bound",
                 "input_wait": "input-bound", "compile": "compile-bound"}[top]
        bound_verdict = (f"{label} — {100.0 * top_frac:.0f}% of lap "
                         f"wall-clock in {top.replace('_', '-')}")

    return {
        "compile_ledger": ledger,
        "steps": steps,
        "mfu": mfu,
        "memory": _memory_fold(mems),
        "per_process": {p: _steps_fold(ls)
                        for p, ls in sorted(per_process.items())},
        "verdicts": {"recompile": recompile_verdict, "bound": bound_verdict},
    }

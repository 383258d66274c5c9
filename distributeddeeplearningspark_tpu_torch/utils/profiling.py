"""Tracing and profiling over ``torch.profiler`` — the port of
``distributeddeeplearningspark_tpu/utils/profiling.py``.

- :class:`ProfileSpec` / :class:`StepProfiler`: a window of training steps
  traced from inside ``Trainer.fit(profile=...)`` without stopping the job
  (host ops, and on the card its kernels, copies and memsets through
  Kineto), written as a Chrome trace ``<host>_<pid>.<ns>.pt.trace.json``
  into the spec's directory. The window is relative to the step the loop
  resumed at; the profiler synchronises the card before it stops, so the
  window's device work is in the trace; ``profile-trace`` phase events
  mark it in the run's telemetry; when it closes, a daemon thread logs the
  window's device-time budget (:func:`op_breakdown`) so the loop never
  waits on the parse, and :meth:`StepProfiler.join_breakdown` waits for
  that line after the loop.
- :func:`annotate` and :func:`step_annotation`: ``record_function`` ranges
  that label host phases and steps in the trace.
- :func:`trace`: a context-manager capture.
- :func:`trace_files`, :func:`op_breakdown` (:mod:`.kineto` reads the
  Chrome trace) and :func:`profile_cli`, run as ``python -m
  distributeddeeplearningspark_tpu_torch.utils.profiling <dir-or-trace>``.

JAX's ``enable_xla_dump`` has no counterpart: the port's steps are eager,
so there is no compiled program to dump.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import logging
import os
import socket
import threading
import time

import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.utils import kineto

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.profiling")

TRACE_SUFFIX = ".pt.trace.json"


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """Capture ``num_steps`` steps starting at ``start_step`` into ``dir``.

    ``start_step`` defaults past warm-up so the window sees steady-state
    steps, not the first step's kernel builds."""

    dir: str
    start_step: int = 10
    num_steps: int = 5


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    dev = torch.device(device) if device is not None else None
    if torch.cuda.is_available() and (dev is None or dev.type == "cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, directory: str) -> str:
    """Write ``prof``'s Chrome trace into ``directory``; its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{socket.gethostname()}_{os.getpid()}."
                                   f"{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    return path


class StepProfiler:
    """Drives a ``torch.profiler`` window across a training loop.

    Call :meth:`observe` once per loop iteration with the step about to
    run; the profiler starts and stops itself around the window. Capture is
    process-local: in a gang every rank writes its own trace."""

    def __init__(self, spec: ProfileSpec | None, *, start_offset: int = 0,
                 sync=None, device=None):
        """``start_offset`` makes the window relative to the loop's first
        step (a job resumed at step 1000 with ``start_step=10`` traces steps
        1010+). ``sync`` blocks until the dispatched steps' device work is
        done (the Trainer passes ``torch.cuda.synchronize`` on the card), so
        the trace holds the window's kernels. ``device``: where the steps
        run (the card's kernels are traced where it is a card)."""
        self.spec = spec
        self.start_offset = start_offset
        self._sync = sync
        self._device = device
        self._prof = None
        self._active = False
        self._done = spec is None
        self._breakdown_thread: threading.Thread | None = None
        #: the trace the window wrote (None before it closed)
        self.trace_path: str | None = None

    def observe(self, step: int) -> None:
        if self._done:
            return
        assert self.spec is not None
        if not self._active and step >= self.spec.start_step + self.start_offset:
            self._prof = torch.profiler.profile(activities=_activities(self._device))
            self._prof.start()
            self._active = True
            self._stop_at = step + self.spec.num_steps
            # informational ("profile-trace" is no goodput overhead): which
            # steps carry the tracer's cost
            telemetry.emit("phase", name="profile-trace", edge="begin",
                           step=step, dir=self.spec.dir)
            logger.info("profiler: tracing steps %d..%d → %s",
                        step, self._stop_at, self.spec.dir)
        elif self._active and step >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        if self._active:
            if self._sync is not None:
                self._sync()
            self._prof.stop()
            self._active = False
            self.trace_path = _export(self._prof, self.spec.dir)
            self._prof = None
            telemetry.emit("phase", name="profile-trace", edge="end",
                           dir=self.spec.dir)
            logger.info("profiler: trace written to %s", self.trace_path)

            def _log_budget(path: str) -> None:
                rec = op_breakdown(path, top=5)
                if rec.get("ops"):
                    budget = ", ".join(f"{o['name']} {o['pct']:.1f}%"
                                       for o in rec["ops"])
                    logger.info("profiler: device-time budget (%s %s, %.1f ms): %s",
                                rec.get("plane"), rec.get("line"),
                                rec.get("total_ms", 0.0), budget)
                else:
                    logger.info("profiler: no device-time budget: %s",
                                rec.get("error", "trace had no op events"))

            # a daemon thread: the parse takes seconds on a big trace, and
            # stop() fires inside the loop, whose lap must not absorb it
            self._breakdown_thread = threading.Thread(
                target=_log_budget, args=(self.trace_path,), daemon=True,
                name="op-breakdown")
            self._breakdown_thread.start()
        self._done = True

    def join_breakdown(self, timeout_s: float = 150.0) -> None:
        """Wait for the device-time budget's log line (after the loop, once
        its laps are closed); say so if the parse outlives ``timeout_s``."""
        if self._breakdown_thread is not None:
            self._breakdown_thread.join(timeout_s)
            if self._breakdown_thread.is_alive():
                logger.warning("profiler: device-time budget parse still "
                               "running after %.0fs — abandoning (trace remains "
                               "at %s)", timeout_s, self.trace_path)


def annotate(name: str):
    """Label a host-side phase in the trace (input prep, checkpoint, eval)."""
    return torch.profiler.record_function(name)


def step_annotation(step: int):
    """Mark one train step in the trace."""
    return torch.profiler.record_function(f"train_step#{step}")


def trace_files(profile_dir: str) -> list[str]:
    """The Chrome traces a capture produced under ``profile_dir``."""
    return sorted(glob.glob(os.path.join(profile_dir, "**", f"*{TRACE_SUFFIX}"),
                            recursive=True))


@contextlib.contextmanager
def trace(profile_dir: str):
    """Context-manager capture: everything inside the block is traced (the
    card too where there is one)."""
    with torch.profiler.profile(activities=_activities(None)) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    _export(prof, profile_dir)


def op_breakdown(profile_dir_or_file: str, *, top: int = 25, by: str = "family",
                 streams: str = "busiest") -> dict:
    """Per-op-class device-time budget from a captured trace — "where did
    the step go?" without TensorBoard. A directory: its newest capture; or
    one trace file. Returns :func:`.kineto.parse`'s ``{"plane", "line",
    "total_ms", "event_count", "ops": [{"name", "ms", "pct", "count",
    "top_instance"}]}`` (the JAX package's schema), or ``{"error": ...}``."""
    path = profile_dir_or_file
    if not os.path.exists(path):
        return {"error": f"no such file or directory: {path}"}
    if os.path.isdir(path):
        files = trace_files(path)
        if not files:
            return {"error": f"no *{TRACE_SUFFIX} under {path}"}
        path = max(files, key=os.path.getmtime)
    try:
        return kineto.parse(path, top=top, by=by, streams=streams)
    except (OSError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}


def profile_cli(argv=None) -> int:
    """``dlprofile <trace-dir-or-trace.json>`` — print the device-time budget
    of a ``--profile-dir`` capture (its newest trace) or of one trace file,
    without TensorBoard."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="dlprofile", description=profile_cli.__doc__)
    ap.add_argument("path", help=f"profile dir (newest capture used) or *{TRACE_SUFFIX}")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)
    rec = op_breakdown(args.path, top=args.top)
    if args.json:
        print(json.dumps(rec))
        return 0 if rec.get("ops") else 1
    if not rec.get("ops"):
        print(f"error: {rec.get('error', 'trace contains no op events')}")
        return 1
    print(f"{rec['plane']}  [{rec['line']}]  total {rec['total_ms']:.1f} ms "
          f"over {rec['event_count']} events")
    for o in rec["ops"]:
        print(f"{o['pct']:6.2f}%  {o['ms']:9.2f} ms  x{o['count']:<6d} {o['name']}")
        if o.get("top_instance") and o["top_instance"] != o["name"]:
            print(f"         └─ {o['top_instance'][:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(profile_cli())

"""Step timing and throughput, and the per-step log line.

The port's copy of ``Meter`` and ``MetricLogger`` from
``distributeddeeplearningspark_tpu/metrics.py``, without the JAX device
queries: the chip count is the caller's (the Session's device count), and
model FLOPs/MFU, TensorBoard and recovery events are not ported yet.
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Any

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.metrics")


class Meter:
    """Per-lap wall-clock and throughput accounting.

    Laps must be recorded where the host has just synchronized with the
    device (e.g. right after copying that step's metrics to the host): CUDA
    runs ahead of the host, so a lap taken elsewhere measures the enqueue,
    not the compute. The first lap (kernel builds, cuBLAS heuristics,
    allocator growth) is left out of the summary when later laps exist."""

    def __init__(self, *, examples_per_step: int = 0, tokens_per_step: int = 0,
                 num_chips: int = 1):
        self.examples_per_step = examples_per_step
        self.tokens_per_step = tokens_per_step
        self.num_chips = num_chips
        self._laps: list[tuple[float, int]] = []
        self._last: float | None = None
        self._metrics_history: list[dict[str, float]] = []
        #: the most recent (elapsed_s, num_steps) lap
        self.last_lap: tuple[float, int] | None = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def lap(self, num_steps: int, metrics: dict[str, float] | None = None
            ) -> dict[str, float]:
        """Record a lap of ``num_steps`` steps; returns ``metrics`` as floats
        (non-finite values kept, so that the caller's divergence check sees
        them; only finite ones feed the summary)."""
        now = time.perf_counter()
        if self._last is not None and num_steps > 0:
            self.last_lap = (now - self._last, num_steps)
            self._laps.append(self.last_lap)
        self._last = now
        record = {k: float(v) for k, v in (metrics or {}).items()}
        finite = {k: v for k, v in record.items() if math.isfinite(v)}
        if finite:
            self._metrics_history.append(finite)
        return record

    @property
    def steady_laps(self) -> list[tuple[float, int]]:
        return self._laps[1:] if len(self._laps) > 1 else self._laps

    def summary(self) -> dict[str, float]:
        laps = self.steady_laps
        if not laps:
            return {}
        step_time = sum(t for t, _ in laps) / sum(n for _, n in laps)
        out: dict[str, float] = {
            "step_time_ms": step_time * 1e3,
            "steps_per_sec": 1.0 / step_time,
        }
        if self.examples_per_step:
            out["examples_per_sec"] = self.examples_per_step / step_time
            out["examples_per_sec_per_chip"] = out["examples_per_sec"] / self.num_chips
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / step_time
            out["tokens_per_sec_per_chip"] = out["tokens_per_sec"] / self.num_chips
        if self._metrics_history:
            out.update(self._metrics_history[-1])
        return out


def _log_value(v: Any):
    """Counter-like values (integral floats) print as ints, the rest
    rounded to 6 decimals, as the JAX package's log line does."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return v
    if math.isfinite(f) and f.is_integer() and abs(f) < 2**63:
        return int(f)
    return round(f, 6)


class MetricLogger:
    """One structured log line per call, ``step N: {json}``."""

    def log(self, step: int, metrics: dict[str, float]) -> None:
        """Emit unconditionally — cadence is the caller's decision."""
        logger.info("step %d: %s", step,
                    json.dumps({k: _log_value(v) for k, v in metrics.items()}))

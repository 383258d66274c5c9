"""Step timing and throughput, the per-step log line, and ROC AUC.

The port's copy of ``Meter``, ``MetricLogger``, ``StreamingAUC``,
``auc_from_predictions``, ``attention_matmul_flops`` and
``llama_model_flops_per_token`` from ``distributeddeeplearningspark_tpu/
metrics.py``, without the JAX device queries: the chip count is the
caller's (the Session's device count). ``MetricLogger.event`` writes a
recovery event's WARNING line and ``recovery`` telemetry record; its
TensorBoard scalar, measured FLOPs and MFU are not ported yet (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import time
from typing import Any

import numpy as np

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
    """One structured log line per call, ``step N: {json}``; recovery
    events as their own WARNING lines, mirrored into ``telemetry`` (an
    :class:`~.telemetry.EventWriter`) when given."""

    def __init__(self, *, telemetry=None):
        self._telemetry = telemetry

    def log(self, step: int, metrics: dict[str, float]) -> None:
        """Emit unconditionally — cadence is the caller's decision."""
        logger.info("step %d: %s", step,
                    json.dumps({k: _log_value(v) for k, v in metrics.items()}))

    def event(self, step: int, kind: str, **fields) -> None:
        """Surface a recovery event (a divergence skip, a rollback) on rank
        0 as a WARNING line of its own — the line an operator greps for
        after an incident — and as a ``recovery`` telemetry record, so the
        audit trail survives the process."""
        from distributeddeeplearningspark_tpu_torch.parallel import collectives

        if collectives.rank() != 0:
            return
        logger.warning("recovery event at step %d: %s %s", step, kind,
                       json.dumps(fields, default=str))
        if self._telemetry is not None:
            self._telemetry.recovery(step, kind, **fields)


class StreamingAUC:
    """Histogram-binned ROC AUC over a prediction stream (config 4's
    metric: accuracy is degenerate at Criteo's click rate). Scores, clipped
    to [0, 1], fall into ``num_bins`` bins per class; the binned ROC is
    integrated exactly, with an error of O(1/bins). Feed sigmoid
    probabilities batch by batch; ``compute()`` at the end."""

    def __init__(self, num_bins: int = 4096):
        self.num_bins = num_bins
        self._pos = np.zeros(num_bins, np.int64)
        self._neg = np.zeros(num_bins, np.int64)

    def update(self, scores, labels) -> None:
        s = np.clip(np.asarray(scores, np.float64).reshape(-1), 0.0, 1.0)
        y = np.asarray(labels).reshape(-1)
        if s.shape != y.shape:
            raise ValueError(f"scores {s.shape} vs labels {y.shape}")
        bins = np.minimum((s * self.num_bins).astype(np.int64),
                          self.num_bins - 1)
        self._pos += np.bincount(bins[y > 0], minlength=self.num_bins)
        self._neg += np.bincount(bins[y <= 0], minlength=self.num_bins)

    def compute(self) -> float:
        """AUC = P(score⁺ > score⁻) + ½·P(tie), from the class histograms;
        NaN without both classes."""
        npos, nneg = self._pos.sum(), self._neg.sum()
        if npos == 0 or nneg == 0:
            return float("nan")
        # for each positive bin: negatives strictly below + half of ties
        neg_below = np.concatenate(([0], np.cumsum(self._neg)[:-1]))
        wins = float((self._pos * neg_below).sum())
        ties = 0.5 * float((self._pos * self._neg).sum())
        return (wins + ties) / (float(npos) * float(nneg))

    def all_reduce(self, device) -> None:
        """Sum the class histograms across the ranks of a gang, through
        ``device`` (the group's: a card under NCCL), so that
        :meth:`compute` gives the AUC of every rank's predictions. A no-op
        outside a group."""
        from distributeddeeplearningspark_tpu_torch.parallel import collectives

        if not collectives.active():
            return
        import torch

        hist = torch.from_numpy(np.stack([self._pos, self._neg])).to(device)
        self._pos, self._neg = collectives.all_reduce_sum_(hist).cpu().numpy()


def auc_from_predictions(predictions, *, num_bins: int = 4096,
                         label_key: str = "label", max_examples: int | None = None,
                         chunk: int = 8192, device=None) -> float:
    """AUC over a stream of ``(example_dict, score)`` pairs (the label read
    from ``example_dict[label_key]``) or ``(score, label)`` pairs, fed to
    :class:`StreamingAUC` in chunks of ``chunk`` rows; ``max_examples``
    stops consuming the stream early. ``device`` (in a gang, each rank
    holding the pairs of its own rows): the histograms are summed across
    ranks through it before the AUC is computed."""
    auc = StreamingAUC(num_bins)
    scores: list = []
    labels: list = []
    buffered_rows = 0

    def flush():
        nonlocal buffered_rows
        if scores:
            auc.update(np.concatenate(scores), np.concatenate(labels))
            scores.clear()
            labels.clear()
            buffered_rows = 0

    stream = (predictions if max_examples is None
              else itertools.islice(predictions, max_examples))
    for a, b_ in stream:
        if isinstance(a, dict):
            score, label = b_, a[label_key]
        else:
            score, label = a, b_
        s = np.asarray(score, np.float64).reshape(-1)
        scores.append(s)
        labels.append(np.asarray(label).reshape(-1))
        buffered_rows += s.size
        if buffered_rows >= chunk:
            flush()
    flush()
    if device is not None:
        auc.all_reduce(device)
    return auc.compute()


def attention_matmul_flops(batch: int, heads: int, seq: int, head_dim: int, *,
                           causal: bool = False, train: bool = True) -> float:
    """Model matmul FLOPs of one attention op: the forward's QKᵀ and PV,
    and in training the backward's dV, dP, dQ and dK (4 more), each
    2·B·H·S²·D; causal halves them. Model flops, not implementation flops:
    the backward's recompute of the scores is not counted; GQA does not
    change the count."""
    one_matmul = 2.0 * batch * heads * seq * seq * head_dim
    total = 2 * one_matmul + (4 * one_matmul if train else 0.0)
    return total * (0.5 if causal else 1.0)


def llama_model_flops_per_token(cfg, seq: int, *,
                                frozen_base: bool = True) -> float:
    """Model FLOPs per trained token of a Llama step (2 flops a
    multiply-add, the convention published MFU numbers use).

    Counted: the projection, FFN and head matmuls (the embedding lookup is
    a gather), the attention score and value matmuls (causal halving, at
    the q-head count) and the LoRA adapter matmuls. Forward 2·P; backward
    dx 2·P again; backward dW 2·P for the trainable params only (the
    frozen-base step has no base dW). With MoE (``moe_experts`` above 0)
    each token runs ``moe_top_k`` expert FFNs and the router's projection;
    the dispatch and the dropped tokens are implementation- and
    load-dependent and not counted (JAX's count). Not counted: elementwise,
    norm and softmax work, the optimizer, and the remat recompute."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim
    ffn = 3 * h * i
    if getattr(cfg, "moe_experts", 0):
        ffn = cfg.moe_top_k * 3 * h * i + h * cfg.moe_experts
    p_layer = h * h + 2 * h * kvh + h * h + ffn
    p_matmul = cfg.num_layers * p_layer + v * h  # + head, embed is a gather
    lora = 0
    if cfg.lora_rank:
        sizes = {"wq": (h, h), "wk": (h, kvh), "wv": (h, kvh), "wo": (h, h),
                 "gate": (h, i), "up": (h, i), "down": (i, h)}
        lora = sum(cfg.num_layers * cfg.lora_rank * (fi + fo)
                   for t, (fi, fo) in sizes.items() if t in cfg.lora_targets)
    # fwd + bwd-dx always; dW for the trainable set only
    dense = (4 * p_matmul if frozen_base else 6 * p_matmul) + 6 * lora
    attn = cfg.num_layers * attention_matmul_flops(
        1, cfg.num_heads, seq, cfg.head_dim, causal=True, train=True) / seq
    return float(dense + attn)

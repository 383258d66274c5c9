"""Step timing and throughput, the per-step log line, ROC AUC, peak and
measured FLOPs.

The port's copy of ``Meter``, ``MetricLogger``, ``StreamingAUC``,
``auc_from_predictions``, ``attention_matmul_flops``,
``llama_model_flops_per_token``, ``PEAK_FLOPS`` and
``env_peak_flops_override`` from ``distributeddeeplearningspark_tpu/
metrics.py``; the chip count is the caller's (the Session's device count).
``MetricLogger`` writes one log line per call and, given a
``tensorboard_dir``, the same scalars to TensorBoard on rank 0;
``MetricLogger.event`` writes a recovery event's WARNING line, ``recovery``
telemetry record and ``recovery/<kind>`` scalar.

:func:`measured_flops_per_step` is the counterpart of JAX's
``compiled_flops_per_step``: where XLA's cost analysis reads a compiled
program, the eager port counts one real step under
``torch.utils.flop_counter.FlopCounterMode``. The mode sees the aten
products a step dispatches but not the hand-written kernels, which are
reached through ``ctypes``; so each kernel's wrapper adds its FLOP formula
(:func:`note_kernel_flops`) where it launches, and the formula gives what
the mode counts for the kernel's plain version at the same shapes:

- K1 (``flash_fwd``): the forward's two products, QKᵀ and PV, each
  ``2·B·H·Sq·Sk·D`` at the q-head count, masked tiles included as the
  plain version computes them (:func:`flash_fwd_flops`);
- K2 + K3 (``flash_bwd_dq``, ``flash_bwd_dkv``): the plain backward's four
  products, dP and dQ in K2, dV and dK in K3 (:func:`flash_bwd_flops`),
  each where autograd's backward of the plain attention computes it (dK
  only where k wants a gradient: a frozen layer-0 projection's does not,
  under LoRA); the kernels' recompute of QKᵀ is implementation work and is
  not counted, as that backward has none (the kernels' CPU stand-in,
  ``_backward_plain``, recomputes it and so counts a fifth product);
- K4 (``matmul_stats``): its product ``2·M·K·N`` (:func:`matmul_flops`);
- K5 (``scatter_add_rows``): none, as the mode counts none for
  ``index_add_``.

So a step counts the same on the kernel route and on the plain path. The
fused head loss (:mod:`.train.fused_ce`) is ``torch.mm`` calls the mode
counts as they run, its f32-output products on the card among them: the
forward's chunked logits, and in the backward the recompute of each
chunk's logits and ``dh`` (and ``dW`` where the head trains), so a fused
step counts 2·N·H·V more than the plain head's forward and dx over its N
labelled rows. The int8 base's dequantisation is elementwise and counts
nothing. The ring's hops count their kernels with every gradient wanted and skip the
causal hops no query attends, so a ring's count is not one card's. The
count is made global by one all-reduce over the gang: each rank counts the
products of its own rows (FSDP2 gathers the params, so a rank's products
are full width on its rows), and work every peer of a ``tensor`` group
repeats on the same rows (a LoRA factor kept whole, the MoE router) goes
through :func:`replicated_matmul`, which only the group's first peer
counts. The count equals one card's of the same global batch.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.metrics")

#: bf16 dense peak FLOP/s per card, by ``torch.cuda.get_device_name()``:
#: NVIDIA's H100 data sheet (SXM5 and PCIe parts, dense, without sparsity)
PEAK_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
}


def env_peak_flops_override() -> float | None:
    """The validated ``DLS_PEAK_FLOPS`` env override, or None: the one
    parse :func:`device_peak_flops` and the anatomy layer's labelled
    resolution (:func:`..telemetry.anatomy.resolve_peak_flops`) share."""
    raw = os.environ.get("DLS_PEAK_FLOPS")
    if raw:
        try:
            v = float(raw)
        except ValueError:
            logger.warning("ignoring malformed DLS_PEAK_FLOPS=%r", raw)
            return None
        if v > 0:
            return v
    return None


def device_peak_flops(device: torch.device | str | None = None) -> float | None:
    """Per-card peak FLOP/s for the MFU denominator: ``DLS_PEAK_FLOPS``,
    else the spec table by the card's name; None on the CPU or an unknown
    card."""
    v = env_peak_flops_override()
    if v is not None:
        return v
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


class Meter:
    """Per-lap wall-clock and throughput accounting.

    Laps must be recorded where the host has just synchronized with the
    device (e.g. right after copying that step's metrics to the host): CUDA
    runs ahead of the host, so a lap taken elsewhere measures the enqueue,
    not the compute. The first lap (kernel builds, cuBLAS heuristics,
    allocator growth) is left out of the summary when later laps exist.
    With the step's FLOPs (:meth:`set_flops`, global) and a known peak for
    ``device`` (:func:`device_peak_flops`), the summary adds
    ``model_flops_per_sec_per_chip`` and ``mfu``."""

    def __init__(self, *, examples_per_step: int = 0, tokens_per_step: int = 0,
                 num_chips: int = 1, device: torch.device | str | None = None):
        self.examples_per_step = examples_per_step
        self.tokens_per_step = tokens_per_step
        self.num_chips = num_chips
        self.device = device
        self.flops_per_step: float | None = None
        self._laps: list[tuple[float, int]] = []
        self._last: float | None = None
        self._metrics_history: list[dict[str, float]] = []
        #: the most recent (elapsed_s, num_steps) lap
        self.last_lap: tuple[float, int] | None = None

    def set_flops(self, flops: float | None) -> None:
        self.flops_per_step = flops

    @property
    def last_time(self) -> float | None:
        """The clock's reading at the last :meth:`start` or :meth:`lap`."""
        return self._last

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
        peak = device_peak_flops(self.device) if self.flops_per_step else None
        if peak:
            out["model_flops_per_sec_per_chip"] = (self.flops_per_step / step_time
                                                   / self.num_chips)
            out["mfu"] = out["model_flops_per_sec_per_chip"] / peak
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
    """One structured log line per call, ``step N: {json}``, and, given a
    ``tensorboard_dir``, each metric as a TensorBoard scalar written by rank
    0 only (where the ``tensorboard`` package is missing: one warning, then
    the log lines alone, as in the JAX package). Recovery events are WARNING
    lines of their own, mirrored into ``telemetry`` (an
    :class:`~.telemetry.EventWriter`) when given."""

    def __init__(self, *, telemetry=None, tensorboard_dir: str | None = None):
        from distributeddeeplearningspark_tpu_torch.parallel import collectives

        self._telemetry = telemetry
        self._tb = None
        if tensorboard_dir and collectives.rank() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:  # noqa: BLE001 — tensorboard is optional
                logger.warning("tensorboard writer unavailable; file logging only")

    def log(self, step: int, metrics: dict[str, float]) -> None:
        """Emit unconditionally — cadence is the caller's decision."""
        logger.info("step %d: %s", step,
                    json.dumps({k: _log_value(v) for k, v in metrics.items()}))
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def event(self, step: int, kind: str, **fields) -> None:
        """Surface a recovery event (a divergence skip, a rollback) on rank
        0 as a WARNING line of its own — the line an operator greps for
        after an incident — as a ``recovery`` telemetry record, so the
        audit trail survives the process, and as a ``recovery/<kind>``
        TensorBoard scalar."""
        from distributeddeeplearningspark_tpu_torch.parallel import collectives

        if collectives.rank() != 0:
            return
        logger.warning("recovery event at step %d: %s %s", step, kind,
                       json.dumps(fields, default=str))
        if self._telemetry is not None:
            self._telemetry.recovery(step, kind, **fields)
        if self._tb is not None:
            self._tb.add_scalar(f"recovery/{kind}", 1.0, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


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


# -- measured FLOPs ------------------------------------------------------------

#: the kernels' FLOPs noted since :func:`measured_flops_per_step` began
#: counting (None: not counting)
_kernel_flops: list[int] | None = None
#: False while a peer that does not count a replicated product runs it
_counted = True


def flash_fwd_flops(b: int, sq: int, sk: int, h: int, d: int) -> int:
    """K1's FLOPs: QKᵀ and PV, ``2·B·H·Sq·Sk·D`` each at the q-head count
    (GQA shares K/V, not the products), every tile as the plain version
    computes it (a causal or padding mask changes no count)."""
    return 2 * (2 * b * h * sq * sk * d)


def flash_bwd_flops(b: int, sq: int, sk: int, h: int, d: int) -> int:
    """K2 + K3's FLOPs: the plain backward's dP, dQ, dV and dK (the
    kernels' recompute of QKᵀ not counted); K2 notes dP and dQ, K3 dV and
    dK, half each."""
    return 4 * (2 * b * h * sq * sk * d)


def matmul_flops(m: int, k: int, n: int) -> int:
    """K4's FLOPs: ``Y = X @ W``, ``2·M·K·N`` (the column sums are not
    counted, as the mode counts no reduction)."""
    return 2 * m * k * n


def note_kernel_flops(flops: int) -> None:
    """Called by a kernel's wrapper where it launches: adds the kernel's
    FLOP formula to the count :func:`measured_flops_per_step` is taking
    (nothing when none is)."""
    counts = _kernel_flops
    if counts is not None:
        counts.append(int(flops))


@contextlib.contextmanager
def _uncounted(counted: bool):
    """Products run inside count nothing unless ``counted``."""
    global _counted
    prev, _counted = _counted, bool(counted) and _counted
    try:
        yield
    finally:
        _counted = prev


class _ReplicatedMatmul(torch.autograd.Function):
    """``x @ w`` that every peer of a group computes alike on the same rows,
    with autograd's products (forward ``mm``; backward ``g·wᵀ`` and
    ``xᵀ·g``), counted only where ``counted``."""

    @staticmethod
    def forward(ctx, x, w, counted):
        ctx.save_for_backward(x, w)
        ctx.counted = counted
        with _uncounted(counted):
            y = x.reshape(-1, x.shape[-1]) @ w
        return y.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        with _uncounted(ctx.counted):
            if ctx.needs_input_grad[0]:
                gx = (g2 @ w.t()).view(x.shape)
            if ctx.needs_input_grad[1]:
                gw = x.reshape(-1, x.shape[-1]).t() @ g2
        return gx, gw, None


def replicated_matmul(x: torch.Tensor, w: torch.Tensor, *, counted: bool
                      ) -> torch.Tensor:
    """``x @ w`` (x ``[..., K]``, w ``[K, N]``) for a product every peer of
    a ``tensor`` group repeats on the same rows; pass ``counted`` True on
    one peer of the group only, so that :func:`measured_flops_per_step`'s
    global count holds it once. The values are autograd's."""
    return _ReplicatedMatmul.apply(x, w, counted)


def _no_flops(*args, out_val=None, **kwargs) -> int:
    return 0


class _EveryOp(dict):
    """``FlopCounterMode``'s formula registry, answering for every op: an op
    with no formula counts 0 and runs as it is. The mode decomposes an op
    it has no formula for, and a decomposed op can round otherwise than its
    kernel (``silu_backward``'s does on the CPU): the counted step would
    not be the step trained."""

    def __contains__(self, op) -> bool:
        return True

    def __missing__(self, op):
        return _no_flops


class _GlobalOnly:
    """Stands in for ``FlopCounterMode``'s module tracker, which holds each
    module's inputs and outputs until the backward reaches them: a remat
    step's activations all stay alive under it (a 7B LoRA step on an H100
    peaked at 35.9 GB against 20.9 without). The count needs no split by
    module: every product is the "Global" parent's."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


def _count_unless_replicated(formula: Callable) -> Callable:
    def count(*args, out_val=None, **kwargs):
        return formula(*args, out_val=out_val, **kwargs) if _counted else 0

    count._get_raw = True
    return count


@contextlib.contextmanager
def counting_flops(device: torch.device | str | None = None, group=None):
    """Count the FLOPs of the work run inside, as the dict ``{"flops":
    n}`` it yields holds once the block ends: ``FlopCounterMode``'s count
    of the aten products plus the kernels' formulas (:func:`note_kernel_
    flops`), summed over ``group``'s ranks (default: the whole gang; in a
    gang pass ``device``, the one its collectives run on)."""
    global _kernel_flops
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    if _kernel_flops is not None:
        raise RuntimeError("counting_flops does not nest")
    mm = torch.ops.aten.mm
    mode = FlopCounterMode(display=False, custom_mapping={
        mm: _count_unless_replicated(flop_registry[mm])})
    mode.flop_registry = _EveryOp(mode.flop_registry)
    mode.mod_tracker = _GlobalOnly()
    out: dict[str, int] = {}
    _kernel_flops = kernels = []
    try:
        with mode:
            yield out
    finally:
        _kernel_flops = None
    local = int(mode.get_total_flops()) + sum(kernels)
    from distributeddeeplearningspark_tpu_torch.parallel import collectives

    if collectives.active():
        t = torch.tensor([local], dtype=torch.int64,
                         device=device if device is not None else "cpu")
        local = int(collectives.all_reduce_sum_(t, group).item())
    out["flops"] = local


def measured_flops_per_step(step: Callable[[], Any], *,
                            device: torch.device | str | None = None,
                            group=None) -> tuple[Any, int]:
    """``(step(), flops)``: one real step run under :func:`counting_flops`,
    its FLOPs global over the gang. The step's result is returned, so the
    counted step is a step of training, not an extra one."""
    with counting_flops(device, group) as n:
        result = step()
    return result, n["flops"]

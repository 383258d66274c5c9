"""Analytic per-chip HBM budget for Llama training layouts.

The port's copy of ``distributeddeeplearningspark_tpu/utils/memory.py``,
as it is: the same ``llama_param_count`` and ``llama_memory_report`` over
a config with the JAX one's fields. The port's ``LlamaConfig`` has no
``remat_policy``: its remat checkpoints each layer whole, JAX's policy
None, which is what a missing one reads as.
Its figures reckon the JAX layouts (the TPU's HBM, XLA's buffers); on the
card the port measures its peak instead (``memory`` events,
``torch.cuda.max_memory_allocated``). The JAX module's account follows.

Config 5 names "Llama-2 7B LoRA … on v4-32": this module is the checked-in
memory analysis, a component-by-component byte budget for a (batch, seq,
mesh, remat, LoRA) layout.

The budget model (bf16 params/activations, f32 LoRA optimizer state):

- **base params**: every dense kernel + embeddings, bf16, sharded over
  mesh's fsdp×tensor product (GSPMD shards both; data/seq axes replicate).
- **LoRA params + AdamW state**: rank·(in+out) per adapted projection; the
  masked optimizer allocates m/v for trainable leaves only. f32 ×3 (param
  + m + v) + a bf16 compute copy.
- **gradients**: trainable-only (frozen base excluded from autodiff —
  train/step.py `trainable`); transient f32 at adapter size.
- **activations** (the term remat policy controls), per layer per token:
  - policy None: only the scan-carry residual stream survives the forward
    (hidden bf16), everything else recomputes in backward;
  - policy "dots": matmul outputs are kept — q/k/v/attn-out, gate/up/down:
    (3 + 2·kv/h)·H + 3·I bf16 per token per layer, plus the carry.
  Activations shard over data×seq (batch and sequence parallel axes);
  tensor shards the head/ffn dims of the saved dots.
- **head/loss**: fused CE keeps [B,S,H] hidden + chunked logits (≤
  chunk·V); unfused keeps [B,S,V] f32 logits + cotangent (the 2.1 GB the
  fused path exists to kill).
- **workspace**: one transient ~max-layer-tensor ×2 allowance for XLA
  temp buffers (measured fudge, stated explicitly in the report).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

GiB = 1024 ** 3


@dataclass
class MemoryReport:
    components: dict[str, float]  # bytes per chip
    mesh: dict[str, int]
    notes: list[str]

    @property
    def total_bytes(self) -> float:
        return sum(self.components.values())

    def fits(self, hbm_bytes: float) -> bool:
        return self.total_bytes <= hbm_bytes

    def to_dict(self) -> dict:
        return {
            "per_chip_gib": {k: round(v / GiB, 3)
                             for k, v in self.components.items()},
            "total_gib_per_chip": round(self.total_bytes / GiB, 3),
            "mesh": dict(self.mesh),
            "notes": list(self.notes),
        }


def llama_param_count(cfg) -> dict[str, int]:
    """Exact parameter counts by group (validated vs model.init in tests)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvh = cfg.num_kv_heads * cfg.head_dim
    # MoE (moe_experts > 0) replaces the dense FFN with a router + an
    # E-wide expert bank — the DOMINANT param term (bf16 E=8 at the 0.9b
    # shape is 8.9 GiB of kernels alone); counted exactly like model.init
    e = getattr(cfg, "moe_experts", 0)
    ffn = (h * e + e * 3 * h * i) if e else 3 * h * i
    per_layer = (
        h * h            # wq
        + 2 * h * kvh    # wk, wv
        + h * h          # wo
        + ffn            # dense SwiGLU, or router + stacked expert bank
        + 2 * h          # two RMSNorm scales
    )
    base = cfg.num_layers * per_layer + v * h + h + v * h  # + final norm + head
    if getattr(cfg, "base_quant", None) == "int8":
        # per-output-channel scale leaves ride next to every int8 kernel
        base += cfg.num_layers * (3 * h + 2 * kvh + 2 * i)
    lora = 0
    if cfg.lora_rank:
        r = cfg.lora_rank
        sizes = {"wq": (h, h), "wk": (h, kvh), "wv": (h, kvh), "wo": (h, h),
                 "gate": (h, i), "up": (h, i), "down": (i, h)}
        for t in cfg.lora_targets:
            if t in sizes:
                fin, fout = sizes[t]
                lora += cfg.num_layers * r * (fin + fout)
    return {"base": base, "lora": lora}


def llama_memory_report(
    cfg,
    *,
    batch: int,
    seq: int,
    mesh_shape: dict[str, int] | None = None,
    optimizer: str = "adamw",
    trainable: str = "lora",
    hbm_per_chip_gib: float | None = None,
) -> MemoryReport:
    """Per-chip HBM budget for one train step of ``cfg`` at (batch, seq).

    ``mesh_shape``: axis→size (missing axes = 1); params shard over
    fsdp×tensor, activations over data×seq. ``trainable='lora'`` assumes
    the frozen-base autodiff exclusion (no base grads/opt state).
    """
    mesh_shape = dict(mesh_shape or {})
    dp = mesh_shape.get("data", 1)
    fsdp = mesh_shape.get("fsdp", 1)
    tp = mesh_shape.get("tensor", 1)
    sp = mesh_shape.get("seq", 1)
    param_shard = fsdp * tp
    act_shard = dp * sp

    counts = llama_param_count(cfg)
    notes: list[str] = []
    comp: dict[str, float] = {}
    # STORAGE dtype of the base weights (LlamaConfig.param_dtype): the
    # byte count must come from the config, not an assumption (a budget
    # that assumed bf16 for f32 weights read 12.6 GiB against 25.2)
    pdt = str(getattr(cfg, "param_dtype", "float32"))
    pbytes = 2 if ("bfloat16" in pdt or "float16" in pdt) else 4
    if getattr(cfg, "base_quant", None) == "int8":
        # int8 projection/FFN kernels + f32 per-out-channel scales; the
        # embedding and LM head stay at param_dtype (QLoRA convention,
        # see LlamaConfig.base_quant). Scales are per output channel —
        # ≤ (heads·hd + i + h) per layer, O(1e-3) of the kernel bytes.
        emb_head = 2 * cfg.vocab_size * cfg.hidden_size
        norms = cfg.num_layers * 2 * cfg.hidden_size + cfg.hidden_size
        scales = cfg.num_layers * (
            2 * cfg.hidden_size                       # wq out + wo out
            + 2 * cfg.num_kv_heads * cfg.head_dim     # wk, wv out
            + 2 * cfg.intermediate_size               # gate, up out
            + cfg.hidden_size)                        # down out
        # counts["base"] already includes the scale leaves (param-count
        # parity with model.init) — subtract them so they aren't charged
        # once at 1 B here and again at 4 B below
        kernels = counts["base"] - emb_head - norms - scales
        comp["base_params_int8"] = (
            kernels * 1 + (scales + norms) * 4 + emb_head * pbytes
        ) / param_shard
        notes.append("base_quant=int8: kernels 1 B + f32 scales; "
                     "embed/head at param_dtype")
    else:
        comp[f"base_params_{'bf16' if pbytes == 2 else 'f32'}"] = (
            counts["base"] * pbytes / param_shard)

    n_lora = counts["lora"]
    if trainable == "lora" and cfg.lora_rank:
        # f32 master + AdamW m/v (masked optimizer: trainable leaves only)
        opt_mult = 3 if optimizer == "adamw" else 1
        comp["lora_params_opt_f32"] = n_lora * 4 * opt_mult / param_shard
        comp["trainable_grads_f32"] = n_lora * 4 / param_shard
    else:
        opt_mult = 3 if optimizer == "adamw" else 1
        comp["params_opt_f32"] = counts["base"] * 4 * opt_mult / param_shard
        comp["grads_f32"] = counts["base"] * 4 / param_shard
        notes.append("full-parameter training: base grads + opt state counted")

    tokens = batch * seq
    h, i = cfg.hidden_size, cfg.intermediate_size
    kv_frac = cfg.num_kv_heads / cfg.num_heads
    carry = tokens * h * 2  # residual stream checkpointed per scan step
    if cfg.remat and getattr(cfg, "remat_policy", None) is None:
        per_layer_saved = carry
        notes.append("remat_policy=None: only the scan carry survives fwd")
    elif cfg.remat:  # "dots"-family
        dots = tokens * ((3 + 2 * kv_frac) * h + 3 * i) * 2
        per_layer_saved = carry + dots
        notes.append("remat_policy=dots: matmul outputs kept per layer")
    else:
        # no remat: everything live — dots + norms + softmax probs (approx)
        dots = tokens * ((3 + 2 * kv_frac) * h + 3 * i) * 2
        per_layer_saved = carry + dots + tokens * h * 4
        notes.append("remat off: full activation liveness (approximate)")
    # tensor parallel shards the dot outputs' feature dims; the carry
    # (residual stream) is replicated across tensor — data/seq shard it
    comp["activations_bf16"] = cfg.num_layers * (
        carry / act_shard + (per_layer_saved - carry) / act_shard / tp)

    v = cfg.vocab_size
    if cfg.fused_head_loss:
        chunk = min(tokens, 2048)
        comp["loss_head"] = (tokens * h * 2 + chunk * v * 4) / act_shard
        notes.append("fused CE: chunked logits, no [B,S,V] materialization")
    else:
        comp["loss_head"] = tokens * v * 4 * 2 / act_shard  # logits + cotangent
        notes.append("unfused head: [B,S,V] f32 logits + cotangent live")

    # transient workspace: ~2× the largest single tensor in flight
    biggest = max(tokens * max(h, i) * 2 / act_shard,
                  counts["base"] * 2 / param_shard / max(cfg.num_layers, 1))
    comp["xla_workspace_allowance"] = 2 * biggest
    notes.append("workspace = 2x largest in-flight tensor (stated fudge)")

    if hbm_per_chip_gib is not None:
        notes.append(
            f"fits {hbm_per_chip_gib} GiB/chip: "
            f"{sum(comp.values()) <= hbm_per_chip_gib * GiB}")
    return MemoryReport(components=comp, mesh=mesh_shape, notes=notes)

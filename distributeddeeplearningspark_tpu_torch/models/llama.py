"""Llama-2 decoder + LoRA (BASELINE.json config 5) — the port of
``distributeddeeplearningspark_tpu/models/llama.py``, its dense model.

Pre-norm RMSNorm, rotary position embeddings (rotate-half, in f32), SwiGLU
MLP, untied LM head (Touvron et al. 2023); 7B = 32 layers × 4096 hidden, 32
heads, 11008 intermediate. Grouped-query attention (``num_kv_heads`` <
``num_heads``) reaches the flash kernels without repeating K/V. Same
numerics as the flax model, which the CPU tests hold it to:

- base weights are stored in ``cfg.param_dtype`` (bf16 for the 7B LoRA
  fine-tune: the frozen base never takes an optimizer step) and every
  matmul runs in ``cfg.dtype``; RMSNorm computes in f32; the LM head is a
  ``cfg.dtype`` matmul whose logits are cast to f32;
- LoRA lives in :class:`LoRALinear`: ``y = x·Wᵀ + (x·A)·B·alpha/rank`` on
  ``cfg.lora_targets`` (``wq``, ``wv``), A he-uniform and B zero, both
  stored in f32 and named ``lora_a``/``lora_b``, the names
  :func:`lora_trainable` keys on;
- attention goes through :func:`..ops.attention.dot_product_attention`
  (causal, a padding mask and ``segment_ids`` when the batch has them):
  ``attention_impl="auto"`` takes the flash kernels on CUDA at bf16,
  D = 128 and S a multiple of 512 (K1 forward, K2/K3 backward).

The layers are a ``ModuleList``; the flax model's default stacks them
(``nn.scan``), which :mod:`.llama_io` unstacks. Weights use torch's
``[out, in]`` layout. With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant: with a frozen embedding layer
0's input needs no gradient, and a reentrant checkpoint would then drop
every adapter's), so its activations are recomputed in the backward, K1
with them.

Batch dict: ``input_ids`` [B,S] int, optional ``attention_mask`` [B,S] 1/0
and ``segment_ids`` [B,S]; ``loss_mask`` is the loss's. Returns logits
[B,S,vocab] f32.

:func:`llama_rules` is the JAX ``llama_rules`` over the port's param
names: the layout ``Trainer(rules=...)`` lowers to FSDP2 over the ``fsdp``
axis (:mod:`..parallel.sharding`), its ``tensor`` entries kept in torch's
``[out, in]`` layout for tensor parallelism.

Not ported yet, and refused by name: the MoE FFN and ring/Ulysses
attention (ROADMAP Queue 1 item 6), the int8 frozen base and the fused
head loss (item 5), decoding with a KV cache (item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddeeplearningspark_tpu_torch.ops.attention import (
    dot_product_attention,
    padding_mask,
)
from distributeddeeplearningspark_tpu_torch.parallel.sharding import P, ShardingRules
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32          # < num_heads → grouped-query attention
    intermediate_size: int = 11008
    max_position: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: storage dtype of the base weights (embedding, projections, head);
    #: the LoRA A/B and the norm scales stay f32
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"
    remat: bool = True
    lora_rank: int = 0              # 0: no adapters
    lora_alpha: float = 16.0
    lora_targets: Sequence[str] = ("wq", "wv")
    # the JAX config's options the port refuses (LlamaForCausalLM)
    fused_head_loss: bool = False
    moe_experts: int = 0
    base_quant: str | None = None
    decode: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        """Llama-2 7B; with LoRA the base is stored in bf16 (it never takes
        an optimizer step)."""
        if kw.get("lora_rank") and "param_dtype" not in kw:
            kw["param_dtype"] = torch.bfloat16
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        """Llama-2 13B geometry (multi-head: 13B predates GQA)."""
        base = dict(hidden_size=5120, num_layers=40, num_heads=40,
                    num_kv_heads=40, intermediate_size=13824)
        base.update(kw)
        return LlamaConfig.llama2_7b(**base)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """4-layer/128-wide config for CPU tests."""
        base = dict(vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
                    num_kv_heads=2, intermediate_size=256, max_position=128,
                    dtype=torch.float32)
        base.update(kw)
        return LlamaConfig(**base)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """RoPE on [B,S,H,D] in f32, half-split (rotate-half) convention;
    ``positions`` [B or 1, S]."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    angles = positions.float()[..., None] * inv_freq              # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]                        # [B,S,1,D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """Llama RMSNorm: f32 arithmetic, a learned f32 scale, no bias; the
    output cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(self.dtype)


class LoRALinear(nn.Module):
    """The flax ``LoRADenseGeneral`` without a bias: ``x·Wᵀ`` in
    ``dtype``, plus ``(x·A)·B·alpha/rank`` when ``rank`` > 0 (A ``[in, r]``
    and B ``[r, out]``, f32, cast to ``dtype`` for the products). The base
    weight is frozen by the caller (``Trainer(trainable=lora_trainable)``),
    never by the module."""

    def __init__(self, d_in: int, d_out: int, *, rank: int, alpha: float,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=param_dtype,
                                               device=device))
        if rank:
            self.lora_a = nn.Parameter(torch.empty(d_in, rank, dtype=torch.float32,
                                                   device=device))
            self.lora_b = nn.Parameter(torch.zeros(rank, d_out, dtype=torch.float32,
                                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        y = F.linear(x, self.weight.to(dt))
        if self.rank:
            delta = (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + (delta * (self.alpha / self.rank)).to(y.dtype)
        return y


def _proj(cfg: LlamaConfig, name: str, d_in: int, d_out: int, device
          ) -> LoRALinear:
    """The projection ``name``, with adapters when it is a LoRA target."""
    rank = cfg.lora_rank if name in cfg.lora_targets else 0
    return LoRALinear(d_in, d_out, rank=rank, alpha=cfg.lora_alpha, dtype=cfg.dtype,
                      param_dtype=cfg.param_dtype, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.wq = _proj(cfg, "wq", h, cfg.num_heads * hd, device)
        self.wk = _proj(cfg, "wk", h, cfg.num_kv_heads * hd, device)
        self.wv = _proj(cfg, "wv", h, cfg.num_kv_heads * hd, device)
        self.wo = _proj(cfg, "wo", cfg.num_heads * hd, h, device)

    def forward(self, x, mask, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(b, s, cfg.num_heads, hd)
        k = self.wk(x).view(b, s, cfg.num_kv_heads, hd)
        v = self.wv(x).view(b, s, cfg.num_kv_heads, hd)
        positions = torch.arange(s, device=x.device)[None, :]
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        y = dot_product_attention(q, k, v, mask=mask, causal=True,
                                  segment_ids=segment_ids,
                                  impl=cfg.attention_impl)
        return self.wo(y.reshape(b, s, cfg.num_heads * hd))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate = _proj(cfg, "gate", h, i, device)
        self.up = _proj(cfg, "up", h, i, device)
        self.down = _proj(cfg, "down", i, h, device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class DecoderLayer(nn.Module):
    """Pre-norm block: ``x + attention(norm(x))``, then ``x + mlp(norm(x))``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        self.attention = LlamaAttention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, mask, segment_ids=None):
        x = x + self.attention(self.attention_norm(x), mask, segment_ids)
        return x + self.mlp(self.mlp_norm(x))


#: the flax config's options the port refuses → their ROADMAP item
_NOT_PORTED = {
    "moe_experts": "the MoE FFN (models/moe.py): ROADMAP Queue 1 item 6",
    "base_quant": "the int8 frozen base: ROADMAP Queue 1 item 5",
    "decode": "KV-cached decoding (models/llama_gen.py): ROADMAP Queue 1 item 8",
    "fused_head_loss": "the fused head loss (train/fused_ce.py): ROADMAP Queue 1 item 5",
}


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM; logits [B,S,vocab] f32 (untied head, as in Llama-2)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        for field, why in _NOT_PORTED.items():
            if getattr(cfg, field):
                raise NotImplementedError(f"LlamaConfig.{field} is not ported "
                                          f"yet ({why})")
        if cfg.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} is not ported yet "
                f"(context parallelism: ROADMAP Queue 1 item 6)")
        self.cfg = cfg
        h = cfg.hidden_size
        self.token_embed = nn.Embedding(cfg.vocab_size, h, dtype=cfg.param_dtype,
                                        device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(h, cfg.rms_eps, cfg.dtype, device)
        self.lm_head = nn.Linear(h, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is taken for the Trainer's call and unused: Llama-2
        has no dropout."""
        del generator
        cfg, dt = self.cfg, self.cfg.dtype
        ids = batch["input_ids"]
        if ids.shape[1] > cfg.max_position:
            raise ValueError(f"sequence length {ids.shape[1]} exceeds "
                             f"max_position {cfg.max_position}")
        x = F.embedding(ids, self.token_embed.weight.to(dt))
        pad = batch.get("attention_mask")
        # causal is handled inside attention; a mask only for padding
        mask = padding_mask(pad) if pad is not None else None
        segment_ids = batch.get("segment_ids")
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask, segment_ids, use_reentrant=False)
            else:
                x = layer(x, mask, segment_ids)
        x = self.final_norm(x)
        return F.linear(x.to(dt), self.lm_head.weight.to(dt)).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaForCausalLM":
        """Random weights from ``generator``, at the flax initialisers'
        scales: the embedding normal(0, 1/√H), the projections and the head
        normal(0, 1/√fan_in) (lecun's scale, not truncated), LoRA A
        he-uniform (±√(6/fan_in)), B zero, unit norm scales. Drawn on the
        params' device, in their dtype."""
        self.token_embed.weight.normal_(0.0, self.cfg.hidden_size ** -0.5,
                                        generator=generator)
        for mod in self.modules():
            if isinstance(mod, (LoRALinear, nn.Linear)):
                fan_in = mod.weight.shape[1]
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if isinstance(mod, LoRALinear) and mod.rank:
                limit = math.sqrt(6.0 / mod.lora_a.shape[0])
                mod.lora_a.uniform_(-limit, limit, generator=generator)
                mod.lora_b.zero_()
            if isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
        return self


def _build(cfg: LlamaConfig, device, seed: int) -> LlamaForCausalLM:
    dev = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def llama2_7b(*, device="cuda", seed: int = 0, **kw) -> LlamaForCausalLM:
    """Llama-2 7B on ``device`` (the card unless ``device="cpu"``), in eval
    mode, with random weights made on the device from ``seed``."""
    return _build(LlamaConfig.llama2_7b(**kw), device, seed)


def llama2_13b(*, device="cuda", seed: int = 0, **kw) -> LlamaForCausalLM:
    return _build(LlamaConfig.llama2_13b(**kw), device, seed)


def llama_tiny(*, device="cuda", seed: int = 0, **kw) -> LlamaForCausalLM:
    return _build(LlamaConfig.tiny(**kw), device, seed)


def lora_trainable(path: str) -> bool:
    """The LoRA fine-tune's predicate over param names: the adapters train,
    the base is frozen. Give it to ``optim.masked`` and to
    ``Trainer(trainable=...)``."""
    return "lora_a" in path or "lora_b" in path


def llama_rules(cfg: LlamaConfig, *, fsdp: bool = True,
                fsdp_min_size: int = 2**14, pipeline: bool = False) -> ShardingRules:
    """FSDP + Megatron-style tensor-parallel layout for the Llama params
    (JAX's ``llama_rules``, on torch's ``[out, in]`` weights).

    Attention's q/k/v shard their heads (output rows) over ``tensor``; the
    out-projection and the MLP's down-projection shard their input
    (contracting) columns, so the pair is a split matmul and one
    all-reduce a block. The embedding and the LM head shard the vocab.
    LoRA adapters stay replicated: rank-r factors are too small to be worth
    a collective. The auto-FSDP pass then shards the largest remaining dim
    of every param of at least ``fsdp_min_size`` elements over ``fsdp``.
    The port's mesh refuses ``tensor`` above 1 (ROADMAP Queue 1 item 5), so
    today only the FSDP pass shards. The int8 base, the MoE bank and the
    pipeline's stage layout raise, as the model does."""
    if pipeline:
        raise NotImplementedError(
            "llama_rules(pipeline=True): the pipeline (models/llama_pp.py) is "
            "not ported yet: ROADMAP Queue 1 item 6")
    for field in ("base_quant", "moe_experts"):
        if getattr(cfg, field):
            raise NotImplementedError(f"llama_rules for LlamaConfig.{field}: "
                                      f"{_NOT_PORTED[field]}")
    rules = (
        (r"lora_", P()),
        (r"(wq|wk|wv)/weight", P("tensor", None)),
        (r"wo/weight", P(None, "tensor")),
        (r"(gate|up)/weight", P("tensor", None)),
        (r"down/weight", P(None, "tensor")),
        (r"token_embed/weight", P("tensor", None)),
        (r"lm_head/weight", P("tensor", None)),
    )
    return ShardingRules(rules=rules, fsdp=fsdp, fsdp_min_size=fsdp_min_size,
                         fsdp_exclude=(r"lora_",))

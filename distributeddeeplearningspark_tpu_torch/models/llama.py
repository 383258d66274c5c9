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
names, its ``tensor`` entries in torch's ``[out, in]`` layout: the layout
``Trainer(rules=...)`` lowers onto the mesh (:mod:`..parallel.sharding`).

Under tensor parallelism (the lowering made the projections, the
embedding and the head ``DTensor``\\ s split over ``tensor``) each layer
reads its weights' placements (``sharding.tensor_split``) and runs on its
shard, Megatron's way, on plain local tensors (the flash kernels never see
a ``DTensor``): attention on its local heads (``num_heads`` and
``num_kv_heads`` must each divide by ``tensor``, else ``ValueError``) and
the MLP on its local columns of ``intermediate_size``; each block's input
goes through ``collectives.all_reduce_backward`` (its gradient summed
over the group) and the row-split ``wo``/``down`` outputs through
``all_reduce_forward``. The embedding looks up the ids of its vocab rows
and sums over the group; the head's logits stay split over the vocab, a
``DTensor`` ``Shard(2)`` that ``losses.causal_lm`` reduces without
gathering them. The LoRA adapters stay whole on every rank, as JAX keeps
them (``lora_`` → ``P()``): a column-split projection adds ``(x·A)·B[:,
its columns]``, so each peer's gradients of A and B are parts of the
whole, and the adapters go through ``all_reduce_backward`` too
(:func:`adapter_shards`): their gradients arrive summed over the group,
while the norm scales', whole on every peer already, are not. The
adapter's products that every peer repeats (x·A under a column split, ·B
under a row split) go through :func:`~..metrics.replicated_matmul`, so a
measured FLOP count holds them once.

Context parallelism (``attention_impl`` ``"ring"`` or ``"ulysses"``,
JAX's): the batch reaching the model is this rank's block of every row's
sequence, the block at its ``seq`` index on the session's mesh
(``Trainer(context_parallel=True)`` feeds it, :mod:`..data.feed`). The
RoPE positions are then global (:func:`positions`: ``seq index ·
S_local + arange(S_local)``), ``max_position`` holds the whole sequence,
and attention (on the local heads under tensor parallelism) goes to
:mod:`..ops.ring_attention` or :mod:`..ops.ulysses`, which exchange K/V
over the ``seq`` group. At ``seq`` 1 both are plain local attention.

With ``cfg.moe_experts`` above 0 every layer's MLP is the MoE FFN
(:class:`..models.moe.MoEMLP`, named ``moe``: top-``moe_top_k`` routing,
``moe_capacity_factor``, ``moe_group_size``), as in the flax model. In
training (``model.train()``, JAX's ``train=True``) the model then returns
``{"logits", "moe_aux", "moe_dropped_frac"}``: the load-balance losses
summed over the layers, weighed by ``moe_aux_weight``, and the dropped
share averaged over them; in eval mode, plain logits. The load balance is
a product of two means over the global batch: each layer's batch sums
(:func:`..models.moe.load_balance`) are added over the ranks that hold
distinct rows by :attr:`LlamaForCausalLM.batch_sum` (one differentiable
all-reduce of the ``[L, 2E + 2]`` sums, outside the remat regions) before
the product. Under expert parallelism (``llama_rules`` splits the bank's
experts over ``expert``) each rank runs its own experts; the module
docstring of :mod:`..models.moe` says how the tokens enter and leave them.

On a pipeline (the session's ``pipe`` above 1) the ``Trainer`` converts
the model (:func:`.llama_pp.make_pp_model`): the layers other stages hold
become :class:`ElsewhereLayer` places and ``model.pipe`` runs the GPipe
forward; ``llama_rules(pipeline=True)`` lays the layers out by stage.

``cfg.base_quant="int8"`` (JAX's QLoRA-style base): every projection's
frozen base weight is stored int8, ``base_q8`` ``[out, in]`` (JAX's
``[in, out...]`` with its input axes folded, transposed to torch's
layout), with an f32 ``base_scale`` ``[out]`` a channel (absmax,
:func:`.llama_io.quantize_base_int8`); the forward dequantises it as JAX
does, ``q.to(dtype) * scale.to(dtype)`` in the compute dtype, then the
product. The embedding, the head, the norms and the adapters keep their
dtypes. It needs ``lora_rank`` above 0 and no MoE, as in JAX; a random
init draws each projection as the dense one and rounds it at JAX's shared
step ``q0 = 4/√in/127``, clipped to ±127.

``cfg.fused_head_loss`` (JAX's): the model returns ``{"hidden",
"lm_head"}`` (the final norm's output and the head's weight, plus
``moe_aux``/``moe_dropped_frac`` in training) instead of logits, for
:func:`..train.losses.causal_lm_fused`, which never makes the ``[B, S,
V]`` logits; ``Trainer.predict``/``evaluate`` make them where JAX's step
does (:func:`..train.fused_ce.materialize_logits`). The ``Trainer``
refuses it where the head's weight is sharded (over ``fsdp`` or
``tensor``: ROADMAP Queue 1 item 5).

Not ported yet, and refused by name: decoding with a KV cache (item 8),
and MoE under context parallelism (its routing groups span whole
sequences, item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddeeplearningspark_tpu_torch.metrics import replicated_matmul
from distributeddeeplearningspark_tpu_torch.models.moe import MoEMLP, load_balance
from distributeddeeplearningspark_tpu_torch.ops import ring_attention
from distributeddeeplearningspark_tpu_torch.ops.attention import (
    dot_product_attention,
    padding_mask,
)
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_SEQ
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.parallel.sharding import (
    P,
    ShardingRules,
    TensorSplit,
    assign,
    is_sharded,
    local,
    local_value,
    tensor_split,
)
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
    #: the MoE FFN in every layer (0: the dense SwiGLU MLP)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    #: the routing group's tokens (0: one group a sequence)
    moe_group_size: int = 0
    #: return {"hidden", "lm_head"} for losses.causal_lm_fused (no logits)
    fused_head_loss: bool = False
    #: "int8": the projections' frozen base stored int8 with f32 scales
    base_quant: str | None = None
    # the JAX config's option the port refuses (LlamaForCausalLM)
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


#: the attention implementations that take a sequence sharded over ``seq``
CONTEXT_PARALLEL_IMPLS = ("ring", "ulysses")


def seq_degree(impl: str) -> int:
    """How many blocks each row's sequence is split into: the session
    mesh's ``seq`` size under a context-parallel ``impl``, else 1."""
    if impl not in CONTEXT_PARALLEL_IMPLS:
        return 1
    return ring_attention.resolve_mesh().shape[AXIS_SEQ]


def positions(s_local: int, device, impl: str) -> torch.Tensor:
    """The RoPE positions ``[1, S_local]`` of this rank's tokens: under a
    context-parallel ``impl``, those of its block of the sequence (``seq``
    index · ``S_local`` on), else ``0..S_local-1``."""
    start = 0
    if impl in CONTEXT_PARALLEL_IMPLS:
        start = ring_attention.resolve_mesh().seq_index * s_local
    return torch.arange(start, start + s_local, device=device)[None, :]


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
    never by the module. ``base_quant="int8"``: the base is ``base_q8``
    (int8 ``[out, in]``, no gradient) and ``base_scale`` (f32 ``[out]``)
    in the place of ``weight``."""

    def __init__(self, d_in: int, d_out: int, *, rank: int, alpha: float,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 base_quant: str | None = None, device=None):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.quantized = base_quant == "int8"
        if self.quantized:
            self.base_q8 = nn.Parameter(torch.empty(d_out, d_in, dtype=torch.int8,
                                                    device=device), requires_grad=False)
            self.base_scale = nn.Parameter(torch.empty(d_out, dtype=torch.float32,
                                                       device=device))
        else:
            self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=param_dtype,
                                                   device=device))
        if rank:
            self.lora_a = nn.Parameter(torch.empty(d_in, rank, dtype=torch.float32,
                                                   device=device))
            self.lora_b = nn.Parameter(torch.zeros(rank, d_out, dtype=torch.float32,
                                                   device=device))

    @property
    def base(self) -> nn.Parameter:
        """The stored base weight ``[out, in]``: ``weight``, or ``base_q8``."""
        return self.base_q8 if self.quantized else self.weight

    def base_weight(self) -> torch.Tensor:
        """This rank's base weight in ``dtype``; the int8 base dequantised as
        JAX's ``kernel_q.astype(dtype) * scale.astype(dtype)``."""
        dt = self.dtype
        if self.quantized:
            scale = local_value(self.base_scale).to(dt)
            return local_value(self.base_q8).to(dt) * scale[:, None]
        return local_value(self.weight).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a ``tensor`` split, ``x`` is this rank's input (the whole
        one for a column split, its columns for a row split) and the output
        this rank's columns (a part of the sum for a row split)."""
        dt = self.dtype
        x = x.to(dt)
        y = F.linear(x, self.base_weight())
        if self.rank:
            split = tensor_split(self.base)
            a, b = adapter_shards(self.lora_a, self.lora_b, split)
            a, b = a.to(dt), b.to(dt)
            if split is None:
                delta = (x @ a) @ b
            elif split.dim == 0:  # x·A is every peer's alike
                delta = replicated_matmul(x, a, counted=split.index == 0) @ b
            else:  # (x·A)·B: each peer's partial x·A through the whole B
                delta = replicated_matmul(x @ a, b, counted=split.index == 0)
            y = y + (delta * (self.alpha / self.rank)).to(y.dtype)
        return y


def adapter_shards(a: torch.Tensor, b: torch.Tensor, split: TensorSplit | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The LoRA factors a projection split by ``split`` uses: A and B whole
    through ``all_reduce_backward`` (each peer's gradients are its part of
    the whole), then B's columns of this rank's output shard (a column
    split) or A's rows of its input shard (a row split)."""
    if split is None:
        return a, b
    a = collectives.all_reduce_backward(a, split.group)
    b = collectives.all_reduce_backward(b, split.group)
    if split.dim == 0:
        return a, b.chunk(split.size, 1)[split.index]
    return a.chunk(split.size, 0)[split.index], b


def _block_split(column: Sequence[nn.Module], row: nn.Module) -> TensorSplit | None:
    """The ``tensor`` split of a block whose ``column`` projections feed
    ``row``: None where none is split; Megatron's pairing (the column
    projections' outputs and the row one's input split alike) or
    ``NotImplementedError``."""
    splits = [tensor_split(m.base) for m in column] + [tensor_split(row.base)]
    if all(sp is None for sp in splits):
        return None
    if (any(sp is None for sp in splits) or any(sp.dim != 0 for sp in splits[:-1])
            or splits[-1].dim != 1):
        raise NotImplementedError(
            f"tensor split {[None if sp is None else sp.dim for sp in splits]} of "
            f"a block: the model runs the column projections split on dim 0 "
            f"and the row one on dim 1 (llama_rules' layout), or none split")
    return splits[0]


def _proj(cfg: LlamaConfig, name: str, d_in: int, d_out: int, device
          ) -> LoRALinear:
    """The projection ``name``, with adapters when it is a LoRA target."""
    rank = cfg.lora_rank if name in cfg.lora_targets else 0
    return LoRALinear(d_in, d_out, rank=rank, alpha=cfg.lora_alpha, dtype=cfg.dtype,
                      param_dtype=cfg.param_dtype, base_quant=cfg.base_quant,
                      device=device)


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
        heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
        split = _block_split((self.wq, self.wk, self.wv), self.wo)
        if split is not None:
            if heads % split.size or kv_heads % split.size:
                raise ValueError(
                    f"tensor={split.size} must divide num_heads={heads} and "
                    f"num_kv_heads={kv_heads} (wq {tuple(self.wq.base.shape)}, "
                    f"wk {tuple(self.wk.base.shape)}): each rank takes whole heads")
            heads, kv_heads = heads // split.size, kv_heads // split.size
            x = collectives.all_reduce_backward(x, split.group)
        q = self.wq(x).view(b, s, heads, hd)
        k = self.wk(x).view(b, s, kv_heads, hd)
        v = self.wv(x).view(b, s, kv_heads, hd)
        pos = positions(s, x.device, cfg.attention_impl)
        q = rotary_embedding(q, pos, cfg.rope_theta)
        k = rotary_embedding(k, pos, cfg.rope_theta)
        y = dot_product_attention(q, k, v, mask=mask, causal=True,
                                  segment_ids=segment_ids,
                                  impl=cfg.attention_impl)
        out = self.wo(y.reshape(b, s, heads * hd))
        return out if split is None else collectives.all_reduce_forward(out, split.group)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate = _proj(cfg, "gate", h, i, device)
        self.up = _proj(cfg, "up", h, i, device)
        self.down = _proj(cfg, "down", i, h, device)

    def forward(self, x):
        split = _block_split((self.gate, self.up), self.down)
        if split is not None:
            x = collectives.all_reduce_backward(x, split.group)
        out = self.down(F.silu(self.gate(x)) * self.up(x))
        return out if split is None else collectives.all_reduce_forward(out, split.group)


class DecoderLayer(nn.Module):
    """Pre-norm block: ``x + attention(norm(x))``, then ``x + mlp(norm(x))``;
    with ``cfg.moe_experts`` the MLP is the MoE FFN (``moe``) and the block
    returns ``(x, sums)``, its routing's batch sums."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        self.attention = LlamaAttention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        if cfg.moe_experts:
            self.moe = MoEMLP(cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts,
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              group_size=cfg.moe_group_size, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, device=device)
        else:
            self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, mask, segment_ids=None):
        x = x + self.attention(self.attention_norm(x), mask, segment_ids)
        if hasattr(self, "moe"):
            y, sums = self.moe.forward_sums(self.mlp_norm(x))
            return x + y, sums
        return x + self.mlp(self.mlp_norm(x))


class ElsewhereLayer(nn.Module):
    """The place of a decoder layer that another pipeline stage holds
    (:mod:`.llama_pp`): no params, never run. ``init_weights`` draws a
    layer's worth of values in its place and discards them, so the layers
    this stage holds get one device's draws."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args):
        raise RuntimeError(f"layer {self.index} lies on pipeline stage {self.stage}")


#: the flax config's options the port refuses → their ROADMAP item
_NOT_PORTED = {
    "decode": "KV-cached decoding (models/llama_gen.py): ROADMAP Queue 1 item 8",
}


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM; logits [B,S,vocab] f32 (untied head, as in Llama-2)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        if cfg.base_quant is not None:
            if cfg.base_quant != "int8":
                raise ValueError(f"unknown base_quant {cfg.base_quant!r}; "
                                 "supported: 'int8'")
            if not cfg.lora_rank:
                raise ValueError("base_quant='int8' requires lora_rank > 0 "
                                 "(frozen-base LoRA; train with "
                                 "trainable=lora_trainable)")
        if cfg.base_quant and cfg.moe_experts:
            # the flax model's refusal, worded for what the bank is: it
            # trains in a full fine-tune, and under lora_trainable it is
            # frozen like the rest of the base (in bf16 at 7B)
            raise NotImplementedError(
                "base_quant with moe_experts: the int8 base quantizes the dense "
                "projections only; the expert bank has no int8 form (drop one "
                "of the two)")
        if cfg.moe_experts and cfg.attention_impl in CONTEXT_PARALLEL_IMPLS:
            raise NotImplementedError(
                f"moe_experts under attention_impl={cfg.attention_impl!r}: the "
                f"routing groups span whole sequences, and a context-parallel "
                f"rank holds a block of each: ROADMAP Queue 1 item 6")
        for field, why in _NOT_PORTED.items():
            if getattr(cfg, field):
                raise NotImplementedError(f"LlamaConfig.{field} is not ported "
                                          f"yet ({why})")
        self.cfg = cfg
        h = cfg.hidden_size
        self.token_embed = nn.Embedding(cfg.vocab_size, h, dtype=cfg.param_dtype,
                                        device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(h, cfg.rms_eps, cfg.dtype, device)
        self.lm_head = nn.Linear(h, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)
        #: sums a tensor over the ranks that hold distinct rows of the global
        #: batch (differentiably); None: this process holds all of it. The
        #: train step sets it (``collectives.all_reduce_sum`` over its loss
        #: group), so the MoE load balance takes the global batch's means.
        self.batch_sum = None
        #: the pipelined forward (:func:`.llama_pp.make_pp_model`); None:
        #: this process runs every layer
        self.pipe = None

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None):
        """``generator`` is taken for the Trainer's call and unused: Llama-2
        has no dropout. The logits, or with MoE in training or with
        ``fused_head_loss`` the dict the module docstring names."""
        del generator
        if self.pipe is not None:
            return self.pipe.forward(self, batch)
        cfg = self.cfg
        ids = batch["input_ids"]
        # under context parallelism ids hold one block of each row
        seq_len = ids.shape[1] * seq_degree(cfg.attention_impl)
        if seq_len > cfg.max_position:
            raise ValueError(f"sequence length {seq_len} exceeds "
                             f"max_position {cfg.max_position}")
        x = self._embed(ids)
        pad = batch.get("attention_mask")
        # causal is handled inside attention; a mask only for padding
        mask = padding_mask(pad) if pad is not None else None
        segment_ids = batch.get("segment_ids")
        remat = cfg.remat and torch.is_grad_enabled()
        sums = []
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask, segment_ids, use_reentrant=False)
            else:
                x = layer(x, mask, segment_ids)
            if cfg.moe_experts:
                x, layer_sums = x
                sums.append(layer_sums)
        x = self.final_norm(x)
        if cfg.fused_head_loss and not cfg.decode:
            # for losses.causal_lm_fused: the [B, S, V] logits never exist
            out = {"hidden": x, "lm_head": self._head_weight()}
            if cfg.moe_experts and self.training:
                out.update(self._moe_terms(sums))
            return out
        logits = self._head(x)
        if not (cfg.moe_experts and self.training):
            # eval and predict take plain logits, as the flax model gives them
            return logits
        return {"logits": logits, **self._moe_terms(sums)}

    def _moe_terms(self, sums: list) -> dict[str, torch.Tensor]:
        """The weighed load-balance loss and the dropped share from the
        layers' routing sums (over the global batch: :attr:`batch_sum`)."""
        cfg = self.cfg
        sums = torch.stack(sums)
        if self.batch_sum is not None:
            sums = self.batch_sum(sums)
        aux, dropped = load_balance(sums, cfg.moe_experts, cfg.moe_top_k)
        return {"moe_aux": cfg.moe_aux_weight * aux.sum(),
                "moe_dropped_frac": dropped.mean()}

    def _head_weight(self) -> torch.Tensor:
        """The head's whole weight ``[V, H]`` for the fused loss; a split
        head (the ``Trainer`` refuses it) raises."""
        w = self.lm_head.weight
        if is_sharded(w):
            raise NotImplementedError(
                "fused_head_loss with a sharded lm_head: ROADMAP Queue 1 item 5")
        return w

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The tokens' rows; under a ``tensor`` split of the vocab each rank
        looks up the ids of its rows (zeros elsewhere) and the group sums."""
        dt = self.cfg.dtype
        w = self.token_embed.weight
        split = tensor_split(w)
        if split is None:
            return F.embedding(ids, local_value(w).to(dt))
        if split.dim != 0:
            raise NotImplementedError(f"token_embed split on dim {split.dim}: the "
                                      f"model splits the vocab (dim 0) only")
        rows = w.to_local()
        rel = ids - split.index * rows.shape[0]
        inside = (rel >= 0) & (rel < rows.shape[0])
        x = F.embedding(torch.where(inside, rel, 0), rows.to(dt)) * inside[..., None].to(dt)
        return collectives.all_reduce_forward(x, split.group)

    def _head(self, x: torch.Tensor, counted: bool | None = None) -> torch.Tensor:
        """f32 logits; under a ``tensor`` split of the vocab, this rank's
        columns as a ``DTensor`` ``Shard(2)`` of the whole ``[B, S, V]``.
        ``counted`` (a pipeline, whose every pipe peer repeats the head on
        the same rows): the product through
        :func:`~..metrics.replicated_matmul`, counted only where True."""
        dt = self.cfg.dtype
        w = self.lm_head.weight

        def product(x, w):
            if counted is None:
                return F.linear(x.to(dt), w.to(dt)).float()
            return replicated_matmul(x.to(dt), w.to(dt).t(), counted=counted).float()

        split = tensor_split(w)
        if split is None:
            return product(x, local_value(w))
        if split.dim != 0:
            raise NotImplementedError(f"lm_head split on dim {split.dim}: the "
                                      f"model splits the vocab (dim 0) only")
        from torch.distributed.tensor import DTensor, Shard

        x = collectives.all_reduce_backward(x, split.group)
        logits = product(x, w.to_local())
        b, s, v = logits.shape[0], logits.shape[1], w.shape[0]
        return DTensor.from_local(logits, split.mesh, [Shard(2)], run_check=False,
                                  shape=(b, s, v), stride=(s * v, v, 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaForCausalLM":
        """Random weights from ``generator``, at the flax initialisers'
        scales: the embedding normal(0, 1/√H), the projections and the head
        normal(0, 1/√fan_in) (lecun's scale, not truncated), LoRA A
        he-uniform (±√(6/fan_in)), B zero, unit norm scales. Drawn on the
        params' device, in their dtype, each param whole and in this order;
        a sharded param keeps its shard of the draw (``sharding.assign``),
        so a sharded model's weights are bitwise one device's from the same
        generator, at the cost of one whole param at a time. In the place of
        a layer another pipeline stage holds (:class:`ElsewhereLayer`) a
        scratch layer takes that layer's draws, which are discarded."""

        def draw(p: torch.Tensor, fill) -> None:
            if not is_sharded(p):
                fill(p)
                return
            whole = torch.empty(p.shape, dtype=p.dtype, device=local(p).device)
            fill(whole)
            assign(p, whole)

        std = self.cfg.hidden_size ** -0.5
        draw(self.token_embed.weight,
             lambda t: t.normal_(0.0, std, generator=generator))
        scratch = None
        for mod in self.modules():
            if isinstance(mod, ElsewhereLayer):
                if scratch is None:
                    scratch = DecoderLayer(self.cfg, device=local(
                        self.token_embed.weight).device)
                for sub in scratch.modules():
                    self._draw_module(sub, draw, generator)
                continue
            self._draw_module(mod, draw, generator)
        return self

    def _draw_module(self, mod: nn.Module, draw, generator: torch.Generator) -> None:
        """``init_weights``' draws of one module's own params."""
        if isinstance(mod, LoRALinear) and mod.quantized:
            # the dense draw, rounded at JAX's shared step q0 = 4/√in/127
            fan_in = mod.base_q8.shape[1]
            q0 = 4.0 / math.sqrt(fan_in) / 127.0

            def quantized(t: torch.Tensor) -> None:
                w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                t.copy_(torch.clamp(torch.round(w / q0), -127, 127))

            draw(mod.base_q8, quantized)
            draw(mod.base_scale, lambda t: t.fill_(q0))
        elif isinstance(mod, (LoRALinear, nn.Linear)):
            std = mod.weight.shape[1] ** -0.5
            draw(mod.weight, lambda t: t.normal_(0.0, std, generator=generator))
        if isinstance(mod, LoRALinear) and mod.rank:
            limit = math.sqrt(6.0 / mod.lora_a.shape[0])
            draw(mod.lora_a, lambda t: t.uniform_(-limit, limit, generator=generator))
            draw(mod.lora_b, lambda t: t.zero_())
        if isinstance(mod, RMSNorm):
            draw(mod.scale, lambda t: t.fill_(1.0))
        if isinstance(mod, MoEMLP):
            mod.init_weights(draw, generator)


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
    a collective. The MoE expert bank (``[E, H, I]`` and ``[E, I, H]``, the
    flax layout) shards its experts over ``expert`` and its FFN dim over
    ``tensor``; the router stays replicated. The auto-FSDP pass then shards
    the largest remaining dim of every param of at least ``fsdp_min_size``
    elements over ``fsdp`` (for a tensor- or expert-split weight, another
    dim). ``pipeline=True``: every param of layer i, LoRA and norms
    included, lies on the cards of pipeline stage ``i // (L/P)`` only
    (``ShardingRules.stage_of``; JAX's ``P("pipe", ...)`` on the stacked
    layers), with its ``tensor`` and ``fsdp`` entries as above over that
    stage's cards; the embedding, the head and the final norm are
    replicated over ``pipe``. The int8 base's ``base_q8`` takes its dense
    sibling's layout and ``base_scale`` its output dim's (whole for
    ``wo``/``down``, whose outputs the block sums), JAX's int8 entries."""
    rules = (
        (r"lora_", P()),
        (r"(wq|wk|wv)/weight", P("tensor", None)),
        (r"wo/weight", P(None, "tensor")),
        (r"(gate|up)/weight", P("tensor", None)),
        (r"down/weight", P(None, "tensor")),
        *(((r"(wq|wk|wv)/base_q8", P("tensor", None)),
           (r"(wq|wk|wv)/base_scale", P("tensor")),
           (r"wo/base_q8", P(None, "tensor")),
           (r"(gate|up)/base_q8", P("tensor", None)),
           (r"(gate|up)/base_scale", P("tensor")),
           (r"(wo|down)/base_scale", P(None)),
           (r"down/base_q8", P(None, "tensor"))) if cfg.base_quant else ()),
        (r"token_embed/weight", P("tensor", None)),
        (r"lm_head/weight", P("tensor", None)),
        *(((r"moe/(w_gate|w_up)", P("expert", None, "tensor")),
           (r"moe/w_down", P("expert", "tensor", None)),
           (r"moe/router", P())) if cfg.moe_experts else ()),
    )
    return ShardingRules(rules=rules, fsdp=fsdp, fsdp_min_size=fsdp_min_size,
                         fsdp_exclude=(r"lora_",),
                         stage_pattern=LAYER_PATTERN if pipeline else None,
                         num_layers=cfg.num_layers if pipeline else 0)


#: a decoder layer's params' path, the layer index its group
LAYER_PATTERN = r"(?:^|/)layers/(\d+)/"

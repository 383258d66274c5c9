"""BERT for MLM — the port of ``distributeddeeplearningspark_tpu/models/bert.py``.

Same numerics as the flax model, which the CPU tests hold it to:

- params are kept in f32 and activations run in ``cfg.dtype`` (bf16 for
  BERT-base): each projection casts its input, weight and bias to
  ``cfg.dtype``, as flax's ``dtype=`` does;
- LayerNorm computes in f32 with eps 1e-6 (flax's default, not torch's
  1e-5) and casts back to ``cfg.dtype``;
- GELU is the tanh approximation (flax ``nn.gelu``'s default);
- the MLM decoder is tied to the token-embedding table (``x @ Eᵀ``), its
  bias is f32 and the logits are f32;
- attention goes through :func:`..ops.attention.dot_product_attention` in
  BSHD layout, so ``attention_impl="auto"`` takes the flash kernels on CUDA
  at BERT's s=512 with its key-padding mask (K1 forward, K2/K3 backward);
- dropout sits where flax puts it (after the attention output projection,
  after the MLP, after the embedding LayerNorm) and, in train mode, draws
  its mask from the ``torch.Generator`` passed to ``forward`` (the
  Trainer's), never from the global generator, so one seed gives one run.

Batch dict: ``input_ids`` [B,S] int, ``attention_mask`` [B,S] 1/0, optional
``token_type_ids`` [B,S], ``segment_ids`` [B,S] (packed documents) and
``mlm_positions`` [B,P] (gathered head); returns MLM logits [B,S,vocab] (or
[B,P,vocab]) in f32. ``forward(batch, generator=g)``: ``g`` draws the dropout
masks in train mode; eval mode (``bert_base`` returns the model in it)
needs none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearningspark_tpu_torch.ops.attention import (
    dot_product_attention,
    padding_mask,
)
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6


class BertConfig:
    """BERT-base defaults (Devlin et al.); override via kwargs."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.attention_impl = attention_impl

    @staticmethod
    def large(**kw) -> "BertConfig":
        """BERT-large geometry: 24 layers, 1024 hidden, 16 heads."""
        base = dict(hidden_size=1024, num_layers=24, num_heads=16,
                    intermediate_size=4096)
        base.update(kw)
        return BertConfig(**base)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """4-layer/128-wide config for CPU tests."""
        base = dict(vocab_size=1024, hidden_size=128, num_layers=4,
                    num_heads=4, intermediate_size=512, max_position=128,
                    dtype=torch.float32)
        base.update(kw)
        return BertConfig(**base)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``):
    input, weight and bias are cast before the product."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__(d_in, d_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``; the mask is
    drawn from ``generator``."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout draws its mask from a "
                         "torch.Generator: pass forward(..., generator=g)")
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)`` then ``.astype(dtype)``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, cfg.dtype, device)
        self.key = Dense(h, h, cfg.dtype, device)
        self.value = Dense(h, h, cfg.dtype, device)
        self.out = Dense(h, h, cfg.dtype, device)

    def forward(self, x, mask, segment_ids=None, generator=None):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        q = self.query(x).view(heads)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        y = dot_product_attention(q, k, v, mask=mask, segment_ids=segment_ids,
                                  impl=cfg.attention_impl)
        return dropout(self.out(y.reshape(b, s, cfg.hidden_size)),
                       cfg.dropout_rate, generator, self.training)


class EncoderLayer(nn.Module):
    """Post-LN (original BERT): sublayer → residual → LayerNorm(f32)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg, device)
        self.attention_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS,
                                         device=device)
        self.mlp_in = Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype,
                            device)
        self.mlp_out = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype,
                             device)
        self.mlp_ln = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS, device=device)

    def forward(self, x, mask, segment_ids=None, generator=None):
        dt = self.cfg.dtype
        y = self.attention(x, mask, segment_ids, generator)
        x = _layer_norm(self.attention_ln, x + y, dt)
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        y = dropout(y, self.cfg.dropout_rate, generator, self.training)
        return _layer_norm(self.mlp_ln, x + y, dt)


class BertEncoder(nn.Module):
    """Embeddings + N encoder layers; returns hidden states [B,S,H]. Owns
    the token-embedding table that :class:`BertForMLM` ties its decoder to."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.token_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position, h,
                                                device=device)
        self.type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                            device=device)
        self.embeddings_ln = nn.LayerNorm(h, eps=LN_EPS, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        ids = batch["input_ids"]
        if ids.shape[1] > cfg.max_position:
            raise ValueError(
                f"sequence length {ids.shape[1]} exceeds max_position "
                f"{cfg.max_position}")
        positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
        types = batch.get("token_type_ids")
        if types is None:
            types = torch.zeros_like(ids)
        x = F.embedding(ids, self.token_embeddings.weight.to(dt))
        x = x + F.embedding(positions, self.position_embeddings.weight.to(dt))
        x = x + F.embedding(types, self.type_embeddings.weight.to(dt))
        x = dropout(_layer_norm(self.embeddings_ln, x, dt), cfg.dropout_rate,
                    generator, self.training)
        am = batch.get("attention_mask")
        mask = padding_mask(torch.ones_like(ids) if am is None else am)
        segment_ids = batch.get("segment_ids")
        for layer in self.layers:
            x = layer(x, mask, segment_ids, generator)
        return x


class BertForMLM(nn.Module):
    """Encoder + MLM head with the decoder tied to the token embeddings.

    With ``mlm_positions`` [B, P] in the batch, hidden states are gathered
    at those positions before the head, so the vocab projection runs on P
    positions per row (logits [B, P, vocab]); otherwise on every position."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.encoder = BertEncoder(cfg, device)
        self.mlm_dense = Dense(h, h, cfg.dtype, device)
        self.mlm_ln = nn.LayerNorm(h, eps=LN_EPS, device=device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 device=device))

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.encoder(batch, generator)
        if "mlm_positions" in batch:
            pos = batch["mlm_positions"].long()
            x = torch.take_along_dim(x, pos[:, :, None], dim=1)
        x = F.gelu(self.mlm_dense(x), approximate="tanh")
        x = _layer_norm(self.mlm_ln, x, dt)
        logits = (x @ self.encoder.token_embeddings.weight.to(dt).T).float()
        return logits + self.mlm_bias

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertForMLM":
        """BERT's initialisation from ``generator``: normal(0, 0.02) for
        projection and embedding weights, zero biases, unit LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.mlm_bias.zero_()
        return self


def bert_base(*, device="cuda", seed: int = 0, **kw) -> BertForMLM:
    """BERT-base MLM on ``device`` (the card unless ``device="cpu"``), in
    eval mode, with weights made from ``seed``."""
    dev = resolve_device(device)
    model = BertForMLM(BertConfig(**kw), device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()

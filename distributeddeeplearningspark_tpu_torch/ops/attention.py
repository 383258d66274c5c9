"""Attention ops: one call site, pluggable implementations.

The port of ``distributeddeeplearningspark_tpu/ops/attention.py``. Models
call :func:`dot_product_attention`; ``impl`` picks the implementation:

- ``"xla"`` — plain PyTorch softmax attention (the name is the JAX
  package's, kept so that configs carry over unchanged).
- ``"flash"`` — the flash attention of :mod:`.flash_attention`, through
  its autograd Function: the hand-written CUDA kernels for CUDA tensors
  (K1 forward, K2/K3 backward), their plain versions for CPU tensors.
  Key-padding masks and grouped (GQA) K/V are taken natively.
- ``"auto"`` — flash when the tensors are on CUDA and the shape qualifies
  (no bias, key-only mask, seq a multiple of 512, head dim a multiple of
  8, whole GQA groups), else xla — the JAX rule with "on TPU" read as
  "on CUDA".

All take and return ``[batch, seq, heads, head_dim]`` (BSHD) and are
differentiable. Ring and Ulysses context parallelism are not ported yet.
"""

from __future__ import annotations

import os

import torch

from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa

#: Below this sequence length "auto" prefers the plain path (the JAX
#: package's threshold; ``DLS_FLASH_MIN_SEQ`` overrides it, e.g. 100000 to
#: force the plain path for A/B timing).
FLASH_MIN_SEQ = 512


def dot_product_attention(q, k, v, *, bias=None, mask=None,
                          causal: bool = False, scale: float | None = None,
                          segment_ids=None, impl: str = "auto"):
    """Softmax attention over BSHD tensors.

    ``mask``: bool, True = attend, broadcastable to [B, H, Sq, Sk].
    ``bias``: additive, broadcastable to [B, H, Sq, Sk].
    ``segment_ids``: [B, S] packed-sequence ids; attention is blocked
    across different ids."""
    if impl == "auto":
        impl = _pick_impl(q, k, bias, mask)
    if impl == "flash":
        return fa.flash_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                                  scale=scale, segment_ids=segment_ids)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(f"impl={impl!r} is not ported yet")
    k, v = _expand_gqa(q, k, v)
    if segment_ids is not None:
        seg_mask = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg_mask if mask is None else torch.logical_and(mask, seg_mask)
    return _xla_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                          scale=scale)


def _expand_gqa(q, k, v):
    """Broadcast grouped KV heads up to the query head count (xla path)."""
    h, hkv = q.shape[2], k.shape[2]
    if h == hkv:
        return k, v
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    return (k.repeat_interleave(h // hkv, dim=2),
            v.repeat_interleave(h // hkv, dim=2))


def _key_only_mask(mask, sq: int) -> bool:
    """True if ``mask`` is expressible as a key-padding mask [B, Sk]:
    [Sk] and [B, Sk] outright, higher ranks ([B, 1, 1, Sk]) when every
    middle (head/query) dim is 1."""
    del sq
    shape = tuple(mask.shape)
    if len(shape) > 4:
        return False
    if len(shape) <= 2:
        return True
    return all(s == 1 for s in shape[1:-1])


def _flash_min_seq() -> int:
    try:
        return int(os.environ.get("DLS_FLASH_MIN_SEQ", FLASH_MIN_SEQ))
    except ValueError:
        return FLASH_MIN_SEQ


def _pick_impl(q, k, bias, mask) -> str:
    # the flash kernel needs CUDA, a block-divisible seq, a head dim that is
    # a multiple of 8, a key-only mask (if any), whole GQA groups, and a
    # sequence long enough (FLASH_MIN_SEQ)
    if q.device.type != "cuda":
        return "xla"
    b, s, h, d = q.shape
    if bias is not None:
        return "xla"
    if mask is not None and not _key_only_mask(mask, s):
        return "xla"
    if s < _flash_min_seq():
        return "xla"
    if s % 512 or d % 8 or h % k.shape[2]:
        return "xla"
    return "flash"


def _xla_attention(q, k, v, *, bias, mask, causal, scale):
    depth = q.shape[-1]
    scale = scale if scale is not None else depth ** -0.5
    # logits and softmax in f32 whatever the input dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~cmask, fa.MASK_VALUE)
    if mask is not None:
        logits = torch.where(mask, logits, fa.MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 pad mask → [B, 1, 1, S] bool attend-mask (BERT style)."""
    return (attention_mask > 0)[:, None, None, :]

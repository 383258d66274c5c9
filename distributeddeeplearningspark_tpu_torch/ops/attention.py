"""Attention ops: one call site, pluggable implementations.

The port of ``distributeddeeplearningspark_tpu/ops/attention.py``. Models
call :func:`dot_product_attention`; ``impl`` picks the implementation:

- ``"xla"`` — plain PyTorch softmax attention (the name is the JAX
  package's, kept so that configs carry over unchanged).
- ``"flash"`` — the flash attention of :mod:`.flash_attention`, through
  its autograd Function: the hand-written CUDA kernels for CUDA tensors
  (K1 forward, K2/K3 backward), their plain versions for CPU tensors.
  Key-padding masks and grouped (GQA) K/V are taken natively.
- ``"ring"`` — context-parallel exact attention over the mesh ``seq``
  axis (:mod:`.ring_attention`): K/V blocks rotate around the ``seq``
  group, the flash kernels on each hop;
- ``"ulysses"`` — context-parallel exact attention by all-to-all head
  scatter (:mod:`.ulysses`): the kernels over the whole sequence on a
  slice of the heads, which must divide by the ``seq`` degree;
- ``"auto"`` — flash when the tensors are on CUDA and the shape qualifies
  (no bias, key-only mask, seq a multiple of 512, head dim a multiple of
  8, whole GQA groups), else xla — the JAX rule with "on TPU" read as
  "on CUDA". One deliberate difference: the CUDA kernels take bf16 and
  head dims in ``KERNEL_HEAD_DIMS`` only (the Pallas kernel takes q's
  dtype and any such head dim), so "auto" picks xla for other inputs
  instead of sending the kernel a call it refuses.

All take and return ``[batch, seq, heads, head_dim]`` (BSHD) and are
differentiable; under ``ring`` and ``ulysses`` ``seq`` is this rank's
block of the sequence.
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
    if impl == "ring":
        from distributeddeeplearningspark_tpu_torch.ops.ring_attention import (
            ring_attention)

        # GQA-native: grouped K/V ride the ring at Hkv heads; the segment
        # ids' kv side rides it like the mask
        return ring_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                              scale=scale, segment_ids=segment_ids)
    if impl == "ulysses":
        from distributeddeeplearningspark_tpu_torch.ops.ulysses import (
            ulysses_attention)

        return ulysses_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                                 scale=scale, segment_ids=segment_ids)
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
    # sequence long enough (FLASH_MIN_SEQ); and, unlike the Pallas kernel,
    # bf16 and a head dim it is built for
    if q.device.type != "cuda":
        return "xla"
    b, s, h, d = q.shape
    if q.dtype != torch.bfloat16 or d not in fa.KERNEL_HEAD_DIMS:
        return "xla"
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

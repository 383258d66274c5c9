"""Ulysses attention — all-to-all context parallelism over the ``seq`` axis.

The port of ``distributeddeeplearningspark_tpu/ops/ulysses.py``
(DeepSpeed-Ulysses). Where :mod:`.ring_attention` keeps the queries home
and rotates K/V blocks, Ulysses swaps the split: one all-to-all over the
``seq`` group turns this rank's block ``[B, S/N, H, D]`` of every head
into the whole sequence of its slice of the heads ``[B, S, H/N, D]``,
attention runs over the full sequence on those ``H/N`` heads, and a
second all-to-all turns the output back (:class:`_AllToAll`, whose
backward is the reverse all-to-all). The key mask and the segment ids are
all-gathered, since the local attention needs them whole.

The exchange is the port's one all-to-all,
:func:`..parallel.collectives.all_to_all`. Rank j takes the contiguous
heads ``[j·H/N, (j+1)·H/N)`` of q and ``[j·Hkv/N, (j+1)·Hkv/N)`` of k and
v, so each GQA group stays with its kv head. JAX's checks are kept: the local (after ``tensor``) q heads and
kv heads must each divide by the ``seq`` degree; the sequence must divide
by it too, which the feed that slices it checks
(:func:`..data.feed.seq_shard`).

The local attention takes the flash kernels (K1 forward, K2/K3 backward,
through :func:`.attention.dot_product_attention`) where
:func:`.ring_attention.flash_hop_qualifies` holds for the whole sequence,
else the kernel's plain version (``flash_attention_reference``, through
autograd): JAX's einsum fallback, whose fully masked rows also give 0.
``use_flash=True`` where the kernels do not qualify raises, as in JAX.

The all-to-alls count the bytes this rank sends in
``all_to_all.bytes_sent``.
"""

from __future__ import annotations

import torch

from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.ops import ring_attention as ra
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_SEQ


def all_to_all(x: torch.Tensor, sg: ra.SeqGroup, to_heads: bool) -> torch.Tensor:
    """``to_heads``: ``[B, S/N, H, D]`` → ``[B, S, H/N, D]`` (scatter the
    heads, gather the sequence); else the reverse. The exchange is
    :func:`..parallel.collectives.all_to_all` over the ``seq`` group."""
    split, concat = (2, 1) if to_heads else (1, 2)
    out = collectives.all_to_all(x, None, split_dim=split, concat_dim=concat,
                                 group=sg.group)
    all_to_all.bytes_sent += x.numel() * x.element_size() * (sg.size - 1) // sg.size
    return out


all_to_all.bytes_sent = 0


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, whose gradient is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, sg, to_heads):
        ctx.sg, ctx.to_heads = sg, to_heads
        return all_to_all(x, sg, to_heads)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.sg, not ctx.to_heads), None, None


def _gather_seq(t: torch.Tensor, sg: ra.SeqGroup) -> torch.Tensor:
    """A ``[B, S/N]`` block from every ``seq`` peer, whole ``[B, S]``."""
    return collectives.all_gather_rows(t.t().contiguous(), sg.group).t()


def _local_attention(q, k, v, kv_mask, segs, *, causal, scale, use_flash):
    """Full-sequence attention on the local head slice."""
    if use_flash:
        from distributeddeeplearningspark_tpu_torch.ops.attention import (
            dot_product_attention)

        return dot_product_attention(q, k, v, mask=kv_mask, causal=causal,
                                     scale=scale, segment_ids=segs, impl="flash")
    return fa.flash_attention_reference(q, k, v, kv_mask=kv_mask, q_segs=segs,
                                        kv_segs=segs, scale=scale, causal=causal)[0]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh=None, causal: bool = True, scale: float | None = None,
                      mask=None, bias=None, segment_ids=None,
                      use_flash: bool | None = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on the mesh's ``seq`` axis,
    by all-to-all, differentiable. Arguments as
    :func:`.ring_attention.ring_attention`'s (this rank's block of the
    sequence, local heads, a key-only mask and segment ids of the block),
    except that ``use_flash`` gates on the whole sequence, which the local
    attention sees, and that the local q and kv heads must each divide by
    the ``seq`` degree."""
    if bias is not None:
        raise NotImplementedError(
            "ulysses attention does not take additive bias; use impl='xla'")
    mesh = ra.resolve_mesh(mesh)
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    b, s, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if (bk, sk, dk) != (b, s, d):
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    n = mesh.shape[AXIS_SEQ]
    if h % n or hkv % n:
        raise ValueError(
            f"ulysses scatters heads over 'seq': the local q/kv heads ({h}/{hkv}) "
            f"must divide by the seq degree ({n}) — lower mesh.seq or use "
            f"impl='ring' (no head constraint)")
    qualifies = ra.flash_hop_qualifies(q, s * n)
    if use_flash and not qualifies:
        raise ValueError(
            f"use_flash=True but the full-sequence local shapes do not satisfy "
            f"the kernels' rules (s={s * n}, d={d}, {q.dtype} on {q.device}); "
            f"pass use_flash=None/False")
    use_flash = qualifies if use_flash is None else use_flash
    kv_mask = fa.as_kv_mask(mask, b, s, q.device) if mask is not None else None
    segs = None
    if segment_ids is not None:
        segs = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segs.shape) != (b, s):
            raise ValueError(f"segment_ids must be [batch, seq] = {(b, s)}, "
                             f"got {tuple(segs.shape)}")
        segs = segs.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    if n == 1:
        return _local_attention(q, k, v, kv_mask, segs, causal=causal,
                                scale=scale, use_flash=use_flash)
    sg = ra.seq_group(mesh)
    qq, kk, vv = (_AllToAll.apply(x, sg, True) for x in (q, k, v))
    kv_mask = _gather_seq(kv_mask, sg) if kv_mask is not None else None
    segs = _gather_seq(segs, sg) if segs is not None else None
    out = _local_attention(qq, kk, vv, kv_mask, segs, causal=causal, scale=scale,
                           use_flash=use_flash)
    return _AllToAll.apply(out, sg, False)

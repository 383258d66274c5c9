"""Flash attention forward (FlashAttention-2): the port of kernel K1.

Replaces the Pallas kernel ``_fwd_kernel`` / ``_flash_fwd`` of
``distributeddeeplearningspark_tpu/ops/flash_attention.py`` with a CUDA
kernel written for Hopper, ``csrc/flash_fwd.cu`` (its header states the
design and the bound). Here:

- :func:`flash_fwd` — the kernel's wrapper: ``(o, lse)`` for BSHD inputs.
  A CUDA tensor launches the kernel (bf16, head dim 64 or 128) or raises;
  a CPU tensor takes :func:`flash_attention_reference`, the kernel's plain
  PyTorch version. ``flash_fwd.launches`` counts the kernel's launches.
- :func:`flash_attention` — the public op, with the argument checks of the
  JAX package's ``flash_attention`` (:func:`flash_operands`).
- :func:`as_kv_mask` — a broadcastable attend-mask reduced to key-only
  ``[B, Sk]`` int32 form.

Semantics held from the TPU kernel: masked logits take the finite value
``-1e30`` and p is exactly 0 under the mask; a fully masked row emits
``O = 0`` and ``LSE = -1e30`` (the XLA path instead averages v over such a
row); P is rounded to v's dtype before PV; causal attention skips key tiles
above the diagonal; the key mask and segment ids are indexed by batch; GQA
q head ``h`` reads kv head ``h // (H // Hkv)`` without repeating K/V. The
Mosaic layout rules (``STAT_LANES``, the lane-major mask, the (8, 128)
block checks) are TPU artifacts and are not carried over: LSE is a plain
``[B·H, S]`` f32 array and any sequence length is taken.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: finite "minus infinity" for masked logits (see the module docstring)
MASK_VALUE = -1e30
#: head dims the CUDA kernel is instantiated for (BERT 64, Llama 128)
KERNEL_HEAD_DIMS = (64, 128)


def as_kv_mask(mask, batch: int, sk: int, device=None) -> torch.Tensor:
    """Reduce a broadcastable attend-mask to key-only ``[B, Sk]`` int32.

    Accepts ``[Sk]``, ``[B, Sk]`` and the BERT-style ``[B, 1, 1, Sk]`` /
    ``[B, 1, Sk]`` (any unit middle dims). A mask that varies along the
    query or head axis cannot be streamed key-tile by key-tile and raises
    (use ``impl='xla'``)."""
    m = torch.as_tensor(mask, device=device)
    shape = tuple(m.shape)
    if m.ndim == 1:
        m = m[None, :]
    while m.ndim > 2:
        if m.shape[1] != 1:
            raise NotImplementedError(
                f"flash kernel supports key-only (padding) masks; got a mask "
                f"of shape {shape} that varies over queries/heads — use "
                f"impl='xla'")
        m = m[:, 0]
    if m.shape[-1] != sk:
        raise ValueError(f"mask key dim {m.shape[-1]} != seq {sk}")
    if m.shape[0] == 1 and batch > 1:
        m = m.expand(batch, sk)
    return m.to(torch.int32).contiguous()


def flash_attention_reference(q, k, v, *, kv_mask=None, q_segs=None,
                              kv_segs=None, scale: float, causal: bool = False):
    """The kernel's plain PyTorch version: ``(o [B,S,H,D], lse [B·H,S] f32)``.

    Same arithmetic as the kernel, in one pass over the whole score matrix:
    f32 logits of the scaled q against k, masked to ``MASK_VALUE``, p
    exactly 0 under the mask, p rounded to v's dtype before PV, a fully
    masked row giving ``O = 0`` and ``LSE = MASK_VALUE``."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3) * scale                     # [B,H,S,D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    logits = qf @ kf.transpose(-1, -2)                              # [B,H,S,S]
    allowed = None
    if causal:
        allowed = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if kv_mask is not None:
        key_ok = (kv_mask != 0)[:, None, None, :]
        allowed = key_ok if allowed is None else allowed & key_ok
    if q_segs is not None:
        same = (q_segs[:, None, :, None] == kv_segs[:, None, None, :])
        allowed = same if allowed is None else allowed & same
    if allowed is not None:
        logits = logits.masked_fill(~allowed, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = p.to(v.dtype).float() @ vf.float()
    o = (pv / l_safe[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m[..., 0] + torch.log(l_safe)).reshape(b * h, s)
    return o, lse


@functools.cache
def _kernel():
    from distributeddeeplearningspark_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").dls_flash_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(q, k, v, masks) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel takes contiguous [B,S,H,D] {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim in {KERNEL_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    for t in masks:
        if t is not None and (t.dtype != torch.int32 or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError("masks and segment ids must be contiguous int32 "
                             "on q's device")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kv_mask: torch.Tensor | None = None,
              q_segs: torch.Tensor | None = None,
              kv_segs: torch.Tensor | None = None,
              scale: float, causal: bool = False):
    """Flash attention forward over BSHD tensors: ``(o, lse)``.

    q ``[B, S, H, D]``; k, v ``[B, S, Hkv, D]`` with ``H % Hkv == 0``;
    ``kv_mask`` ``[B, S]`` int32 (nonzero = attend); ``q_segs``/``kv_segs``
    ``[B, S]`` int32, both or neither. Returns o ``[B, S, H, D]`` in q's
    dtype and lse ``[B·H, S]`` f32 (ring attention merges hops on it)."""
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if (q_segs is None) != (kv_segs is None):
        raise ValueError("q_segs and kv_segs must be passed together")
    for t in (kv_mask, q_segs, kv_segs):
        if t is not None and tuple(t.shape) != (b, s):
            raise ValueError(f"masks and segment ids must be [B, S] = "
                             f"{(b, s)}, got {tuple(t.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask=kv_mask,
                                         q_segs=q_segs, kv_segs=kv_segs,
                                         scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k, v, (kv_mask, q_segs, kv_segs))
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        ptr(kv_mask), ptr(q_segs), ptr(kv_segs),
                        o.data_ptr(), lse.data_ptr(),
                        b, s, h, k.shape[2], d, float(scale), int(causal),
                        stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_operands(q, k, v, *, bias=None, mask=None, causal: bool = False,
                   scale: float | None = None, segment_ids=None) -> dict:
    """Check the public arguments (as the JAX package's ``flash_attention``
    does) and turn them into :func:`flash_fwd`'s keyword arguments."""
    if bias is not None:
        raise NotImplementedError(
            "flash kernel does not take additive bias; use impl='xla'")
    b, sq, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes must match: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    bk, sk, hkv, dk = k.shape
    if (bk, dk) != (b, d) or sk != sq:
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    kv_mask = as_kv_mask(mask, b, sk, q.device) if mask is not None else None
    segs = None
    if segment_ids is not None:
        segs = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segs.shape) != (b, sq):
            raise ValueError(f"segment_ids must be [batch, seq] = {(b, sq)}, "
                             f"got {tuple(segs.shape)}")
        segs = segs.to(torch.int32).contiguous()
    return dict(kv_mask=kv_mask, q_segs=segs, kv_segs=segs, causal=causal,
                scale=scale if scale is not None else d ** -0.5)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias=None, mask=None, causal: bool = False,
                    scale: float | None = None,
                    segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """BSHD flash attention (forward). ``mask`` may be a key-only padding
    mask (see :func:`as_kv_mask`); ``k``/``v`` may carry fewer (grouped)
    heads than ``q``; ``segment_ids`` ``[B, S]`` block attention across
    packed documents and compose with ``mask`` and ``causal``."""
    kw = flash_operands(q, k, v, bias=bias, mask=mask, causal=causal,
                        scale=scale, segment_ids=segment_ids)
    return flash_fwd(q, k, v, **kw)[0]

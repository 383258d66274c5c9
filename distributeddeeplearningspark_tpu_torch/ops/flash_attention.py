"""Flash attention (FlashAttention-2): the port of kernels K1, K2 and K3.

Replaces the Pallas kernels of
``distributeddeeplearningspark_tpu/ops/flash_attention.py`` with CUDA
kernels written for Hopper: the forward ``_fwd_kernel`` (K1) with
``csrc/flash_fwd.cu``, the backward ``_bwd_dq_kernel`` (K2) and
``_bwd_dkv_kernel`` (K3) with ``csrc/flash_bwd.cu`` (each header states the
design and the bound). Here:

- :func:`flash_fwd` — K1's wrapper: ``(o, lse)`` for BSHD inputs.
- :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` — K2's and K3's wrappers;
  :func:`flash_bwd` — the backward's entry, ``(dq, dk, dv)`` from the
  forward's ``o`` and ``lse``, as the JAX package's ``_flash_bwd(res, g)``.
- Each wrapper launches its kernel for a CUDA tensor (bf16, head dim 64 or
  128) or raises, and takes the kernel's plain PyTorch version
  (:func:`flash_attention_reference`,
  :func:`flash_attention_backward_reference`) for a CPU tensor. Each keeps
  its launch count in a plain integer, ``<wrapper>.launches``, and where it
  launches notes its FLOP formula for a measured count
  (:func:`~..metrics.note_kernel_flops`: K1 the forward's two products, K2
  dP and dQ, K3 dK and dV, as the gradients ``needs`` asks for).
- :func:`flash_attention` — the public op, with the argument checks of the
  JAX package's ``flash_attention`` (:func:`flash_operands`), made
  differentiable by :class:`_FlashAttention` (K1 forward, K2/K3 backward).
- :func:`as_kv_mask` — a broadcastable attend-mask reduced to key-only
  ``[B, Sk]`` int32 form.

Semantics held from the TPU kernel: masked logits take the finite value
``-1e30`` and p is exactly 0 under the mask; a fully masked row emits
``O = 0`` and ``LSE = -1e30`` (the XLA path instead averages v over such a
row); P is rounded to v's dtype before PV; the forward kernel skips key
tiles that the causal rule, the key mask or the segment ids rule out for a
whole q tile; the key mask and segment ids are indexed by batch; GQA
q head ``h`` reads kv head ``h // (H // Hkv)`` without repeating K/V. The
Mosaic layout rules (``STAT_LANES``, the lane-major mask, the (8, 128)
block checks) are TPU artifacts and are not carried over: LSE is a plain
``[B·H, S]`` f32 array and any sequence length is taken. The backward
recomputes P from LSE and zeroes it with the mask, never through the
exponent (a fully masked row's ``exp(s - LSE)`` would be 1), so such a row
gets ``dq = 0``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributeddeeplearningspark_tpu_torch import metrics

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
    allowed = _allowed(b, s, q.device, kv_mask=kv_mask, q_segs=q_segs,
                       kv_segs=kv_segs, causal=causal)
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


def _allowed(b, s, device, *, kv_mask, q_segs, kv_segs, causal):
    """The (q row, key) pairs that may attend, ``[B, 1, S, S]`` bool, or
    None when every pair may."""
    allowed = None
    if causal:
        allowed = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    if kv_mask is not None:
        key_ok = (kv_mask != 0)[:, None, None, :]
        allowed = key_ok if allowed is None else allowed & key_ok
    if q_segs is not None:
        same = q_segs[:, None, :, None] == kv_segs[:, None, None, :]
        allowed = same if allowed is None else allowed & same
    return allowed


def _backward_plain(q, k, v, lse, delta, do, *, kv_mask, q_segs, kv_segs,
                    scale: float, causal: bool):
    """K2's and K3's arithmetic in f32 over the whole score matrix, from
    ``lse`` and ``delta`` ``[B·H, S]``: ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    bhsd = lambda t: t.float().permute(0, 2, 1, 3)  # noqa: E731
    qs = bhsd(q) * scale                                            # [B,H,S,D]
    kf = bhsd(k).repeat_interleave(group, dim=1)
    vf = bhsd(v).repeat_interleave(group, dim=1)
    dof = bhsd(do)
    p = torch.exp(qs @ kf.transpose(-1, -2) - lse.view(b, h, s, 1))
    allowed = _allowed(b, s, q.device, kv_mask=kv_mask, q_segs=q_segs,
                       kv_segs=kv_segs, causal=causal)
    if allowed is not None:  # the mask, not the exponent, zeroes P
        p = p.masked_fill(~allowed, 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta.view(b, h, s, 1))
    dq = scale * (ds @ kf)
    # per q head, then summed over each kv head's group of q heads
    dk = (ds.transpose(-1, -2) @ qs).view(b, hkv, group, s, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, hkv, group, s, d).sum(2)
    back = lambda t, like: t.permute(0, 2, 1, 3).to(like.dtype).contiguous()  # noqa: E731
    return back(dq, q), back(dk, k), back(dv, v)


def _delta(o, do) -> torch.Tensor:
    """rowsum(dO∘O) in f32, ``[B·H, S]``. A plain torch op: the JAX package
    computes it in XLA (``_flash_bwd``), outside any Pallas kernel."""
    b, s, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)


def flash_attention_backward_reference(q, k, v, o, lse, do, *, kv_mask=None,
                                       q_segs=None, kv_segs=None,
                                       scale: float, causal: bool = False):
    """The backward kernels' plain PyTorch version: ``(dq, dk, dv)``.

    Follows the JAX package's ``_flash_bwd`` / ``_bwd_dq_kernel`` /
    ``_bwd_dkv_kernel`` in f32: ``delta = rowsum(dO∘O)``; P recomputed as
    ``exp(scale·q·kᵀ − LSE)`` and set to exactly 0 under the mask;
    ``dS = P∘(dP − delta)``; ``dQ = scale·dS·K``; ``dK = dSᵀ·(scale·Q)``;
    ``dV = Pᵀ·dO``; a kv head's gradient summed over its group of q heads.
    Gradients come back in the inputs' dtypes."""
    return _backward_plain(q, k, v, lse, _delta(o, do), do, kv_mask=kv_mask,
                           q_segs=q_segs, kv_segs=kv_segs, scale=scale,
                           causal=causal)


@functools.cache
def _kernel(library: str, symbol: str, n_pointers: int):
    """The C entry point ``symbol`` of ``csrc/<library>.cu``: ``n_pointers``
    pointers, then B, S, H, Hkv, D, the scale, the causal flag and the
    stream."""
    from distributeddeeplearningspark_tpu_torch.ops import _build

    fn = getattr(_build.load(library), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, fn, tensors, b, s, h, hkv, d, scale, causal) -> None:
    """Call a kernel's C entry point on q's device and current stream; raise
    on a nonzero CUDA error."""
    dev = tensors[0].device
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, b, s, h, hkv, d, float(scale), int(causal), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_cuda_operands(q, k, v, masks, **more) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    _launch("flash_fwd", _kernel("flash_fwd", "dls_flash_fwd_bf16", 8),
            (q, k, v, kv_mask, q_segs, kv_segs, o, lse),
            b, s, h, k.shape[2], d, scale, causal)
    flash_fwd.launches += 1
    metrics.note_kernel_flops(metrics.flash_fwd_flops(b, s, s, h, d))
    return o, lse


flash_fwd.launches = 0


def _check_bwd_cuda_operands(q, k, v, do, lse, delta, masks) -> None:
    _check_cuda_operands(q, k, v, masks, do=do)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q {tuple(q.shape)}")
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, s)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B·H, S] = "
                             f"{(b * h, s)} on q's device")


def _bwd_products(needs: tuple[bool, bool, bool], *names: str) -> int:
    """How many of ``names`` (dP, dQ, dK, dV) autograd's backward of the
    plain attention computes when ``needs`` says which of q, k, v want a
    gradient: dP for q or k, dQ for q, dK for k, dV for v."""
    nq, nk, nv = needs
    want = {"dP": nq or nk, "dQ": nq, "dK": nk, "dV": nv}
    return sum(bool(want[n]) for n in names)


def flash_bwd_dq(q, k, v, do, lse, delta, *, kv_mask=None, q_segs=None,
                 kv_segs=None, scale: float, causal: bool = False,
                 needs: tuple[bool, bool, bool] = (True, True, True)):
    """K2: dq ``[B, S, H, D]`` from the forward's ``lse`` and
    ``delta = rowsum(dO∘O)`` (both ``[B·H, S]`` f32). ``needs``: which of
    q, k, v want a gradient; the FLOPs noted are the products of dP and dQ
    the plain path's autograd would compute for those
    (:func:`~..metrics.flash_bwd_flops`)."""
    kw = dict(kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs, scale=scale,
              causal=causal)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, lse, delta, do, **kw)[0]
    _check_bwd_cuda_operands(q, k, v, do, lse, delta,
                             (kv_mask, q_segs, kv_segs))
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernel("flash_bwd", "dls_flash_bwd_dq_bf16", 10),
            (q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs, dq),
            b, s, h, k.shape[2], d, scale, causal)
    flash_bwd_dq.launches += 1
    metrics.note_kernel_flops(metrics.flash_bwd_flops(b, s, s, h, d) // 4
                              * _bwd_products(needs, "dP", "dQ"))
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, kv_mask=None, q_segs=None,
                  kv_segs=None, scale: float, causal: bool = False,
                  needs: tuple[bool, bool, bool] = (True, True, True)):
    """K3: ``(dk, dv)`` ``[B, S, Hkv, D]``, each kv head's gradient summed
    over its group of q heads, from ``lse`` and ``delta`` as K2's. It
    computes both; the FLOPs noted are those of dK and dV that ``needs``
    asks for."""
    kw = dict(kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs, scale=scale,
              causal=causal)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, lse, delta, do, **kw)[1:]
    _check_bwd_cuda_operands(q, k, v, do, lse, delta,
                             (kv_mask, q_segs, kv_segs))
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", _kernel("flash_bwd", "dls_flash_bwd_dkv_bf16", 11),
            (q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs, dk, dv),
            b, s, h, k.shape[2], d, scale, causal)
    flash_bwd_dkv.launches += 1
    metrics.note_kernel_flops(metrics.flash_bwd_flops(b, s, s, h, d) // 4
                              * _bwd_products(needs, "dK", "dV"))
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, *, kv_mask=None, q_segs=None,
              kv_segs=None, scale: float, causal: bool = False,
              needs: tuple[bool, bool, bool] = (True, True, True)):
    """The flash backward: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse``, as the JAX package's ``_flash_bwd(res, g)``. On CUDA tensors
    it computes ``delta`` and launches K2 then K3 on the current stream
    (``needs``: which gradients the caller wants, for their FLOP count);
    on CPU tensors it takes :func:`flash_attention_backward_reference`."""
    kw = dict(kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs, scale=scale,
              causal=causal)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")
    delta = _delta(o, do).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, needs=needs, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, needs=needs, **kw))


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward. The forward saves q, k, v, o, LSE and
    the masks, which get no gradient. Under ``no_grad``/``inference_mode``
    autograd records nothing, so nothing is saved and only K1 runs."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_segs, kv_segs, scale, causal):
        o, lse = flash_fwd(q, k, v, kv_mask=kv_mask, q_segs=q_segs,
                           kv_segs=kv_segs, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, q_segs, kv_segs)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask, q_segs, kv_segs = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs,
                               scale=ctx.scale, causal=ctx.causal,
                               needs=tuple(ctx.needs_input_grad[:3]))
        return dq, dk, dv, None, None, None, None, None


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
    """BSHD flash attention, differentiable. ``mask`` may be a key-only
    padding mask (see :func:`as_kv_mask`); ``k``/``v`` may carry fewer
    (grouped) heads than ``q``; ``segment_ids`` ``[B, S]`` block attention
    across packed documents and compose with ``mask`` and ``causal``."""
    kw = flash_operands(q, k, v, bias=bias, mask=mask, causal=causal,
                        scale=scale, segment_ids=segment_ids)
    return _FlashAttention.apply(q, k, v, kw["kv_mask"], kw["q_segs"],
                                 kw["kv_segs"], kw["scale"], kw["causal"])

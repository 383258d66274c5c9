"""Fused 1×1-conv + BatchNorm statistics: the port of kernel K4.

Replaces the Pallas kernel ``_mm_stats_kernel`` of
``distributeddeeplearningspark_tpu/ops/conv_bn.py`` with
``csrc/conv_bn.cu``, a CUDA kernel written for Hopper (its header states
the design and the bound). A stride-1 1×1 convolution is a matmul over the
``[B·H·W, Cin]`` rows of a channels-last activation; the kernel computes
``Y = X @ W`` and, in the same pass, each column's ``sum(Y)`` and
``sum(Y²)`` from the f32 accumulator, so BatchNorm's statistics need no
second read of Y. Here:

- :func:`matmul_stats` — K4's wrapper: ``(y, s1, s2)``. It launches the
  kernel for CUDA tensors (bf16, contiguous, every shape :func:`can_fuse`
  admits) or raises, and takes :func:`matmul_stats_reference` for CPU
  tensors. Its launch count is ``matmul_stats.launches``.
- :func:`fused_matmul_stats` — the differentiable op, the counterpart of
  the JAX package's ``jax.custom_vjp`` ``matmul_stats``: K4 forward, and the
  JAX backward (``:177-189``) as torch matmuls in f32, the stats cotangents
  folded into ``dY + ds1 + 2·Y·ds2``.
- :func:`can_fuse` and :func:`_resolve_blocks` — the JAX package's gate,
  copied as it is (block 512), so that both packages fuse the same layers.
- :class:`Conv1x1BN` — the JAX module as an ``nn.Module``: the kernel path
  in train mode where ``fused`` and the gate allow, else the unfused chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

#: BatchNorm's running-statistics momentum and epsilon (the JAX module's)
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _resolve_blocks(m, k, n, block_m, block_n, block_k):
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(
            f"matmul_stats needs M/N/K divisible by blocks: "
            f"{(m, n, k)} vs {(bm, bn, bk)}")
    return bm, bn, bk


def can_fuse(m: int, k: int, n: int,
             block_m: int = 512, block_n: int = 512, block_k: int = 512) -> bool:
    """True when :func:`matmul_stats` accepts this shape: M a multiple of 8
    and M, K, N divisible by ``min(512, dim)``. The shape gate
    :class:`Conv1x1BN` uses, as in the JAX package (on the card it also
    needs bf16, see ``Conv1x1BN._fuses``)."""
    if m % 8:
        return False
    try:
        _resolve_blocks(m, k, n, block_m, block_n, block_k)
    except ValueError:
        return False
    return True


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if m % 8:
        raise ValueError(f"matmul_stats needs M divisible by 8, got {m}")
    _resolve_blocks(m, k, n, 512, 512, 512)
    return m, k, n


def matmul_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """The kernel's plain PyTorch version: ``y32 = x @ w`` in f32, ``y`` in
    x's dtype, and the column sums of ``y32`` and ``y32²`` (f32)."""
    y32 = x.float() @ w.float()
    return y32.to(x.dtype), y32.sum(0), (y32 * y32).sum(0)


@functools.cache
def _kernel():
    """K4's C entry point and the row tile its scratch is sized by."""
    from distributeddeeplearningspark_tpu_torch.ops import _build

    lib = _build.load("conv_bn")
    fn = lib.dls_matmul_stats_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dls_matmul_stats_block_m.argtypes = []
    lib.dls_matmul_stats_block_m.restype = ctypes.c_int
    return fn, lib.dls_matmul_stats_block_m()


def matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """``y = x @ w`` with each column's ``(sum(y), sum(y²))`` in f32.

    x ``[M, K]``, w ``[K, N]``; y ``[M, N]`` in x's dtype. Any shape
    :func:`can_fuse` admits; others raise ``ValueError``. On CUDA tensors it
    launches K4 (bf16 only) on the current stream; on CPU tensors it takes
    :func:`matmul_stats_reference`. Not differentiable: see
    :func:`fused_matmul_stats`."""
    m, k, n = _check_shapes(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_stats_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_stats runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"matmul_stats kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_stats kernel takes a contiguous {name}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    fn, block_m = _kernel()
    tiles = -(-m // block_m)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    ps1 = torch.empty(tiles, n, dtype=torch.float32, device=x.device)
    ps2 = torch.empty_like(ps1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), ps1.data_ptr(),
                 ps2.data_ptr(), m, k, n, tiles, stream)
    if err:
        raise RuntimeError(f"matmul_stats kernel launch failed: CUDA error {err}")
    matmul_stats.launches += 1
    # one reduce over the row tiles' partials, as the JAX package's XLA sum
    return y, ps1.sum(0), ps2.sum(0)


matmul_stats.launches = 0


class _MatmulStats(torch.autograd.Function):
    """K4 forward; the JAX custom VJP's backward in f32 torch matmuls."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = matmul_stats(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, y = ctx.saved_tensors
        # d/dY of (Y, sum(Y), sum(Y²)), folded elementwise into one dY
        dy_eff = (torch.zeros_like(y, dtype=torch.float32) if dy is None
                  else dy.float())
        if ds1 is not None:
            dy_eff = dy_eff + ds1[None, :]
        if ds2 is not None:
            dy_eff = dy_eff + 2.0 * y.float() * ds2[None, :]
        dx = (dy_eff @ w.float().T).to(x.dtype)
        dw = (x.float().T @ dy_eff).to(w.dtype)
        return dx, dw


def fused_matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """:func:`matmul_stats`, differentiable in x and w (through y, s1, s2)."""
    return _MatmulStats.apply(x, w)


def channels_last_rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` in channels-last memory as its ``[B·H·W, C]`` rows:
    a view, never a copy (raises on any other layout)."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("Conv1x1BN takes a channels_last [B, C, H, W] "
                         "tensor; a reshape of this one would copy it")
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).view(b * h * w, c)


class Conv1x1BN(nn.Module):
    """Fused ``1×1 conv → BatchNorm`` (stride 1), the JAX ``Conv1x1BN``.

    Takes and returns ``[B, C, H, W]`` channels-last tensors. Params
    ``kernel`` ``[Cout, Cin, 1, 1]`` (f32, OIHW), ``scale`` and ``bias``
    (f32); buffers ``mean`` and ``var`` (the running statistics). In train
    mode, ``fused`` and :func:`can_fuse` (and, on the card, a bf16
    ``dtype``) send the conv through K4, whose
    epilogue gives the batch statistics; otherwise the unfused chain (the
    matmul, then the statistics of its ``dtype`` output). The running
    statistics move as ``0.9·old + 0.1·batch`` with the biased variance.
    Eval mode takes the chain and the running statistics. The
    normalisation is the JAX module's own: ``g = scale·rstd``,
    ``b = bias − mean·scale·rstd``, both cast to ``dtype``, then
    ``y·g + b``."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = True,
                 zero_gamma: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.kernel = nn.Parameter(torch.empty(features, in_features, 1, 1,
                                               device=device))
        fill = torch.zeros if zero_gamma else torch.ones
        self.scale = nn.Parameter(fill(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def _fuses(self, x: torch.Tensor, m: int, cin: int, cout: int) -> bool:
        """The JAX gate (``fused`` and :func:`can_fuse`), and off the CPU
        also bf16: K4 takes nothing else, so an f32 module on the card
        takes the unfused chain. On the CPU the plain version fuses any
        dtype, as the JAX module does."""
        if not (self.fused and can_fuse(m, cin, cout)):
            return False
        return x.device.type == "cpu" or self.dtype == torch.bfloat16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin, h, w_ = x.shape
        cout = self.kernel.shape[0]
        m = b * h * w_
        xf = channels_last_rows(x).to(self.dtype)
        w2d = self.kernel.to(self.dtype).view(cout, cin).t().contiguous()
        if self.training:
            if self._fuses(x, m, cin, cout):
                y, s1, s2 = fused_matmul_stats(xf, w2d)
                mean = s1 / m
                # E[y²] − E[y]² (the one-pass form), clipped at 0
                var = torch.clamp(s2 / m - mean * mean, min=0.0)
            else:
                y = xf @ w2d
                yf = y.float()
                mean = yf.mean(0)
                var = torch.clamp((yf * yf).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            y = xf @ w2d
            mean, var = self.mean, self.var
        rstd = torch.rsqrt(var + BN_EPS)
        g = (self.scale * rstd).to(self.dtype)
        b_ = (self.bias - mean * self.scale * rstd).to(self.dtype)
        out = y * g + b_
        return out.view(b, h, w_, cout).permute(0, 3, 1, 2)

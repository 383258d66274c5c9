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
  kernel for CUDA tensors (bf16, contiguous, 16-byte aligned, M, K and N
  multiples of 8) or raises, and takes :func:`matmul_stats_reference` for
  CPU tensors of every shape :func:`can_fuse` admits. Its launch count is
  ``matmul_stats.launches``; a launch notes its product's FLOPs, ``2·M·K·N``
  (:func:`~..metrics.note_kernel_flops`).
- :func:`fused_matmul_stats` — the differentiable op, the counterpart of
  the JAX package's ``jax.custom_vjp`` ``matmul_stats``: K4 forward, and the
  JAX backward (``:177-189``) as torch matmuls in f32, the stats cotangents
  folded into ``dY + ds1 + 2·Y·ds2``.
- :func:`can_fuse` and :func:`_resolve_blocks` — the JAX package's gate,
  copied as it is (block 512). :class:`Conv1x1BN` applies it to the global
  batch's rows (this rank's M times the rank count), as JAX's gate sees the
  global M under GSPMD, so that both packages fuse the same layers at any
  rank count. K4 takes partial row tiles, so on the card a rank's own M
  need only be a multiple of 8.
- :class:`Conv1x1BN` — the JAX module as an ``nn.Module``: the kernel path
  in train mode where ``fused`` and the gate allow, else the unfused chain.
  In a data-parallel gang its statistics are the global batch's: K4 still
  computes this rank's ``Y``, ``Σy`` and ``Σy²``, and the module sums the
  ranks' ``Σ``'s (and their gradients, backward) before the mean and the
  variance.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from distributeddeeplearningspark_tpu_torch import metrics
from distributeddeeplearningspark_tpu_torch.parallel import collectives

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
    :class:`Conv1x1BN` uses on the CPU, as in the JAX package (the card's
    is ``Conv1x1BN._fuses``)."""
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
    return m, k, n


def matmul_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """The kernel's plain PyTorch version: ``y32 = x @ w`` in f32, ``y`` in
    x's dtype, and the column sums of ``y32`` and ``y32²`` (f32)."""
    y32 = x.float() @ w.float()
    return y32.to(x.dtype), y32.sum(0), (y32 * y32).sum(0)


@functools.cache
def _kernel():
    """K4's C entry point and the count of partial-sum rows it writes."""
    from distributeddeeplearningspark_tpu_torch.ops import _build

    lib = _build.load("conv_bn")
    fn = lib.dls_matmul_stats_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    partials = lib.dls_matmul_stats_partials
    partials.argtypes = [ctypes.c_int, ctypes.c_int]
    partials.restype = ctypes.c_int
    return fn, partials


def _check_cuda_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel takes beyond :func:`can_fuse`: bf16, contiguous,
    16-byte aligned operands on one device, and K and N multiples of 8 (TMA
    wants every row stride a multiple of 16 bytes). Raises on anything else;
    ``Conv1x1BN._fuses`` declines such layers first."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"matmul_stats kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_stats kernel takes a contiguous {name}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"matmul_stats kernel takes a 16-byte aligned {name}")
    k, n = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"matmul_stats kernel takes K and N multiples of 8, "
                         f"got K={k}, N={n}")


def matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """``y = x @ w`` with each column's ``(sum(y), sum(y²))`` in f32.

    x ``[M, K]``, w ``[K, N]``; y ``[M, N]`` in x's dtype, M a multiple of
    8. On CUDA tensors it launches K4 on the current stream (bf16, K and N
    multiples of 8: :func:`_check_cuda_operands`); on CPU tensors it takes
    :func:`matmul_stats_reference` at any shape :func:`can_fuse` admits.
    Other shapes raise ``ValueError``. Not differentiable: see
    :func:`fused_matmul_stats`."""
    m, k, n = _check_shapes(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        _resolve_blocks(m, k, n, 512, 512, 512)
        return matmul_stats_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_stats runs on cuda or cpu, not {x.device}")
    _check_cuda_operands(x, w)
    fn, partials = _kernel()
    with torch.cuda.device(x.device):
        rows = partials(m, n)
        if rows <= 0:
            raise RuntimeError("matmul_stats: no partial-row count for this device")
        y = torch.empty(m, n, dtype=x.dtype, device=x.device)
        # the partial rows of sum(y) and of sum(y²), one tensor
        ps = torch.empty(2, rows, n, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), ps[0].data_ptr(),
                 ps[1].data_ptr(), m, k, n, rows, stream)
    if err:
        raise RuntimeError(f"matmul_stats kernel launch failed: CUDA error {err}")
    matmul_stats.launches += 1
    metrics.note_kernel_flops(metrics.matmul_flops(m, k, n))
    # one reduce over the blocks' partial rows, as the JAX package's XLA sum
    s1, s2 = ps.sum(1)
    return y, s1, s2


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


def _global_stats(s1: torch.Tensor, s2: torch.Tensor, m: int):
    """BatchNorm's ``(mean, var)`` from this rank's column sums of y and y²
    over its ``m`` rows: the sums and the row count go through one
    :func:`~..parallel.collectives.all_reduce_sum` (nothing outside a
    group), so in a gang they are the global batch's and the backward
    takes the global ``ds1`` and ``ds2``. ``E[y²] − E[y]²`` (the one-pass
    form), clipped at 0."""
    n = s1.numel()
    sums = collectives.all_reduce_sum(torch.cat([s1, s2, s1.new_full((1,), m)]))
    mean = sums[:n] / sums[2 * n]
    return mean, torch.clamp(sums[n:2 * n] / sums[2 * n] - mean * mean, min=0.0)


class Conv1x1BN(nn.Module):
    """Fused ``1×1 conv → BatchNorm`` (stride 1), the JAX ``Conv1x1BN``.

    Takes and returns ``[B, C, H, W]`` channels-last tensors. Params
    ``kernel`` ``[Cout, Cin, 1, 1]`` (f32, OIHW), ``scale`` and ``bias``
    (f32); buffers ``mean`` and ``var`` (the running statistics). In train
    mode, ``fused`` and :func:`can_fuse` over the global batch (on the
    card also a bf16 ``dtype``, and this rank's rows and both widths
    multiples of 8: ``_fuses``) send the conv through K4,
    whose epilogue gives the batch statistics; otherwise the unfused chain
    (the matmul, then the statistics of its ``dtype`` output). The running
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
        """The JAX gate (``fused`` and :func:`can_fuse`) over the global
        batch's ``m · world_size`` rows, and then what this rank's ``m``
        rows need: on the CPU the plain version takes the shapes JAX's
        ``matmul_stats`` takes on one array (:func:`can_fuse` again, any
        dtype); off the CPU K4 takes bf16 with ``m``, ``cin`` and ``cout``
        multiples of 8 (it computes partial row tiles), and a module with
        another dtype or width takes the unfused chain."""
        if not (self.fused and can_fuse(m * collectives.world_size(), cin, cout)):
            return False
        if x.device.type == "cpu":
            return can_fuse(m, cin, cout)
        return (self.dtype == torch.bfloat16
                and m % 8 == 0 and cin % 8 == 0 and cout % 8 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin, h, w_ = x.shape
        cout = self.kernel.shape[0]
        m = b * h * w_
        xf = channels_last_rows(x).to(self.dtype)
        w2d = self.kernel.to(self.dtype).view(cout, cin).t().contiguous()
        if self.training:
            if self._fuses(x, m, cin, cout):
                y, s1, s2 = fused_matmul_stats(xf, w2d)
            else:
                y = xf @ w2d
                yf = y.float()
                s1, s2 = yf.sum(0), (yf * yf).sum(0)
            mean, var = _global_stats(s1, s2, m)
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

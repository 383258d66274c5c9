"""ResNet for ImageNet — the port of ``distributeddeeplearningspark_tpu/models/resnet.py``.

Same model as the flax one, which the CPU tests hold it to:

- the public input is the JAX layout, ``batch["image"]`` ``[B, H, W, 3]``
  float; inside, activations are ``[B, C, H, W]`` tensors in
  ``torch.channels_last`` memory (the same bytes as NHWC), so the cuDNN
  convolutions take them as they are and :class:`~..ops.conv_bn.Conv1x1BN`
  sees each one as its ``[B·H·W, C]`` rows without a copy;
- params and BatchNorm statistics are f32; activations run in ``dtype``
  (bf16 by default): every conv casts its input and its f32 weight to
  ``dtype`` at each call, as flax's ``dtype=`` does; the head is f32;
- v1.5 stride placement (the stride on the 3×3), explicit ``(1, 1)``
  padding on the 3×3s, zero-initialised gamma on each block's last BN, a
  3×3/2 max pool padded with −inf, a global mean pool;
- :class:`BatchNorm` follows flax's ``nn.BatchNorm`` (not
  ``torch.nn.BatchNorm2d``): statistics in f32 with ``var = E[x²] − E[x]²``
  clipped at 0, the normalisation ``((x − mean)·(rsqrt(var + eps)·scale) +
  bias)`` computed in f32 and cast to ``dtype``, running statistics
  ``0.9·old + 0.1·batch`` with the biased variance;
- in a data-parallel gang the training statistics are the global batch's,
  as GSPMD makes them in JAX: each BatchNorm (and each
  :class:`~..ops.conv_bn.Conv1x1BN`) all-reduces its column sums forward
  and their gradients backward, so the running statistics move alike on
  every rank and stay replicas;
- ``fused_conv_bn=True`` routes each bottleneck's two stride-1 1×1
  conv→BN pairs through :class:`~..ops.conv_bn.Conv1x1BN`, which takes
  kernel K4 in train mode where the JAX gate admits the shape.

``forward(batch, generator=None)`` returns f32 logits ``[B, classes]``; the
generator (the Trainer's) is accepted and unused: the model draws nothing.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearningspark_tpu_torch.ops.conv_bn import (
    BN_EPS,
    BN_MOMENTUM,
    Conv1x1BN,
)
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device


class Conv2d(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=dtype)``: an f32 OIHW weight,
    input and weight cast to ``dtype`` at each call, channels-last out."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), w, stride=self.stride,
                        padding=self.padding)


def _bn_stats(xf: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """flax ``_compute_stats`` over (B, H, W) of the global batch: ``(mean,
    E[x²] − mean², clipped var, rows)``. Each rank's ``Σx``, ``Σx²`` and
    row count go through one :func:`~..parallel.collectives.all_reduce_sum`
    of a ``[2C+1]`` f32 buffer (nothing outside a group)."""
    dims = (0, 2, 3)
    c = xf.shape[1]
    sums = collectives.all_reduce_sum(torch.cat([
        xf.sum(dims), xf.square().sum(dims),
        xf.new_full((1,), xf.numel() // c)]))
    n = sums[2 * c]
    mean = sums[:c] / n
    raw = sums[c:2 * c] / n - mean * mean
    return mean, raw, torch.clamp(raw, min=0.0), n


def _bn_apply(x, mean, var, scale, bias, eps, dtype) -> torch.Tensor:
    """flax ``_normalize``: in f32, then cast to ``dtype``."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * scale
    return ((x.float() - mean.view(shape)) * mul.view(shape)
            + bias.view(shape)).to(dtype)


class _BatchNormTrain(torch.autograd.Function):
    """flax's train-mode BatchNorm on the global batch's statistics, with
    its gradient written out so that autograd keeps only the input (in its
    own dtype) and [C] vectors, not the f32 copies the forward makes.
    Returns the output and the batch ``(mean, var)``, which take no
    gradient.

    In a gang the statistics are the global batch's (:func:`_bn_stats`), and
    so are the backward's ``Σg`` and ``Σg·(x − mean)`` that reach them
    through the mean and the variance (one all-reduce of a ``[2C]``
    buffer), over the global row count. ``dscale`` and ``dbias`` stay this
    rank's, as every param gradient does until the train step's
    all-reduce."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        mean, raw, var, n = _bn_stats(x.float())
        out = _bn_apply(x, mean, var, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x, mean, raw, var, scale, n)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, mean, raw, var, scale, n = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        c = x.shape[1]
        rstd = torch.rsqrt(var + ctx.eps)
        a = rstd * scale
        g = dout.float()
        xc = x.float() - mean.view(shape)
        sum_g = g.sum((0, 2, 3))
        sum_gxc = (g * xc).sum((0, 2, 3))
        del xc
        dscale = sum_gxc * rstd
        dbias = sum_g
        sums = collectives.all_reduce_sum(torch.cat([sum_g, sum_gxc]))
        sum_g, sum_gxc = sums[:c], sums[c:]
        # through rstd = (var + eps)^-1/2; var = max(0, E[x²] − mean²),
        # whose gradient is 1 above 0, 0 below and ½ at the tie, as jnp's
        dvar = sum_gxc * scale * (-0.5) * rstd ** 3
        dvar = dvar * torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        dmean = -a * sum_g - 2.0 * mean * dvar
        dx = (g * a.view(shape) + (dmean / n).view(shape)
              + x.float() * (2.0 * dvar / n).view(shape))
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the channels of a ``[B, C, H, W]`` tensor: params ``scale``, ``bias``;
    buffers ``mean``, ``var``."""

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 zero_gamma: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        fill = torch.zeros if zero_gamma else torch.ones
        self.scale = nn.Parameter(fill(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _bn_apply(x, self.mean, self.var, self.scale, self.bias,
                             BN_EPS, self.dtype)
        out, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                               BN_EPS, self.dtype)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        return out


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck with a projection shortcut when the shape
    changes. ``fused_conv_bn=True``: both 1×1 conv→BN pairs are
    :class:`Conv1x1BN` (``conv_bn_1``, ``conv_bn_3``), the 3×3 ``conv_2``/
    ``bn_2``; otherwise ``conv_1``/``bn_1`` … ``conv_3``/``bn_3``."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1, *,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_conv_bn: bool = False, device=None):
        super().__init__()
        cout = 4 * filters
        self.fused_conv_bn = fused_conv_bn
        if fused_conv_bn:
            self.conv_bn_1 = Conv1x1BN(cin, filters, dtype=dtype, device=device)
        else:
            self.conv_1 = Conv2d(cin, filters, 1, dtype=dtype, device=device)
            self.bn_1 = BatchNorm(filters, dtype=dtype, device=device)
        self.conv_2 = Conv2d(filters, filters, 3, stride=strides, padding=1,
                             dtype=dtype, device=device)
        self.bn_2 = BatchNorm(filters, dtype=dtype, device=device)
        if fused_conv_bn:
            self.conv_bn_3 = Conv1x1BN(filters, cout, dtype=dtype,
                                       zero_gamma=True, device=device)
        else:
            self.conv_3 = Conv2d(filters, cout, 1, dtype=dtype, device=device)
            self.bn_3 = BatchNorm(cout, dtype=dtype, zero_gamma=True, device=device)
        self.shortcut_conv = self.shortcut_bn = None
        if cin != cout or strides != 1:
            self.shortcut_conv = Conv2d(cin, cout, 1, stride=strides,
                                        dtype=dtype, device=device)
            self.shortcut_bn = BatchNorm(cout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.fused_conv_bn:
            y = F.relu(self.conv_bn_1(x))
        else:
            y = F.relu(self.bn_1(self.conv_1(x)))
        y = F.relu(self.bn_2(self.conv_2(y)))
        if self.fused_conv_bn:
            y = self.conv_bn_3(y)
        else:
            y = self.bn_3(self.conv_3(y))
        if self.shortcut_conv is not None:
            residual = self.shortcut_bn(self.shortcut_conv(residual))
        return F.relu(residual + y.to(residual.dtype))


class BasicBlock(nn.Module):
    """3×3 → 3×3 block (ResNet-18/34): ``conv_1``/``bn_1``, ``conv_2``/``bn_2``."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv_1 = Conv2d(cin, filters, 3, stride=strides, padding=1,
                             dtype=dtype, device=device)
        self.bn_1 = BatchNorm(filters, dtype=dtype, device=device)
        self.conv_2 = Conv2d(filters, filters, 3, padding=1, dtype=dtype,
                             device=device)
        self.bn_2 = BatchNorm(filters, dtype=dtype, zero_gamma=True, device=device)
        self.shortcut_conv = self.shortcut_bn = None
        if cin != filters or strides != 1:
            self.shortcut_conv = Conv2d(cin, filters, 1, stride=strides,
                                        dtype=dtype, device=device)
            self.shortcut_bn = BatchNorm(filters, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn_1(self.conv_1(x)))
        y = self.bn_2(self.conv_2(y))
        if self.shortcut_conv is not None:
            residual = self.shortcut_bn(self.shortcut_conv(residual))
        return F.relu(residual + y.to(residual.dtype))


class ResNet(nn.Module):
    """Input: batch dict with ``image`` ``[B, H, W, 3]`` float; returns f32
    logits. ``stage_sizes`` counts blocks per stage; stage widths are
    ``width·2^stage`` (64/128/256/512 at ``width=64``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_conv_bn: bool = False, device=None):
        super().__init__()
        if fused_conv_bn and not issubclass(block_cls, BottleneckBlock):
            raise ValueError(
                "fused_conv_bn=True requires a BottleneckBlock block_cls "
                f"(got {block_cls!r}) — BasicBlock has no 1×1 convs to fuse")
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.dtype = dtype
        self.stem_conv = Conv2d(3, width, 7, stride=2, padding=3, dtype=dtype,
                                device=device)
        self.stem_bn = BatchNorm(width, dtype=dtype, device=device)
        kw = ({"fused_conv_bn": fused_conv_bn}
              if issubclass(block_cls, BottleneckBlock) else {})
        blocks, cin = [], width
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                filters = width * 2 ** stage
                blocks.append(block_cls(
                    cin, filters, 2 if stage > 0 and block == 0 else 1,
                    dtype=dtype, device=device, **kw))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = batch["image"].to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        # global mean pool (f32 sum, result in the activation dtype, as
        # jnp.mean of bf16), then the f32 head
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)

    def conv_bn_layers(self) -> list[Conv1x1BN]:
        return [m for m in self.modules() if isinstance(m, Conv1x1BN)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """flax's initialisers from ``generator``: lecun-normal (a normal of
        variance 1/fan_in truncated at ±2σ, σ rescaled for the truncation)
        for conv and head kernels, zero biases; BN scales 1 (0 for each
        block's last BN), biases 0, running mean 0 and var 1."""
        trunc_std = 0.87962566103423978  # std of a unit normal cut at ±2
        for p in self.parameters():
            if p.ndim < 2:
                continue
            std = (1.0 / math.prod(p.shape[1:])) ** 0.5 / trunc_std
            # a normal, redrawn where it falls outside ±2σ (~5% a round)
            p.normal_(0.0, std, generator=generator)
            out = p.abs() > 2 * std
            while bool(out.any()):
                p[out] = torch.empty(int(out.sum()), device=p.device).normal_(
                    0.0, std, generator=generator)
                out = p.abs() > 2 * std
        self.head.bias.zero_()
        return self


def ResNet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock, **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block_cls=BottleneckBlock, **kw)


def resnet50(num_classes: int = 1000, fused_conv_bn: bool = True, *,
             device="cuda", seed: int = 0, **kw) -> ResNet:
    """ResNet-50 (stages 3/4/6/3, width 64) on ``device`` (the card unless
    ``device="cpu"``), weights made from ``seed``, bf16 activations and f32
    params and BN state; ``fused_conv_bn`` routes the bottlenecks' 1×1
    conv→BN pairs through K4 in training. Returned in train mode."""
    dev = resolve_device(device)
    model = ResNet50(num_classes=num_classes, fused_conv_bn=fused_conv_bn,
                     device=dev, **kw)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))

"""LeNet-5 for MNIST — BASELINE.json config 1, the port of
``distributeddeeplearningspark_tpu/models/lenet.py``.

Same model as the flax one, which the CPU tests hold it to: a 5×5 conv to 6
channels (``SAME`` padding), ReLU, a 2×2 max pool, a 5×5 conv to 16
(``VALID``), ReLU, a 2×2 max pool, then dense 120/84/``num_classes`` with
ReLUs between. The public input is the JAX layout, ``batch["image"]``
``[B, 28, 28, 1]`` float; the convolutions run NCHW, and the pooled
``[B, 16, 5, 5]`` activations are permuted back to NHWC before the flatten
so that ``dense_0`` sees flax's feature order (the one translation hazard
of this model). Params are f32; the layers compute in ``dtype`` (input and
weight cast at each call, as flax's ``dtype=``), the head in f32.

``forward(batch, generator=None)`` returns f32 logits; the generator (the
Trainer's) is accepted and unused: the model draws nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at ±2


class LeNet5(nn.Module):
    """Input: batch dict with ``image`` ``[B, 28, 28, 1]`` float; returns
    logits ``[B, num_classes]``. On ``device`` (the card unless
    ``device="cpu"``), weights made from ``seed`` by flax's initialisers."""

    def __init__(self, num_classes: int = 10, *, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.conv_0 = nn.Conv2d(1, 6, 5, padding=2, device=dev)
        self.conv_1 = nn.Conv2d(6, 16, 5, padding=0, device=dev)
        self.dense_0 = nn.Linear(16 * 5 * 5, 120, device=dev)
        self.dense_1 = nn.Linear(120, 84, device=dev)
        self.dense_2 = nn.Linear(84, num_classes, device=dev)
        self.init_weights(torch.Generator(device=dev).manual_seed(seed))

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        padding=conv.padding)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = batch["image"].to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv_0, x)), 2, 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv_1, x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC order
        x = F.relu(self._dense(self.dense_0, x))
        x = F.relu(self._dense(self.dense_1, x))
        return F.linear(x.float(), self.dense_2.weight, self.dense_2.bias)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LeNet5":
        """flax's defaults from ``generator``: lecun-normal kernels (a
        normal of variance 1/fan_in truncated at ±2σ, σ rescaled for the
        truncation), zero biases."""
        for p in self.parameters():
            if p.ndim < 2:
                p.zero_()
                continue
            std = (1.0 / math.prod(p.shape[1:])) ** 0.5 / _TRUNC_STD
            p.normal_(0.0, std, generator=generator)
            out = p.abs() > 2 * std
            while bool(out.any()):
                p[out] = torch.empty(int(out.sum()), device=p.device).normal_(
                    0.0, std, generator=generator)
                out = p.abs() > 2 * std
        return self

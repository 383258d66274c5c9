"""Carry flax ResNet weights across to the port's :class:`~.resnet.ResNet`.

The flax trees (``variables["params"]`` and ``variables["batch_stats"]`` of
the JAX package's ``ResNet``, leaves as numpy arrays) differ from the torch
state dict in layout and names:

- conv kernels are HWIO; the port's are OIHW (``Conv1x1BN``'s ``kernel``
  too); the ``head`` Dense kernel is ``[in, out]``, ``nn.Linear``'s weight
  ``[out, in]``;
- flax numbers its blocks ``BottleneckBlock_i``/``BasicBlock_i`` across the
  stages; the port keeps them in ``blocks.i``;
- inside a block, flax names its unnamed layers by order: unfused
  bottleneck ``Conv_0..2``/``BatchNorm_0..2`` (port ``conv_1..3``/
  ``bn_1..3``), fused bottleneck ``conv_bn_1``, ``Conv_0``/``BatchNorm_0``
  (the 3×3: port ``conv_2``/``bn_2``), ``conv_bn_3``; basic block
  ``Conv_0..1``/``BatchNorm_0..1`` (port ``conv_1..2``/``bn_1..2``);
  ``shortcut_conv``/``shortcut_bn``, ``stem_conv``/``stem_bn`` keep their
  names.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel, prefix: str, out: dict, name: str = "weight") -> None:
    out[f"{prefix}.{name}"] = _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn(params, stats, prefix: str, out: dict) -> None:
    out[f"{prefix}.scale"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.mean"] = _t(stats["mean"])
    out[f"{prefix}.var"] = _t(stats["var"])


def _block_layers(p: Mapping[str, Any]) -> list[tuple[str, str, str]]:
    """(flax conv, flax BN, port suffix) of a block's conv→BN pairs."""
    if "conv_bn_1" in p:  # fused bottleneck: only the 3×3 is a plain pair
        return [("Conv_0", "BatchNorm_0", "2")]
    n = sum(1 for k in p if k.startswith("Conv_"))
    return [(f"Conv_{i}", f"BatchNorm_{i}", str(i + 1)) for i in range(n)]


def params_from_flax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` (numpy leaves) → a ``ResNet``
    state dict (f32), running statistics included."""
    params = params.get("params", params)
    batch_stats = batch_stats.get("batch_stats", batch_stats)
    out: dict[str, torch.Tensor] = {}
    _conv(params["stem_conv"]["kernel"], "stem_conv", out)
    _bn(params["stem_bn"], batch_stats["stem_bn"], "stem_bn", out)
    blocks = sorted((k for k in params if k.startswith(("BottleneckBlock_",
                                                        "BasicBlock_"))),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(blocks):
        p, s, pre = params[name], batch_stats[name], f"blocks.{i}"
        for conv, bn, suffix in _block_layers(p):
            _conv(p[conv]["kernel"], f"{pre}.conv_{suffix}", out)
            _bn(p[bn], s[bn], f"{pre}.bn_{suffix}", out)
        for fused in ("conv_bn_1", "conv_bn_3"):
            if fused in p:
                _conv(p[fused]["kernel"], f"{pre}.{fused}", out, "kernel")
                _bn(p[fused], s[fused], f"{pre}.{fused}", out)
        if "shortcut_conv" in p:
            _conv(p["shortcut_conv"]["kernel"], f"{pre}.shortcut_conv", out)
            _bn(p["shortcut_bn"], s["shortcut_bn"], f"{pre}.shortcut_bn", out)
    out["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    out["head.bias"] = _t(params["head"]["bias"])
    return out

"""Carry flax LeNet-5 weights across to the port's model.

The flax tree (``variables["params"]`` of the JAX package's ``LeNet5``,
leaves as numpy arrays) names its layers ``Conv_0``, ``Conv_1``,
``Dense_0``..``Dense_2``; the port's are ``conv_0``..``dense_2``. A conv
kernel HWIO becomes an OIHW weight, a dense kernel ``[in, out]`` an
``nn.Linear`` weight ``[out, in]``. ``Dense_0``'s rows keep flax's order:
the port's model flattens its pooled activations in NHWC order, as flax
does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``params`` (numpy leaves) → a :class:`~.lenet.LeNet5` state
    dict (f32)."""
    params = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        kind, index = name.split("_")
        kernel = np.asarray(p["kernel"])
        weight = kernel.transpose(3, 2, 0, 1) if kind == "Conv" else kernel.T
        out[f"{kind.lower()}_{index}.weight"] = _t(weight)
        out[f"{kind.lower()}_{index}.bias"] = _t(p["bias"])
    return out

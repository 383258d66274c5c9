"""Carry flax DLRM / Wide-and-Deep weights across to the port's models.

The flax tree (``variables["params"]`` of the JAX package's ``DLRM`` or
``WideAndDeep``, leaves as numpy arrays) has the port's module names; only
the layout differs: a ``Dense`` kernel ``[in, out]`` becomes an
``nn.Linear`` weight ``[out, in]``, and a fused table is copied as it is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def params_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``params`` (numpy leaves) → a ``DLRM``/``WideAndDeep`` state
    dict (f32)."""
    params = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "embedding_table" in p:  # a FusedEmbedding
            out[f"{name}.embedding_table"] = _t(p["embedding_table"])
        elif "kernel" in p:  # a Dense (wide_dense)
            _dense(p, name, out)
        else:  # an MLP of dense_0, dense_1, ...
            for layer, lp in p.items():
                _dense(lp, f"{name}.{layer}", out)
    return out

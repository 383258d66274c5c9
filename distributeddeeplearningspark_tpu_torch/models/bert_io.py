"""Carry flax BERT weights across to the port's :class:`~.bert.BertForMLM`.

The flax tree (``variables["params"]`` of the JAX package's ``BertForMLM``,
leaves as numpy arrays) differs from the torch state dict in three ways:

- ``DenseGeneral`` kernels are ``[hidden, heads, head_dim]`` for q/k/v and
  ``[heads, head_dim, hidden]`` for ``out``; ``nn.Linear`` wants
  ``[out, in]``, so they are flattened and transposed (q/k/v biases
  ``[heads, head_dim]`` flatten).
- ``Dense`` kernels are ``[in, out]``: transposed.
- the token embedding sits at the top of the flax tree (shared into the
  encoder and the tied decoder); the port keeps it in the encoder.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    kernel = np.asarray(tree["kernel"], np.float32)
    bias = np.asarray(tree["bias"], np.float32)
    if kernel.ndim == 3 and bias.ndim == 2:      # q/k/v: [H, nh, hd]
        kernel = kernel.reshape(kernel.shape[0], -1)
    elif kernel.ndim == 3:                        # out: [nh, hd, H]
        kernel = kernel.reshape(-1, kernel.shape[-1])
    out[f"{prefix}.weight"] = _t(kernel.T)
    out[f"{prefix}.bias"] = _t(bias.reshape(-1))


def _ln(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def params_from_flax(flax_params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``params`` (numpy leaves) → a ``BertForMLM`` state dict (f32)."""
    p = flax_params.get("params", flax_params)
    enc = p["encoder"]
    out: dict[str, torch.Tensor] = {
        "encoder.token_embeddings.weight": _t(p["token_embeddings"]["embedding"]),
        "encoder.position_embeddings.weight":
            _t(enc["position_embeddings"]["embedding"]),
        "encoder.type_embeddings.weight": _t(enc["type_embeddings"]["embedding"]),
        "mlm_bias": _t(p["mlm_bias"]),
    }
    _ln(enc["embeddings_ln"], "encoder.embeddings_ln", out)
    n_layers = sum(1 for k in enc if k.startswith("layer_"))
    for i in range(n_layers):
        lay, pre = enc[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("query", "key", "value", "out"):
            _dense(lay["attention"][name], f"{pre}.attention.{name}", out)
        _ln(lay["attention_ln"], f"{pre}.attention_ln", out)
        _dense(lay["mlp_in"], f"{pre}.mlp_in", out)
        _dense(lay["mlp_out"], f"{pre}.mlp_out", out)
        _ln(lay["mlp_ln"], f"{pre}.mlp_ln", out)
    _dense(p["mlm_dense"], "mlm_dense", out)
    _ln(p["mlm_ln"], "mlm_ln", out)
    return out

"""Llama-2 weights in and out of the port's :class:`~.llama.LlamaForCausalLM`
— the port of ``distributeddeeplearningspark_tpu/models/llama_io.py``.

- :func:`params_from_flax` carries the JAX model's params across: flax
  ``DenseGeneral`` kernels are ``[in, out...]`` (q/k/v ``[H, heads, hd]``,
  ``wo`` ``[heads, hd, H]``), the port's weights torch's ``[out, in]``;
  the LoRA A ``[in, r]`` and B ``[r, out]`` keep their layout, and so do
  an MoE layer's ``moe/{router,w_gate,w_up,w_down}`` (the port's
  :class:`~.moe.MoEMLP` stores the flax layout). Both of the
  flax layouts are read: scanned (``layers/...`` stacked on a leading
  ``[L]`` axis, the flax default) and unrolled (``layers_{i}/...``).
- :func:`load_llama_safetensors` and :func:`export_llama_safetensors` read
  and write Hugging Face Llama checkpoints under the HF names of the JAX
  package's ``_layer_maps``. HF keeps torch's ``[out, in]`` layout, so
  only the names change. The safetensors format is read and written here
  (an 8-byte little-endian header length, a JSON header of each tensor's
  dtype, shape and byte range, then the raw little-endian tensors; bf16 as
  its raw 16 bits), without the ``safetensors`` package. A load reads one
  tensor at a time from a memory map and casts it to the config's storage
  dtype, so a 7B import never holds the model in f32.
- :func:`merge_lora` folds trained adapters into the base weights.

Adapters are never exported or imported: a checkpoint holds the base
model, and the adapters start fresh (B = 0) or come from the port's own
checkpoints.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch.models.llama import LlamaConfig

#: (HF suffix, port suffix) of one decoder layer's tensors (JAX's
#: ``_layer_maps``, whose flax paths the port's names follow)
_LAYER_NAMES = [
    ("self_attn.q_proj.weight", "attention.wq.weight"),
    ("self_attn.k_proj.weight", "attention.wk.weight"),
    ("self_attn.v_proj.weight", "attention.wv.weight"),
    ("self_attn.o_proj.weight", "attention.wo.weight"),
    ("mlp.gate_proj.weight", "mlp.gate.weight"),
    ("mlp.up_proj.weight", "mlp.up.weight"),
    ("mlp.down_proj.weight", "mlp.down.weight"),
    ("input_layernorm.weight", "attention_norm.scale"),
    ("post_attention_layernorm.weight", "mlp_norm.scale"),
]
_TOP_NAMES = [("model.embed_tokens.weight", "token_embed.weight"),
              ("model.norm.weight", "final_norm.scale"),
              ("lm_head.weight", "lm_head.weight")]

# -- the flax tree -------------------------------------------------------------


def _t(a) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes too) as a torch tensor, its dtype
    kept."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layer_from_flax(lay: Mapping[str, Any], cfg: LlamaConfig, pre: str,
                     out: dict) -> None:
    h = cfg.hidden_size
    att = lay["attention"]
    for name in ("wq", "wk", "wv"):   # [H, heads, hd] → [heads·hd, H]
        node = att[name]
        out[f"{pre}.attention.{name}.weight"] = _t(
            np.asarray(node["base"]["kernel"]).reshape(h, -1).T)
        _lora(node, f"{pre}.attention.{name}", out)
    node = att["wo"]                   # [heads, hd, H] → [H, heads·hd]
    out[f"{pre}.attention.wo.weight"] = _t(
        np.asarray(node["base"]["kernel"]).reshape(-1, h).T)
    _lora(node, f"{pre}.attention.wo", out)
    if "moe" in lay:  # the expert bank and the router keep the flax layout
        for name in ("router", "w_gate", "w_up", "w_down"):
            out[f"{pre}.moe.{name}"] = _t(lay["moe"][name])
    else:
        for name in ("gate", "up", "down"):
            node = lay["mlp"][name]
            out[f"{pre}.mlp.{name}.weight"] = _t(np.asarray(node["base"]["kernel"]).T)
            _lora(node, f"{pre}.mlp.{name}", out)
    out[f"{pre}.attention_norm.scale"] = _t(lay["attention_norm"]["scale"])
    out[f"{pre}.mlp_norm.scale"] = _t(lay["mlp_norm"]["scale"])


def _lora(node: Mapping[str, Any], pre: str, out: dict) -> None:
    for k in ("lora_a", "lora_b"):
        if k in node:
            out[f"{pre}.{k}"] = _t(node[k])


def params_from_flax(flax_params: Mapping[str, Any], cfg: LlamaConfig
                     ) -> dict[str, torch.Tensor]:
    """flax ``params`` (numpy leaves) → a ``LlamaForCausalLM`` state dict,
    each tensor in its flax dtype. Reads the scanned (``layers``) and the
    unrolled (``layers_{i}``) layouts."""
    p = flax_params.get("params", flax_params)
    out: dict[str, torch.Tensor] = {
        "token_embed.weight": _t(p["token_embed"]["embedding"]),
        "final_norm.scale": _t(p["final_norm"]["scale"]),
        "lm_head.weight": _t(np.asarray(p["lm_head"]["kernel"]).T),
    }
    for i in range(cfg.num_layers):
        if "layers" in p:  # scanned: every leaf stacked on a leading [L]
            lay = _index_tree(p["layers"], i)
        else:
            lay = p[f"layers_{i}"]
        _layer_from_flax(lay, cfg, f"layers.{i}", out)
    return out


def _index_tree(tree: Mapping[str, Any], i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}

# -- the safetensors format ------------------------------------------------------


_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _read_header(path: str) -> tuple[dict, int]:
    """(the header's tensors, the byte offset of the data) of one file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        n = int.from_bytes(head, "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _load_tensor(path: str, entry: dict, base: int) -> torch.Tensor:
    """One tensor of a file, copied out of a read-only memory map."""
    dtype = _DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"{path}: unsupported dtype {entry['dtype']}")
    begin, end = entry["data_offsets"]
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=base + begin,
                    shape=(end - begin,)) if end > begin else np.zeros(0, np.uint8)
    t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype)
    return t.reshape(entry["shape"])


def _shard_files(path: str) -> list[str]:
    """The safetensors files of ``path``: one file, or a HF shard
    directory (through its index when it has one)."""
    if not os.path.isdir(path):
        return [path]
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    return [os.path.join(path, f) for f in files]


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as one safetensors file: in name order, each
    contiguous and little-endian, the header padded with spaces to 8
    bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for raw in blobs:
            f.write(raw)

# -- HF checkpoints ---------------------------------------------------------------


def load_llama_safetensors(path: str, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """A HF Llama-2 checkpoint (a safetensors file or shard directory) → a
    ``LlamaForCausalLM`` state dict without adapters: the weights in
    ``cfg.param_dtype``, the norm scales in f32. A checkpoint with a tied
    head (no ``lm_head.weight``) takes the embedding for it."""
    where: dict[str, tuple[str, dict, int]] = {}
    for f in _shard_files(path):
        header, base = _read_header(f)
        where.update({name: (f, e, base) for name, e in header.items()})

    def load(name: str, dtype: torch.dtype) -> torch.Tensor:
        if name not in where:
            raise KeyError(f"tensor {name!r} not found in {path}")
        return _load_tensor(*where[name]).to(dtype)

    def dtype_of(port_name: str) -> torch.dtype:
        return torch.float32 if port_name.endswith(".scale") else cfg.param_dtype

    names = [*_TOP_NAMES, *((f"model.layers.{i}.{hf}", f"layers.{i}.{port}")
                            for i in range(cfg.num_layers)
                            for hf, port in _LAYER_NAMES)]
    out = {}
    for hf, port in names:
        if hf == "lm_head.weight" and hf not in where:  # tied-embedding export
            hf = "model.embed_tokens.weight"
        out[port] = load(hf, dtype_of(port))
    return out


def export_llama_safetensors(params: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                             path: str) -> None:
    """A ``LlamaForCausalLM`` state dict → one HF-layout safetensors file
    (the inverse of :func:`load_llama_safetensors`). Adapters are not
    exported: fold them in first (:func:`merge_lora`) for a merged
    export."""
    to_hf = {port: hf for hf, port in _TOP_NAMES}
    to_hf.update({f"layers.{i}.{port}": f"model.layers.{i}.{hf}"
                  for i in range(cfg.num_layers) for hf, port in _LAYER_NAMES})
    out = {}
    for name, t in params.items():
        if ".lora_" in name:
            continue
        if name not in to_hf:
            raise KeyError(f"{name} is not a Llama param of this config")
        out[to_hf[name]] = t
    write_safetensors(out, path)


def merge_lora(params: Mapping[str, torch.Tensor], cfg: LlamaConfig
               ) -> dict[str, torch.Tensor]:
    """Fold trained LoRA adapters into their base weights, ``W ← W +
    (alpha/r)·(A·B)ᵀ`` (the product in f32, added in W's dtype), and drop
    the adapters: the deploy-time merge that makes LoRA inference free."""
    out = {k: v for k, v in params.items() if ".lora_" not in k}
    scale = cfg.lora_alpha / cfg.lora_rank if cfg.lora_rank else 0.0
    for name in params:
        m = re.fullmatch(r"(.+)\.lora_a", name)
        if not m:
            continue
        pre = m.group(1)
        a, b = params[f"{pre}.lora_a"].float(), params[f"{pre}.lora_b"].float()
        w = params[f"{pre}.weight"]
        out[f"{pre}.weight"] = w + ((a @ b).T * scale).to(w.dtype)
    return out

"""Weights for the port's :class:`~.resnet.ResNet`: torchvision's state
dicts (:func:`import_torchvision_resnet`, and ``transformers``' ResNet
through :func:`hf_resnet_to_torchvision_keys`), and the JAX package's flax
trees (:func:`params_from_flax`).

torchvision's convs are OIHW, the port's layout, and its ``fc`` is
``nn.Linear``'s: the import renames and copies. ``layer{s}.{b}`` is the
port's ``blocks.{sum(depths[:s-1]) + b}``; ``conv{i}``/``bn{i}`` its
``conv_{i}``/``bn_{i}`` (in a fused bottleneck, ``conv_bn_{1,3}`` take the
1×1 pairs, conv kernel as ``kernel``); ``downsample.0``/``.1`` its
``shortcut_conv``/``shortcut_bn``; BatchNorm's ``weight``/``bias`` its
``scale``/``bias`` and ``running_mean``/``running_var`` its ``mean``/``var``
buffers. The port's 3×3 convs pad (1, 1) as torch's do, so the import is
exact.

The flax trees (``variables["params"]`` and ``variables["batch_stats"]`` of
the JAX package's ``ResNet``, leaves as numpy arrays) differ from the
port's state dict in layout and names:

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


def import_torchvision_resnet(state_dict: Mapping, *, stage_sizes,
                              bottleneck: bool = True, fused_conv_bn: bool = False
                              ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """A torchvision-convention ``state_dict`` → ``(params, batch_stats)``,
    each keyed by the port's names (``named_parameters()`` and the BatchNorm
    buffers of ``named_buffers()``), f32: what ``Trainer.load_pretrained(
    params, batch_stats=batch_stats)`` takes. ``stage_sizes``: blocks a
    stage, e.g. ``(3, 4, 6, 3)`` for ResNet-50; ``bottleneck``: True for
    50/101/152, False for 18/34; ``fused_conv_bn``: the target model's
    (its 1×1 pairs live in ``conv_bn_1``/``conv_bn_3``)."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    params: dict[str, torch.Tensor] = {}
    stats: dict[str, torch.Tensor] = {}

    def t(key):
        v = sd[key]
        return (v.detach().to("cpu", torch.float32).clone()
                if isinstance(v, torch.Tensor) else _t(v))

    def bn(src: str, dst: str) -> None:
        params[f"{dst}.scale"] = t(f"{src}.weight")
        params[f"{dst}.bias"] = t(f"{src}.bias")
        stats[f"{dst}.mean"] = t(f"{src}.running_mean")
        stats[f"{dst}.var"] = t(f"{src}.running_var")

    params["stem_conv.weight"] = t("conv1.weight")
    bn("bn1", "stem_bn")
    n_convs = 3 if bottleneck else 2
    idx = 0
    for s, depth in enumerate(stage_sizes, start=1):
        for b in range(depth):
            src, dst = f"layer{s}.{b}", f"blocks.{idx}"
            idx += 1
            for c in range(1, n_convs + 1):
                if bottleneck and fused_conv_bn and c != 2:
                    params[f"{dst}.conv_bn_{c}.kernel"] = t(f"{src}.conv{c}.weight")
                    bn(f"{src}.bn{c}", f"{dst}.conv_bn_{c}")
                else:
                    params[f"{dst}.conv_{c}.weight"] = t(f"{src}.conv{c}.weight")
                    bn(f"{src}.bn{c}", f"{dst}.bn_{c}")
            if f"{src}.downsample.0.weight" in sd:
                params[f"{dst}.shortcut_conv.weight"] = t(f"{src}.downsample.0.weight")
                bn(f"{src}.downsample.1", f"{dst}.shortcut_bn")
    params["head.weight"] = t("fc.weight")
    params["head.bias"] = t("fc.bias")
    return params, stats


def hf_resnet_to_torchvision_keys(state_dict: Mapping) -> dict:
    """A ``transformers`` ResNet ``state_dict`` (``ResNetForImageClassification``)
    → torchvision's names: ``resnet.embedder...`` → ``conv1``/``bn1``,
    ``resnet.encoder.stages.S.layers.B.layer.C`` → ``layer{S+1}.B.conv{C+1}``,
    ``shortcut`` → ``downsample``, ``classifier.1`` → ``fc``. Raises when
    the keys do not look like such a checkpoint."""
    out = {}
    skipped = []
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        parts = k.split(".")
        if k.startswith("resnet.embedder"):
            if parts[-2] == "convolution":
                out["conv1.weight"] = v
            else:
                out[f"bn1.{parts[-1]}"] = v
        elif k.startswith("resnet.encoder.stages."):
            s, b = int(parts[3]), int(parts[5])
            if parts[6] == "shortcut":
                which = "0" if parts[7] == "convolution" else "1"
                out[f"layer{s + 1}.{b}.downsample.{which}.{parts[-1]}"] = v
            else:  # layer.C.{convolution|normalization}
                c = int(parts[7])
                if parts[8] == "convolution":
                    out[f"layer{s + 1}.{b}.conv{c + 1}.weight"] = v
                else:
                    out[f"layer{s + 1}.{b}.bn{c + 1}.{parts[-1]}"] = v
        elif k.startswith("classifier."):
            out[f"fc.{parts[-1]}"] = v
        else:
            skipped.append(k)
    if not out or len(skipped) > len(out):
        raise ValueError(
            f"state_dict does not look like a transformers "
            f"ResNetForImageClassification checkpoint: matched {len(out)} "
            f"keys, unrecognized {len(skipped)} (e.g. {skipped[:3]}); a bare "
            f"ResNetModel lacks the 'resnet.' prefix: wrap it or rename keys first")
    return out

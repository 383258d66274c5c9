"""Pipeline-parallel forward for Llama — the port of
``distributeddeeplearningspark_tpu/models/llama_pp.py``, wiring
:mod:`.llama` into :func:`..parallel.pipeline.pipeline`.

As in JAX, the embedding, the final norm and the head run replicated over
the ``pipe`` axis (a few % of the FLOPs; stages of their own would only
deepen the bubble) and the GPipe schedule carries the decoder trunk: stage
k of P runs layers ``k·L/P … (k+1)·L/P − 1``
(:func:`..parallel.pipeline.stage_layers`), each under the model's own
per-layer ``checkpoint`` when ``cfg.remat`` (no stage-level recompute: the
remat, and so the FLOP count, stays one device's). The math is the
model's own modules; the params keep their names (``layers.<i>...``), so a
checkpoint keeps the format of ``pipe`` 1 and ``llama_io`` converts it.

:func:`make_pp_model` converts a :class:`~.llama.LlamaForCausalLM` in
place: the layers other stages hold become
:class:`~.llama.ElsewhereLayer`\\ s (on a model on the meta device, before
the ``Trainer`` lowers and materialises it, so they are never allocated;
``init_weights`` still draws their values in order and discards them), and
``model(batch)`` runs the pipelined forward, a drop-in for the train and
eval steps. Where the port differs from JAX: only stage 0 runs the
embedding (the other stages' copies of it would be discarded, JAX
computes and drops them), so stage 0 alone produces its gradient, which
the train step sums over the pipe group; every pipe peer's head is the
same product on the same rows, counted once by a measured FLOP count
(:func:`~..metrics.replicated_matmul`, counted on stage 0).

Limitations (raised, in the JAX words): MoE, the fused head loss,
``num_layers % pipe``, an ``attention_mask`` (causal packing handles
padding via ``loss_mask``) and ``segment_ids``. M defaults to P.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from distributeddeeplearningspark_tpu_torch.models.llama import (
    ElsewhereLayer,
    LlamaConfig,
    LlamaForCausalLM,
)
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_PIPE
from distributeddeeplearningspark_tpu_torch.parallel.pipeline import (
    pipeline,
    stage_layers,
)

#: the params only stage 0 uses: their gradient is summed over ``pipe``
FIRST_STAGE_PARAMS = ("token_embed.weight",)


def check_pp_config(cfg: LlamaConfig, p: int) -> None:
    """The pipeline-compatibility ladder (JAX's, but ``scan_layers``: the
    port's layers are a ``ModuleList``, which stages slice)."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE is not wired through pipeline parallelism: the stage "
            "forward discards each layer's load-balance aux loss, so the "
            "router would silently collapse (no balancing gradient) — use "
            "the data×expert(+fsdp/tensor) layout for MoE models")
    if cfg.fused_head_loss:
        raise ValueError(
            "fused_head_loss is not supported with pipeline parallelism: "
            "the GPipe forward emits real logits — pair PP with "
            "losses.causal_lm (or drop the config flag)")
    if cfg.num_layers % p:
        raise ValueError(f"num_layers {cfg.num_layers} must divide by pipe {p}")


def _stage_forward(layers: Sequence[torch.nn.Module], x: torch.Tensor,
                   remat: bool) -> torch.Tensor:
    """A stage's layers in order, each under the model's checkpoint."""
    for layer in layers:
        if remat:
            x = checkpoint(layer, x, None, None, use_reentrant=False)
        else:
            x = layer(x, None, None)
    return x


class PipelinedForward:
    """The pipelined ``LlamaForCausalLM.forward`` of one stage (the model
    holds it as ``model.pipe``)."""

    #: the params only stage 0 uses: the train step sums their gradients
    #: over the pipe group
    first_stage_params = FIRST_STAGE_PARAMS

    def __init__(self, mesh, num_microbatches: int, layers: range):
        self.mesh = mesh
        self.stage = mesh.pipe_index
        self.num_microbatches = num_microbatches
        self.layers = layers

    def forward(self, model: LlamaForCausalLM, batch: dict) -> torch.Tensor:
        cfg = model.cfg
        if batch.get("attention_mask") is not None:
            raise NotImplementedError(
                "pipeline-parallel Llama supports causal packing only; "
                "handle padding via loss_mask (as config 5 does)")
        if batch.get("segment_ids") is not None:
            raise NotImplementedError(
                "pipeline-parallel Llama does not thread segment_ids to the "
                "stage forwards — packed batches would silently attend "
                "across documents; drop segment_ids (GPT-style packing) or "
                "use a non-PP layout")
        ids = batch["input_ids"]
        if ids.shape[1] > cfg.max_position:
            raise ValueError(
                f"sequence length {ids.shape[1]} exceeds max_position "
                f"{cfg.max_position}")
        b, s = ids.shape
        if self.stage == 0:
            x = model._embed(ids)
        else:  # the other stages read only its shape and dtype
            x = torch.zeros((), dtype=cfg.dtype, device=ids.device).expand(
                b, s, cfg.hidden_size)
        layers = [model.layers[i] for i in self.layers]
        remat = cfg.remat and torch.is_grad_enabled()
        m = self.num_microbatches
        if not model.training:
            # an evaluation's padded tail holds fewer rows: no row sees
            # another, so fewer microbatches give each row the same output
            m = math.gcd(b, m)
        x = pipeline(lambda a: _stage_forward(layers, a, remat), x, mesh=self.mesh,
                     num_microbatches=m)
        return model._head(model.final_norm(x), counted=self.stage == 0)


def make_pp_model(model: LlamaForCausalLM, mesh, num_microbatches: int | None = None
                  ) -> LlamaForCausalLM:
    """Convert ``model`` in place to run its decoder trunk through the
    ``pipe`` axis's P stages of ``mesh`` (the session's), this rank holding
    its stage's layers only; returns it. ``num_microbatches`` defaults to P.
    The drop-in for ``model(batch)`` that JAX's ``make_pp_apply`` is for
    ``model.apply``."""
    p = int(mesh.shape[AXIS_PIPE])
    if p < 2:
        raise ValueError(f"pipeline apply needs a pipe axis > 1 (mesh {dict(mesh.shape)})")
    cfg = model.cfg
    check_pp_config(cfg, p)
    m = num_microbatches or p
    stage = mesh.pipe_index
    mine = stage_layers(cfg.num_layers, p, stage)
    for i in range(cfg.num_layers):
        if i not in mine:
            model.layers[i] = ElsewhereLayer(i, i // len(mine))
    model.pipe = PipelinedForward(mesh, m, mine)
    return model


def whole_param_names(cfg: LlamaConfig) -> list[str]:
    """Every param name of the whole model at ``cfg``, in its order."""
    return [n for n, _ in LlamaForCausalLM(cfg, device="meta").named_parameters()]

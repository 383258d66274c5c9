"""Loss functions — the port of ``train/losses.py`` for BERT, ResNet,
DLRM and Llama.

Each takes (model outputs, batch dict) and returns (scalar loss, metrics
dict). A loss whose denominator is not the example count reports a
``"weight"`` metric, which :meth:`..trainer.Trainer.evaluate` uses to
combine per-batch means exactly across unequal batches; the train loop
drops it from its logs. ``causal_lm`` takes the logits, or an MoE
model's ``{"logits", "moe_aux", "moe_dropped_frac"}`` (:func:`_add_moe_aux`:
the already weighed load-balance loss joins the loss and both are
reported); the fused LM head (``causal_lm_fused``) is not ported yet
(ROADMAP Queue 1 item 5). Logits split over the vocab
(a ``DTensor`` ``Shard(2)`` over ``tensor``, the Llama head under tensor
parallelism) go through a vocab-parallel cross-entropy that gathers no
logits. Under context parallelism a batch holds one block of each row's
sequence and the next-token labels made from the whole rows
(``feed.NEXT_IDS``, ``feed.NEXT_MASK``, :func:`..data.feed.seq_shard`):
``causal_lm`` then takes every position of the block against them, so the
per-token losses and weights are those JAX's ``causal_lm`` takes over the
whole rows, split over the ``seq`` peers.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from distributeddeeplearningspark_tpu_torch.data.feed import NEXT_IDS, NEXT_MASK
from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding


def softmax_xent(logits: torch.Tensor, batch: dict[str, Any]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Classification (ResNet-50/ImageNet): mean cross-entropy and accuracy,
    and top-5 accuracy when there are more than 5 classes.

    A padded eval batch's ``eval_mask`` weighs its rows; the metrics are
    then weighted means and ``"weight"`` is the real row count."""
    labels = batch["label"].long()
    per_ex = F.cross_entropy(logits.float(), labels, reduction="none")
    hit = (logits.argmax(-1) == labels).float()
    top5 = None
    if logits.shape[-1] > 5:
        top5 = (logits.topk(5, dim=-1).indices == labels[:, None]).any(-1).float()
    em = batch.get("eval_mask")
    if em is None:
        loss = per_ex.mean()
        metrics = {"loss": loss, "accuracy": hit.mean()}
        if top5 is not None:
            metrics["top5_accuracy"] = top5.mean()
        return loss, metrics
    w = em.float()
    denom = w.sum().clamp(min=1.0)
    loss = (per_ex * w).sum() / denom
    metrics = {"loss": loss, "accuracy": (hit * w).sum() / denom, "weight": denom}
    if top5 is not None:
        metrics["top5_accuracy"] = (top5 * w).sum() / denom
    return loss, metrics


def masked_lm(logits: torch.Tensor, batch: dict[str, Any]
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """BERT MLM: f32 cross-entropy over the masked positions, weighted mean.

    ``batch['mlm_labels']`` holds target ids, ``batch['mlm_weights']`` is 1.0
    at masked positions and 0.0 elsewhere; rows of a padded eval batch carry
    ``eval_mask == 0`` and weigh nothing."""
    labels = batch["mlm_labels"].long()
    weights = batch["mlm_weights"].float()
    em = batch.get("eval_mask")
    if em is not None:  # padded eval rows contribute zero mask weight
        weights = weights * em.float()[:, None]
    logits = logits.float()
    per_tok = F.cross_entropy(logits.flatten(0, -2), labels.flatten(),
                              reduction="none").view(labels.shape)
    denom = weights.sum().clamp(min=1.0)
    loss = (per_tok * weights).sum() / denom
    acc = ((logits.argmax(-1) == labels) * weights).sum() / denom
    return loss, {"loss": loss, "mlm_accuracy": acc, "weight": denom}


def binary_xent(logits: torch.Tensor, batch: dict[str, Any]
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """CTR prediction (Wide&Deep/DLRM on Criteo): optax's sigmoid binary
    cross-entropy, mean over rows, and accuracy (``logit > 0`` against
    ``label > 0.5``). A padded eval batch's ``eval_mask`` weighs its rows,
    as in :func:`softmax_xent`."""
    labels = batch["label"].float()
    logits = logits.float().reshape(labels.shape)
    per_ex = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    hit = ((logits > 0) == (labels > 0.5)).float()
    em = batch.get("eval_mask")
    if em is None:
        loss = per_ex.mean()
        return loss, {"loss": loss, "accuracy": hit.mean()}
    w = em.float()
    denom = w.sum().clamp(min=1.0)
    loss = (per_ex * w).sum() / denom
    return loss, {"loss": loss, "accuracy": (hit * w).sum() / denom,
                  "weight": denom}


def _reduce_next_token(per_tok: torch.Tensor, batch: dict[str, Any]
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The JAX package's LM reduction: the shifted ``loss_mask`` (the mask
    of each target token; under context parallelism ``NEXT_MASK``, shifted
    over the whole rows), padded eval rows weighing nothing, the weighted
    mean, and the metrics ``loss``, ``perplexity`` and ``weight``."""
    mask = batch.get("loss_mask")
    em = batch.get("eval_mask")
    if NEXT_MASK in batch:
        mask = batch[NEXT_MASK].float()
    elif mask is not None:
        mask = mask[:, 1:].float()
    elif em is not None:
        mask = torch.ones_like(per_tok)
    if em is not None:  # padded eval rows: zero token weight end-to-end
        mask = mask * em.float()[:, None]
    if mask is not None:
        denom = mask.sum().clamp(min=1.0)
        loss = (per_tok * mask).sum() / denom
    else:
        denom = torch.tensor(float(per_tok.numel()), device=per_tok.device)
        loss = per_tok.mean()
    return loss, {"loss": loss, "perplexity": torch.exp(loss), "weight": denom}


def _add_moe_aux(loss: torch.Tensor, metrics: dict[str, torch.Tensor], outputs
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Fold a model's (already weighed) MoE load-balance loss into the loss,
    and report it and the dropped share, a metric only. ``perplexity``
    stays the exponential of the cross-entropy, as JAX's."""
    if isinstance(outputs, dict) and "moe_aux" in outputs:
        aux = outputs["moe_aux"]
        loss = loss + aux
        metrics = {**metrics, "loss": loss, "moe_aux": aux}
        if "moe_dropped_frac" in outputs:
            metrics["moe_dropped_frac"] = outputs["moe_dropped_frac"]
    return loss, metrics


def causal_lm(logits: torch.Tensor, batch: dict[str, Any]
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross-entropy in f32 (the Llama-2 LoRA fine-tune): the
    logits at position t against ``input_ids`` at t + 1 (under context
    parallelism every position against ``NEXT_IDS``); respects
    ``loss_mask`` and ``eval_mask``. An MoE model's output dict adds its
    load-balance loss (:func:`_add_moe_aux`)."""
    outputs = logits
    if isinstance(logits, dict):
        logits = outputs["logits"]
    if not isinstance(logits, torch.Tensor):
        raise TypeError(f"causal_lm takes the [B, S, V] logits, got "
                        f"{type(logits).__name__} (the fused head's outputs are "
                        f"not ported yet)")
    # the positions that have a label here: all of a block whose labels
    # came from the whole rows, else all but the last
    whole = NEXT_IDS in batch
    labels = (batch[NEXT_IDS] if whole else batch["input_ids"][:, 1:]).long()
    split = sharding.tensor_split(logits)
    if split is not None:
        per_tok = _vocab_parallel_xent(logits, labels, split, shifted=not whole)
    else:
        logits = (logits if whole else logits[:, :-1]).float()
        per_tok = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                                  reduction="none").view(labels.shape)
    loss, metrics = _reduce_next_token(per_tok, batch)
    return _add_moe_aux(loss, metrics, outputs)


def _vocab_parallel_xent(logits, labels: torch.Tensor, split, shifted: bool = True
                         ) -> torch.Tensor:
    """Per-token cross-entropy, in f32, of ``[B, S, V]`` logits split over
    the vocab (``split``: this rank holds columns ``[i·n, (i+1)·n)``)
    against ``labels`` ``[B, S-1]`` (``shifted``: the last position has
    none) or ``[B, S]``, the logits at position t against the label at t:
    ``log Σ exp(z) − z[label]`` with ``z`` the logits less their
    row max, the max and the two sums taken over the group (Megatron's
    vocab-parallel cross-entropy). Each rank's gradient reaches only its
    columns (``softmax − onehot`` there)."""
    import torch.distributed as dist

    if split.dim != logits.dim() - 1:
        raise NotImplementedError(f"logits split on dim {split.dim}: the loss "
                                  f"takes them split over the vocab (last dim)")
    part = logits.to_local()
    part = (part[:, :-1] if shifted else part).float()
    n = part.shape[-1]
    with torch.no_grad():
        top = part.max(-1, keepdim=True).values
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=split.group)
    z = part - top
    rel = labels - split.index * n
    inside = (rel >= 0) & (rel < n)
    picked = z.gather(-1, torch.where(inside, rel, 0)[..., None])[..., 0] * inside
    sums = collectives.all_reduce_forward(torch.stack([z.exp().sum(-1), picked]),
                                          split.group)
    return torch.log(sums[0]) - sums[1]

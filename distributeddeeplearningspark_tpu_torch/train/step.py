"""The train and eval steps — the port of ``train/step.py``.

The JAX package compiles ``(state, batch) -> (state, metrics)`` into one
jitted SPMD program; here the same function runs eagerly: the forward in
train mode (dropout drawn from the state's generator), ``loss.backward()``,
the global gradient norm reported as ``grad_norm``, the optimizer's update
applied to the params in place, ``step + 1``. The model's buffers
(BatchNorm's running statistics, ``state.mutable``) are updated by the
forward itself and are neither params nor optimizer state. It never copies to the host:
metrics stay device tensors until the loop's log point, as the JAX loop
fetches them only there. The non-finite guard is not ported yet.

``trainable`` (a predicate over param names, the LoRA fine-tune's
``lora_trainable``): the params it rejects leave autograd
(``requires_grad_(False)``), so they take no ``.grad``, no gradient
matmul, no part in ``grad_norm`` and no update, where the JAX step
``stop_gradient``\\ s them into zero gradients (the same norm, the same
update under the masked optimizer). The optimizer (:mod:`.optim`) sees the
params that ``trainable`` and its own mask (``optim.masked``) both accept,
in ``state.params`` order (:func:`optimizer_params`).

``accum_steps > 1``: the batch splits into that many equal micro-batches
(in order along the batch axis; a batch that does not divide raises), each
one forward and backward, the gradients summed in ``.grad`` as the JAX
step's scan sums them and divided by ``accum_steps``; the metrics are the
micro-batches' mean.

``distributed=True`` (a data-parallel gang, :mod:`..parallel.collectives`):
each rank holds its own rows of the global batch, and the step makes the
JAX step's gradient of the *global* batch's loss. Before each backward, one
small all-reduce of the ranks' weights (the loss's ``"weight"``, else the
rows) scales rank r's loss by ``w_r / W`` and makes the logged metrics
global; after the last backward, the gradients are summed across ranks
once, one flat buffer per dtype. ``grad_norm`` and clipping see the reduced
gradient. Micro-batch i is every rank's i-th slice of its rows. The model's
buffers are not reduced: BatchNorm's forward already takes the global
batch's statistics (:mod:`..models.resnet`), so they move alike on every
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train.optim import (
    GradientTransformation,
    global_norm,
    updated_by,
)
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

LossFn = Callable[[Any, dict[str, Any]], tuple[torch.Tensor, dict[str, torch.Tensor]]]


def optimizer_params(names, tx: GradientTransformation,
                     trainable: Callable[[str], bool] | None = None) -> list[str]:
    """The names among ``names`` (in order) of the params the optimizer
    updates: those ``trainable`` and ``tx``'s mask both accept."""
    mask = updated_by(tx)
    return [n for n in names if (trainable is None or trainable(n)) and mask(n)]


def split_batch(batch: dict[str, torch.Tensor], accum_steps: int
                ) -> list[dict[str, torch.Tensor]]:
    """``accum_steps`` equal micro-batches along the batch axis, in order
    (the JAX step's ``reshape((accum_steps, rows // accum_steps, ...))``)."""
    if accum_steps == 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0]
    if rows % accum_steps:
        raise ValueError(f"global batch {rows} must divide by accum_steps "
                         f"{accum_steps}")
    m = rows // accum_steps
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(accum_steps)]


def make_train_step(model: torch.nn.Module, tx: GradientTransformation,
                    loss_fn: LossFn, *, distributed: bool = False,
                    trainable: Callable[[str], bool] | None = None,
                    accum_steps: int = 1):
    """(state, batch) → (state, metrics). ``model(batch, generator=g)``
    returns the outputs ``loss_fn(outputs, batch)`` consumes. Sets each
    param's ``requires_grad`` from ``trainable`` (None: every param)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    named = dict(model.named_parameters())
    grad_names = [n for n in named if trainable is None or trainable(n)]
    for n, p in named.items():
        p.requires_grad_(trainable is None or trainable(n))
    opt_names = set(optimizer_params(grad_names, tx))
    opt_index = [i for i, n in enumerate(grad_names) if n in opt_names]

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = [state.params[n] for n in grad_names]
        opt_params = [params[i] for i in opt_index]
        model.train()
        for p in params:
            p.grad = None
        micro_metrics = []
        for mb in split_batch(batch, accum_steps):
            outputs = model(mb, generator=state.generator)
            loss, metrics = loss_fn(outputs, mb)
            if distributed:
                rows = next(iter(mb.values())).shape[0]
                loss, metrics = collectives.weigh_loss(loss, metrics, rows)
            loss.backward()
            micro_metrics.append({k: v.detach() for k, v in metrics.items()})
            del outputs, loss
        # a trainable param the forward did not reach: JAX's zero gradient
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        with torch.no_grad():
            if accum_steps > 1:
                torch._foreach_div_(grads, float(accum_steps))
            if distributed:
                collectives.all_reduce_grads(grads)
            grad_norm = global_norm(grads)
            updates, opt_state = tx.update([grads[i] for i in opt_index],
                                           state.opt_state, opt_params)
            torch._foreach_add_(opt_params, updates)
        for p in params:
            p.grad = None
        metrics = (micro_metrics[0] if accum_steps == 1 else
                   {k: torch.stack([m[k] for m in micro_metrics]).mean(0)
                    for k in micro_metrics[0]})
        metrics["grad_norm"] = grad_norm
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return train_step


def make_eval_step(model: torch.nn.Module, loss_fn: LossFn):
    """batch → metrics, no gradients, the model in eval mode."""

    def eval_step(batch: dict[str, torch.Tensor]):
        model.eval()
        with torch.inference_mode():
            _, metrics = loss_fn(model(batch), batch)
        return metrics

    return eval_step

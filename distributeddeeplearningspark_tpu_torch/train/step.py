"""The train and eval steps — the port of ``train/step.py``.

The JAX package compiles ``(state, batch) -> (state, metrics)`` into one
jitted SPMD program; here the same function runs eagerly: the forward in
train mode (dropout drawn from the state's generator), ``loss.backward()``,
the global gradient norm reported as ``grad_norm``, the optimizer's update
applied to the params in place, ``step + 1``. The model's buffers
(BatchNorm's running statistics, ``state.mutable``) are updated by the
forward itself and are neither params nor optimizer state. It never copies to the host:
metrics stay device tensors until the loop's log point, as the JAX loop
fetches them only there. This is the JAX step's ``accum_steps == 1``,
unguarded branch; gradient accumulation, frozen params and the non-finite
guard are not ported yet.

``distributed=True`` (a data-parallel gang, :mod:`..parallel.collectives`):
each rank holds its own rows of the global batch, and the step makes the
JAX step's gradient of the *global* batch's loss. Before backward, one
small all-reduce of the ranks' weights (the loss's ``"weight"``, else the
rows) scales rank r's loss by ``w_r / W`` and makes the logged metrics
global; after backward, the gradients are summed across ranks, one flat
buffer per dtype. ``grad_norm`` and clipping see the reduced gradient.
The model's buffers are not reduced: BatchNorm's forward already takes the
global batch's statistics (:mod:`..models.resnet`), so they move alike on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train.optim import (
    GradientTransformation,
    global_norm,
)
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

LossFn = Callable[[Any, dict[str, Any]], tuple[torch.Tensor, dict[str, torch.Tensor]]]


def make_train_step(model: torch.nn.Module, tx: GradientTransformation,
                    loss_fn: LossFn, *, distributed: bool = False):
    """(state, batch) → (state, metrics). ``model(batch, generator=g)``
    returns the outputs ``loss_fn(outputs, batch)`` consumes."""

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = list(state.params.values())
        model.train()
        for p in params:
            p.grad = None
        outputs = model(batch, generator=state.generator)
        loss, metrics = loss_fn(outputs, batch)
        if distributed:
            rows = next(iter(batch.values())).shape[0]
            loss, metrics = collectives.weigh_loss(loss, metrics, rows)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        with torch.no_grad():
            if distributed:
                collectives.all_reduce_grads(grads)
            grad_norm = global_norm(grads)
            updates, opt_state = tx.update(grads, state.opt_state, params)
            torch._foreach_add_(params, updates)
        for p in params:
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
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

"""Row-sparse embedding training: the port of ``train/embed.py``.

A DLRM step touches at most ``batch × 26`` rows of its fused table (about
8% of it at the config-4 shape), so it updates those rows only:

1. **Gather outside autograd.** The rows are looked up before the forward
   as a leaf that requires grad and handed to the model through its
   ``overrides``, so the backward gives gradients of the gathered vectors
   ``[..., D]``, never a dense ``[V, D]`` table gradient.
2. **Row-wise AdaGrad** (torchrec's ROWWISE_ADAGRAD): one accumulator
   scalar per row. :func:`padded_unique` and a sorted segment sum fold
   duplicate ids into one per-row gradient, then a scatter-add applies the
   update to the touched rows only.

The dense optimizer runs over :func:`dense_trainable` params only, so no
optimizer state of table size exists (the JAX package masks its optimizer
with ``optim.masked`` to the same end).

The JAX package poisons the table with NaN so that a model which ignores
the override fails loudly. Here the step raises instead, after the
backward and before any update, when a table received a gradient or a
gathered vector received none: the live table is never touched.

Arrays are updated in place: the table param and the ``row_accum`` of
``TrainState.embed_state``.

In a data-parallel gang each rank holds a replica of every table and
accumulator. The step gathers every rank's ids and vector gradients (rank
order is the global batch's row order) and each rank applies the whole
global batch's update, so the replicas stay equal without ever moving a
table.

The table scatter is always :func:`..ops.scatter_rows.scatter_add_rows`:
K5 on CUDA tensors, its plain version on CPU tensors. The JAX function's
``scatter_impl`` switch (the library scatter by default, the Pallas kernel
on request) is not carried over: K5 gives the library scatter's bits,
faster.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from distributeddeeplearningspark_tpu_torch.ops.scatter_rows import scatter_add_rows
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train.optim import (
    GradientTransformation,
    global_norm,
    updated_by,
)
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

#: embed_state leaf name
ROW_ACCUM = "row_accum"

@dataclasses.dataclass(frozen=True)
class SparseEmbedSpec:
    """One sparsely trained embedding table.

    ``name`` keys the model's ``overrides`` dict and the state's
    ``embed_state`` entry; ``param_path`` is the table's name among the
    model's ``named_parameters()`` (``"embedding.embedding_table"``, the
    JAX path with dots); ``ids_fn(batch)`` returns the integer row ids the
    step gathers (any shape; vectors come back as ``ids.shape + (D,)``).
    """

    name: str
    param_path: str
    ids_fn: Callable[[dict[str, Any]], torch.Tensor]
    lr: float = 1e-2
    eps: float = 1e-8


def dense_trainable(specs: Sequence[SparseEmbedSpec]) -> Callable[[str], bool]:
    """Predicate over param names: everything but the sparse tables, the
    params the dense optimizer sees."""
    paths = {s.param_path for s in specs}
    return lambda name: name not in paths


def padded_unique(flat: torch.Tensor, v: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``jnp.unique(flat, return_inverse=True, size=K, fill_value=v)`` with
    the pads spread as the JAX package spreads them: ``(uniq, inv,
    counts)``, ``uniq`` the sorted distinct ids of ``flat`` ``[K]`` and then
    ``v + i`` in each pad slot ``i`` (unique, sorted, all ``>= v``), ``inv``
    each id's slot, ``counts`` the ids per distinct row (its length is the
    number of distinct rows). One host sync, for the number of distinct
    rows."""
    k = flat.numel()
    uniq, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    n = uniq.numel()
    pads = v + torch.arange(n, k, dtype=uniq.dtype, device=uniq.device)
    return torch.cat([uniq, pads]), inv, counts


def segment_sum(g: torch.Tensor, inv: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """``jax.ops.segment_sum(g, inv, num_segments=K)`` for the ``inv`` and
    ``counts`` of :func:`padded_unique`, K = ``len(g)``; deterministic on
    every device: the rows are put in segment order by a stable sort, then
    each segment is summed in the order its rows came in. No atomics, so
    two runs give the same bits."""
    order = torch.argsort(inv, stable=True)
    out = torch.zeros_like(g)
    out[:counts.numel()] = torch.segment_reduce(
        g[order], "sum", lengths=counts, axis=0, unsafe=True)
    return out


def rowwise_adagrad_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    d_vecs: torch.Tensor,
    *,
    lr: float,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on the rows named by ``ids`` only, in place.

    ``accum`` is ``[V]`` f32, one running mean-square per row. The JAX
    function's padded-unique contract is kept, so that K5 sees what the
    Pallas path sees: the sorted distinct ids padded to K with the
    sentinels ``v + i``, duplicates summed by a deterministic
    :func:`segment_sum`, the accumulator read as 0 for sentinels,
    ``new_acc = acc + mean(g², axis=1)``, the update
    ``-lr·g/sqrt(new_acc + eps)``. The table takes the update through
    :func:`scatter_add_rows` (K5 on CUDA, which drops the sentinels
    itself); the accumulator is set on the in-range rows only, by a torch
    op, as the JAX package keeps it in XLA. Returns ``(table, accum)``."""
    v, d = table.shape
    flat = ids.reshape(-1)
    k = flat.numel()
    g = d_vecs.reshape(k, d).float()
    uniq, inv, counts = padded_unique(flat, v)
    n = counts.numel()  # the distinct in-range rows lead, the sentinels trail
    row_g = segment_sum(g, inv, counts)  # [K, D]
    acc_rows = torch.zeros(k, dtype=accum.dtype, device=accum.device)
    acc_rows[:n] = accum[uniq[:n]]
    new_acc_rows = acc_rows + torch.mean(row_g * row_g, dim=1)
    upd = (-lr * row_g / torch.sqrt(new_acc_rows + eps)[:, None]).to(table.dtype)
    scatter_add_rows(table, uniq, upd)
    accum[uniq[:n]] = new_acc_rows[:n]
    return table, accum


def init_embed_state(specs: Sequence[SparseEmbedSpec],
                     params: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Zero row accumulators, keyed for ``TrainState.embed_state``."""
    out: dict[str, Any] = {}
    for s in specs:
        table = params[s.param_path]
        out[s.name] = {ROW_ACCUM: torch.zeros(table.shape[0], dtype=torch.float32,
                                              device=table.device)}
    return out


def _clear_grads(tensors) -> None:
    for t in tensors:
        t.grad = None


def make_sparse_embed_train_step(model: torch.nn.Module, tx: GradientTransformation,
                                 loss_fn: Callable, specs: Sequence[SparseEmbedSpec],
                                 *, distributed: bool = False):
    """(state, batch) → (state, metrics), the train step with sparse table
    updates. ``tx`` sees the :func:`dense_trainable` params that its own
    mask (``optim.masked``) accepts, in the order of ``state.params``;
    ``state.embed_state`` holds each table's ``row_accum``. The model takes
    ``overrides={spec.name: vectors}`` and must read its tables only
    through them.

    ``distributed=True`` (a data-parallel gang, each rank holding its rows
    of the global batch): the loss is weighed and the dense gradients
    all-reduced as in :func:`..step.make_train_step`; each table's ids and
    gathered-vector gradients are all-gathered in rank order, the global
    batch's row order, so every rank runs the same
    :func:`rowwise_adagrad_update` (one unique and one segment sum over the
    global batch, as the JAX step computes them, then K5) on its replica
    of the table and of ``row_accum``; ``grad_norm`` is the norm of the
    global dense gradient and every rank's vector gradients, JAX's
    ``global_norm((g_dense, g_vecs))``. ``gather_bytes`` counts the bytes
    the steps' gathers receive at more than one rank."""
    specs = tuple(specs)
    trainable = dense_trainable(specs)
    updates_param = updated_by(tx)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        names = [name for name in state.params if trainable(name)]
        dense = [state.params[name] for name in names]
        opt_index = [i for i, name in enumerate(names) if updates_param(name)]
        opt_params = [dense[i] for i in opt_index]
        tables = {s.name: state.params[s.param_path] for s in specs}
        everything = [*dense, *tables.values()]
        model.train()
        _clear_grads(everything)
        ids = {s.name: s.ids_fn(batch) for s in specs}
        vecs = {n: tables[n].detach()[ids[n]].requires_grad_() for n in tables}
        outputs = model(batch, generator=state.generator, overrides=vecs)
        loss, metrics = loss_fn(outputs, batch)
        if distributed:
            rows = next(iter(batch.values())).shape[0]
            loss, metrics = collectives.weigh_loss(loss, metrics, rows)
        loss.backward()
        unconsumed = [s.name for s in specs if tables[s.name].grad is not None
                      or vecs[s.name].grad is None]
        if unconsumed:
            _clear_grads(everything)
            raise RuntimeError(
                f"the model did not take its table rows from overrides "
                f"{unconsumed}: a table got a dense gradient, or a gathered "
                f"vector none (a spec name the model does not consume?); "
                f"no param was updated")
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in dense]
        merged = {s.name: (ids[s.name], vecs[s.name].grad) for s in specs}
        with torch.no_grad():
            if distributed:
                collectives.all_reduce_grads(grads)
                merged = {n: _gather_rows(i, g) for n, (i, g) in merged.items()}
            grad_norm = global_norm(grads + [g for _, g in merged.values()])
            updates, opt_state = tx.update([grads[i] for i in opt_index],
                                           state.opt_state, opt_params)
            torch._foreach_add_(opt_params, updates)
            for s in specs:
                rowwise_adagrad_update(
                    tables[s.name], state.embed_state[s.name][ROW_ACCUM],
                    *merged[s.name], lr=s.lr, eps=s.eps)
        _clear_grads(dense)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return train_step


def _gather_rows(ids: torch.Tensor, d_vecs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's ids ``[B, ...]`` and their vector gradients ``[B, ...,
    D]``, concatenated in rank order along the batch axis (this rank's own
    in a gang of one, where nothing moves)."""
    got = (collectives.all_gather_rows(ids), collectives.all_gather_rows(d_vecs))
    if collectives.world_size() > 1:
        make_sparse_embed_train_step.gather_bytes += sum(
            t.numel() * t.element_size() for t in got)
    return got


make_sparse_embed_train_step.gather_bytes = 0

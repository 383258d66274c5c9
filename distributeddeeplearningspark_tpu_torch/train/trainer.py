"""Trainer — the driver-side loop, the port of ``train/trainer.py``.

``Trainer(session, model, loss_fn, optimizer)`` binds a model on the
session's device to a loss and an optax-shaped optimizer
(:mod:`.optim`); :meth:`Trainer.fit` feeds batches from a
:class:`~..rdd.PartitionedDataset` through the train step and syncs with
the device only at log points, where it laps the :class:`~..metrics.Meter`,
logs, writes a ``step_metrics`` record (when ``DLS_TELEMETRY_DIR`` or the
checkpointer names a workdir) and applies the ``on_nonfinite`` policy
(by default it raises on a non-finite metric, as the JAX loop does).

``fit`` and :meth:`evaluate` feed through
:func:`~..data.prefetch.prefetch_to_device`: a background thread
assembles, pins and copies the next batches while the step runs, and a
dataset's worker pool (``num_workers``, ``DLS_DATA_WORKERS``) forks from
that thread. With telemetry on, each lap's ``step_metrics`` record carries
the :class:`~..data.prefetch.StarvationProbe`'s gauges (``input_wait_s``,
the ring's depth, the pool's ``input_workers`` and utilization) and the
lap's split from :class:`~..telemetry.anatomy.StepAnatomy` in the JAX
package's keys (``anatomy_wall_s``; ``device_s``, the host time spent in
the train step's calls and waiting at the lap's one sync; ``input_wait_s``;
``host_s``, the rest; ``compile_in_lap_s``, the first call of a new input
signature), and a ``memory`` event follows it (the allocator's watermarks,
:func:`~..telemetry.anatomy.memory_watermarks`), so ``dlstatus --anatomy``
(the port's and the JAX package's) reads it. The train step is wrapped in
the signature ledger (:func:`~..telemetry.anatomy.instrument`): the first
call of each input signature writes a ``compile`` event.

Device-side observability, the JAX ``fit``'s three options:
``measure_flops=True`` counts ``fit``'s first step under
``FlopCounterMode`` with the kernels' FLOP formulas
(:meth:`Trainer.measured_cost`, :func:`~..metrics.measured_flops_per_step`:
the count is the same on the kernel route and the plain path, and global
over the gang); it adds no step, the counted step is the first one
trained. Every lap's record then carries ``flops_per_step``,
``peak_flops_per_chip``, ``peak_source``, ``mfu`` (over the lap's wall)
and ``mfu_device`` (over its device time), and the summary ``mfu``.
``profile=ProfileSpec(dir, start_step, num_steps)`` traces a window of
steps, relative to the step ``fit`` resumed at, with ``torch.profiler``
(:mod:`..utils.profiling`); ``tensorboard_dir`` writes each logged metric
as a TensorBoard scalar on rank 0. The profiler and the writer are closed
in ``fit``'s ``finally``: a run that fails inside the window still writes
its trace.

In a data-parallel gang (a :class:`~..session.Session` launched by the
port's cli) each rank feeds its own rows of every global batch
(``batch_size`` is global, as in JAX) and the train step reduces the
gradient across ranks (:mod:`.step`); :meth:`evaluate` all-reduces each
batch's weighted sums and weights, so it is exact over ranks, the padded
tail included; :meth:`predict` gathers the outputs into JAX's feed order.
A model with BatchNorm (ResNet) takes the global batch's statistics inside
its forward (:mod:`..models.resnet`), as JAX's do over the mesh, so its
buffers move alike on every rank; ``sparse_embed`` tables merge every
rank's row gradients before the row-wise update (:mod:`.embed`), so every
rank applies the same one.

With a ``checkpointer`` (:class:`~..checkpoint.Checkpointer`),
``fit(checkpoint_every=N)`` saves the state and the feed position
(``data_state``: ``examples_seen``, ``batch_size``) every N steps and at
the end; :meth:`restore` loads the newest step that verifies, and
``fit(data_state=...)`` fast-forwards the feed past the batches already
trained on, so a resumed run repeats an uninterrupted one.

The recovery chain (the JAX package's ``tests/test_chaos.py`` runs it
link by link): ``fit(on_nonfinite="skip")`` builds the step with its
non-finite guard (:mod:`.step`) and keeps the device's running count of
skipped steps, fetched at log points only, against ``nonfinite_budget``;
``on_nonfinite="rollback"`` restores the newest verified finite checkpoint
at a log point whose metrics are not finite, up to ``max_rollbacks``
times. Recovery events go to :meth:`~..metrics.MetricLogger.event`.
``DLS_FAULT`` (:mod:`..faults`) fires at its JAX places: ``nan``,
``crash``, ``hang`` and ``die_host`` before the step they name,
``truncate_ckpt`` after a save. Each log lap, each batch :meth:`evaluate`
takes and the end of ``fit``'s last save stamp the supervisor's liveness
file (``DLS_HEARTBEAT_FILE``): a worker evaluating or saving is not hung.
``eval_every`` runs
:meth:`evaluate` inside ``fit``; ``callbacks`` see every step;
``sanitize_every`` checks the gang's replicas.

``sparse_embed`` specs (:mod:`.embed`) train their tables row-sparsely:
the step gathers the batch's rows outside autograd and applies row-wise
AdaGrad to them (in a gang, to every rank's rows, gathered), and the
optimizer state is built over the other params only, so no moment of table
size exists.

``trainable`` (a predicate over param names, e.g. ``lora_trainable``)
freezes the params it rejects: they leave autograd and the optimizer state
is built over the others (:mod:`.step`). ``accum_steps`` splits each batch
into that many micro-batches whose gradients are summed before one update
(the constructor's value, or ``fit(accum_steps=...)``). Neither goes with
``sparse_embed``, as in JAX. :meth:`load_pretrained` overlays imported
weights (``models.llama_io``) on the live params in place.

``rules`` (a :class:`~..parallel.sharding.ShardingRules`, default
``REPLICATED``) or ``plan`` (a :class:`~..parallel.plan.Plan`, which wins,
as in JAX) lay the params out over the session's mesh: with ``fsdp`` or
``tensor`` above 1 (``mesh.data=1, mesh.fsdp=-1, mesh.tensor=T``; HSDP's
``data × fsdp``) the constructor lowers them
(:func:`~..parallel.sharding.fully_shard_model`: ``tensor`` entries to
``DTensor``, ``fsdp`` entries to FSDP2) before it builds the step, and the
params the rules shard become ``DTensor`` params; the plan is validated
against the mesh first. A model on the meta device (what the Llama driver
builds) is lowered there, then ``to_empty`` on the session's device, and
``model.init_weights`` draws its weights from a generator seeded with
``seed``: each card allocates its shards only, and the weights are
bitwise those of the model built on one device and initialised from the
same seed (JAX's ``init_state`` makes the state sharded the same way).
Each rank feeds the rows of its coordinate on the batch axes (``data ×
fsdp``): ``tensor`` peers take the same rows, the step and ``evaluate``
reduce over the loss group (the batch group, and ``seq`` under context
parallelism) and ``predict`` gathers over the batch group. :meth:`init` builds the
optimizer state over the params (sharded like them),
:meth:`load_pretrained` and :meth:`restore` write whole tensors into each
rank's shards, checkpoints hold whole tensors, ``sanitize_every`` compares
each param within its replica group, and :meth:`evaluate`/:meth:`predict`
run under ``no_grad`` (FSDP2 and ``inference_mode`` do not mix,
:mod:`.step`). At ``fsdp`` and ``tensor`` 1 nothing is sharded, as in JAX
on one device.

A plan with ``zero_axes`` (``plan.zero_plan``, JAX's ZeRO weight-update
sharding) keeps the params replicated and each rank's slice of the
optimizer state (:mod:`..parallel.zero`): the step updates the slices and
gathers the params, bitwise the replicated update, and checkpoints hold
the state whole. It needs every param the optimizer updates replicated,
no pipeline and no sparse tables; a model with ``fused_head_loss`` is
refused where the rules shard its head (ROADMAP Queue 1 item 5). A param
that is not floating point (the int8 base) never trains.

``context_parallel=True`` (or a plan with a ``seq_axis``, JAX's
``Trainer(context_parallel=...)``) shards each row's sequence over the
mesh's ``seq`` axis: each rank feeds the rows of its batch coordinate and
of those the block at its ``seq`` index (:func:`~..data.feed.seq_shard`,
which first makes the next-token labels from the whole rows), for a model
whose attention takes such a block (Llama's ``attention_impl`` ``"ring"``
or ``"ulysses"``). Losses, metrics and gradients are then summed over the
loss group (``data × fsdp × seq``: :mod:`.step`), :meth:`evaluate`'s sums
too, :meth:`predict` gathers the blocks back into whole rows, and tokens/s
counts each token once. A mesh with ``seq`` above 1 without it raises:
every ``seq`` peer would take the same whole rows.

The graceful preemption drain: a preemption notice (``DLS_FAULT=sigterm@N``
for the host ``DLS_FAULT_HOST`` names, or a notice file at
``DLS_PREEMPT_NOTICE``, :func:`~..faults.read_preempt_notice`) is honoured
at the first step boundary at or past its step, after the callbacks and
before that step's checkpoint: the gang streams the state from its shards
into a handoff beside the checkpoints by the bounded live engine
(:mod:`..parallel.live_reshard`: chunks under the byte budget, no
replicated copy, what rank 0 received checked against every rank's own
blake2b digests, rank 0 writes), stamping the heartbeat at every chunk,
and only then rank 0 writes the supervisor's ``DRAIN`` evidence; ``fit`` returns with
:attr:`Trainer.preempted_at` set and saves no final checkpoint. The
supervisor shrinks the gang at once, and the relaunch's
:meth:`Trainer.restore_live_handoff` resumes from the drained step with no
walk-back. A drain that fails raises.

On a mesh with ``pipe`` above 1 (JAX's ``_apply_fn``) a Llama
(``LlamaForCausalLM``) trains through the GPipe pipeline: the constructor
converts it (:func:`~..models.llama_pp.make_pp_model`, before the
lowering: each rank keeps its stage's layers only, a model on the meta
device never allocating the others), so the train step, :meth:`evaluate`
and :meth:`predict` run the pipelined forward, with
``pipeline_microbatches`` microbatches (default: the pipe size); the rules
must carry the stage layout (``llama_rules(cfg, pipeline=True)``). Any
other model raises JAX's ``NotImplementedError``. The pipe peers take the
same rows. :meth:`load_pretrained` writes this stage's layers of a whole
tree, checkpoints hold the whole state (:mod:`..checkpoint`), and the
graceful drain refuses a pipeline (ROADMAP Queue 1 item 11).

With the comms probes on (``DLS_COMMS_PROBE=1``,
``collectives.enable_collective_probes``) and telemetry on, each log lap
takes one :func:`~..parallel.collectives.barrier_probe`: a ``collective``
event of this rank's wait for the gang, which the JAX package's
``fleet.host_table`` folds into its comms-wait column. An MoE model's
``moe_aux`` and ``moe_dropped_frac`` are metrics like any other: in the
log line and the ``step_metrics`` records.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import re
import time
from typing import Any, Callable, Iterator, Sequence

import torch

from distributeddeeplearningspark_tpu_torch import faults
from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib
from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
from distributeddeeplearningspark_tpu_torch.data.feed import (
    host_batches,
    process_shard_range,
    seq_shard,
    to_device,
)
from distributeddeeplearningspark_tpu_torch.data.prefetch import (
    StarvationProbe,
    prefetch_to_device,
)
from distributeddeeplearningspark_tpu_torch.metrics import Meter, MetricLogger
from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding
from distributeddeeplearningspark_tpu_torch.parallel import plan as plan_lib
from distributeddeeplearningspark_tpu_torch.ops import ring_attention
from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
    AXIS_SEQ,
    BATCH_AXES,
    LOSS_AXES,
)
from distributeddeeplearningspark_tpu_torch.parallel.sharding import (
    REPLICATED,
    ShardingRules,
)
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_EXPERT, AXIS_PIPE
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import Session
from distributeddeeplearningspark_tpu_torch.telemetry import anatomy as anatomy_lib
from distributeddeeplearningspark_tpu_torch.train import embed as embed_lib
from distributeddeeplearningspark_tpu_torch.train import step as step_lib
from distributeddeeplearningspark_tpu_torch.train.fused_ce import (
    is_fused_output,
    materialize_logits,
)
from distributeddeeplearningspark_tpu_torch.train.optim import GradientTransformation
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from distributeddeeplearningspark_tpu_torch.utils import profiling, sanitize

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.trainer")


def _touch_heartbeat() -> None:
    """Stamp the supervisor's liveness file (``DLS_HEARTBEAT_FILE``, set by
    :class:`~..supervisor.Supervisor`) at a log lap, an evaluated batch and
    the end of ``fit``'s last save: progress between checkpoints is then
    visible to its hang watchdog, and a stuck worker stops stamping."""
    path = os.environ.get("DLS_HEARTBEAT_FILE")
    if not path:
        return
    try:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
    except OSError:  # heartbeats are best-effort, never fail training
        pass


def _to_host(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Device metrics → floats with one copy (one sync)."""
    if not metrics:
        return {}
    vals = torch.stack([torch.as_tensor(v).float().reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _mapped(fn: Callable, it: Iterator) -> Iterator:
    """``fn`` of each of ``it``; closing this closes ``it``."""
    try:
        for x in it:
            yield fn(x)
    finally:
        it.close()


def _skip(it: Iterator, n: int) -> Iterator:
    """``it`` past its first ``n`` items; closing this closes ``it``."""
    for _ in range(n):
        if next(it, None) is None:
            return
    yield from it


def _overlay(live: dict[str, torch.Tensor], new: dict[str, Any], what: str
             ) -> None:
    """Copy each of ``new`` into ``live``'s tensor of its name, in place,
    cast to its dtype (into its shard where it is sharded: each rank keeps
    its part of the whole, no collective), after checking every shape."""
    for k, v in new.items():
        if tuple(v.shape) != tuple(live[k].shape):
            raise ValueError(f"{what} {k}: shape {tuple(v.shape)} != model "
                             f"{tuple(live[k].shape)}")
    for k, t in live.items():
        if k in new:
            sharding.assign(t, new[k])


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


class Trainer:
    """Bind (session, model, loss, optimizer) into a train loop.

    ``model(batch, generator=g)`` returns the outputs consumed by
    ``loss_fn(outputs, batch) → (loss, metrics)``; its params must lie on
    the session's device. ``seed`` seeds the generator the dropout masks
    are drawn from (the weights come from the model's own seed).
    ``sparse_embed``: :class:`~.embed.SparseEmbedSpec` s of the tables that
    train row-sparsely (``models.dlrm.sparse_embed_specs``); the model then
    takes ``overrides`` in train mode. ``checkpointer``: where ``fit``
    saves and :meth:`restore` reads. ``accum_steps``: micro-batches per
    optimizer step. ``trainable``: the params that train (None: all); pass
    the predicate the optimizer is ``masked`` with. ``rules``/``plan``:
    the params' layout over the session's mesh (the module docstring).
    ``context_parallel``: shard each row's sequence over ``seq``.
    ``pipeline_microbatches``: the GPipe schedule's microbatches on a
    ``pipe`` mesh (None: the pipe size). A
    model on the meta device needs an ``init_weights(generator)`` that
    sets every param and buffer; its weights are drawn from ``seed``."""

    def __init__(self, session: Session | None, model: torch.nn.Module,
                 loss_fn: Callable, optimizer: GradientTransformation, *,
                 rules: ShardingRules = REPLICATED,
                 plan: plan_lib.Plan | None = None,
                 seed: int = 0,
                 sparse_embed: Sequence[embed_lib.SparseEmbedSpec] = (),
                 checkpointer: Checkpointer | None = None,
                 accum_steps: int = 1,
                 trainable: Callable[[str], bool] | None = None,
                 context_parallel: bool = False,
                 pipeline_microbatches: int | None = None):
        self.session = session or Session.get_or_default()
        self.device = self.session.device
        # a model on the meta device is materialised below, if it can draw
        # its weights
        on_meta = any(p.is_meta for p in model.parameters())
        wrong = {str(p.device) for p in model.parameters() if p.device != self.device
                 and not (p.is_meta and hasattr(model, "init_weights"))}
        if wrong:
            raise ValueError(f"model params lie on {sorted(wrong)}, the "
                             f"session's device is {self.device}")
        # one Plan carries the layout: an explicit plan wins, else the rules
        # are wrapped in one (JAX's precedence)
        if plan is not None:
            rules = plan.rules
            context_parallel = context_parallel or plan.seq_sharded
            if plan.model_hints:
                logger.warning(
                    "plan %r carries model hints %s: apply them to the model "
                    "config yourself; the plan layer cannot rebuild the model",
                    plan.name, plan.hints())
        self.plan = plan if plan is not None else plan_lib.plan_for_rules(
            rules, context_parallel=context_parallel)
        self.plan.validate(self.session.mesh)
        #: each row's sequence sharded over the mesh's ``seq`` axis
        self.context_parallel = context_parallel
        if self.session.mesh.shape[AXIS_SEQ] > 1 and not context_parallel:
            raise ValueError(
                f"mesh {self.session.mesh.shape} has seq > 1: pass "
                f"context_parallel=True (or a plan with seq_axis), or every "
                f"seq peer trains on the same whole rows")
        if context_parallel:
            ring_attention.set_default_mesh(self.session.mesh)
        self.model = model
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.seed = seed
        self.checkpointer = checkpointer
        self.state: TrainState | None = None
        self.sparse_embed = tuple(sparse_embed)
        names = dict(model.named_parameters())
        missing = [s.param_path for s in self.sparse_embed if s.param_path not in names]
        if missing:
            raise ValueError(f"sparse_embed tables {missing} are not params of "
                             f"the model")
        if self.sparse_embed and accum_steps != 1:
            raise ValueError("accum_steps is not supported with sparse_embed")
        if self.sparse_embed and trainable is not None:
            raise ValueError(
                "trainable is not supported with sparse_embed: the sparse "
                "step already keeps tables out of autodiff, and silently "
                "ignoring the predicate for other params would skip the "
                "frozen-weight exclusion the caller asked for")
        if sparse_embed and sharding.shard_dims(model, rules, self.session.mesh):
            raise NotImplementedError(
                "sharded params with sparse_embed tables (the expert-sharded "
                "DLRM table) are not ported yet: ROADMAP Queue 1 item 5")
        if getattr(getattr(model, "cfg", None), "fused_head_loss", False):
            mesh = self.session.mesh
            if "lm_head.weight" in {*sharding.tensor_dims(model, rules, mesh),
                                    *sharding.shard_dims(model, rules, mesh)}:
                raise NotImplementedError(
                    "fused_head_loss with the head's weight sharded (fsdp or "
                    "tensor): the fused loss reads the whole weight after the "
                    "forward; not ported yet: ROADMAP Queue 1 item 5")
        if self.plan.zero_axes and (sparse_embed or self.session.mesh.shape[AXIS_PIPE] > 1):
            raise NotImplementedError(
                f"plan {self.plan.name!r}: zero_axes with sparse_embed tables or on "
                f"a pipeline: not ported yet: ROADMAP Queue 1 item 5")
        self.accum_steps = accum_steps
        self.trainable = trainable
        self.pipeline_microbatches = pipeline_microbatches
        #: the whole model's param names on a pipeline (None: no pipeline)
        self._whole_names = self._pipeline(model, rules)
        #: the params the rules split over tensor: name → dim (empty: none)
        self.tensor_dims = sharding.tensor_dims(model, rules, self.session.mesh)
        #: the params the rules split over expert: name → dim (empty: none)
        self.expert_dims = sharding.expert_dims(model, rules, self.session.mesh)
        #: the params the rules shard over fsdp: name → dim (empty: none)
        self.shard_dims = sharding.fully_shard_model(model, rules, self.session.mesh)
        if on_meta:
            model.to_empty(device=self.device)
            model.init_weights(torch.Generator(self.device).manual_seed(seed))
        if self._whole_names is not None:
            stage = self.session.mesh.pipe_index
            for n, p in model.named_parameters():
                if rules.stage_of(sharding.path_str(n), self.session.mesh) is not None:
                    sharding.mark_stage(p, stage)
        #: the ZeRO layout of the optimizer state (None: a plan without
        #: ``zero_axes``)
        self.zero = None
        if self.plan.zero_axes:
            from distributeddeeplearningspark_tpu_torch.parallel.zero import ZeroLayout

            params = dict(model.named_parameters())
            self.zero = ZeroLayout(self.plan, self.session.mesh,
                                   [params[n] for n in self._optimizer_names(params)])
        self._guard_nonfinite = False  # fit(on_nonfinite="skip") rebuilds
        #: the step a graceful preemption drain ended ``fit`` at (None: not
        #: drained); a drained driver exits 0 and writes no final artefacts
        self.preempted_at: int | None = None
        self._build_train_step()
        self._eval_step = step_lib.make_eval_step(model, loss_fn)

    def _pipeline(self, model: torch.nn.Module, rules: ShardingRules
                  ) -> list[str] | None:
        """On a ``pipe`` mesh, convert the model to its pipelined forward
        (JAX's ``_apply_fn``); the whole model's param names, None without
        a pipeline."""
        mesh = self.session.mesh
        if mesh.shape[AXIS_PIPE] <= 1:
            return None
        from distributeddeeplearningspark_tpu_torch.models import llama_pp
        from distributeddeeplearningspark_tpu_torch.models.llama import LlamaForCausalLM

        if not isinstance(model, LlamaForCausalLM):
            raise NotImplementedError(
                f"mesh has pipe={mesh.shape[AXIS_PIPE]} but "
                f"{type(model).__name__} has no pipeline-parallel forward — "
                f"use a pipe=1 mesh or a pipeline-capable model (Llama)")
        if rules.stage_pattern is None:
            raise ValueError(
                f"mesh has pipe={mesh.shape[AXIS_PIPE]}: the rules must lay the "
                f"layers out by stage (llama_rules(cfg, pipeline=True))")
        whole = llama_pp.whole_param_names(model.cfg)
        llama_pp.make_pp_model(model, mesh, self.pipeline_microbatches)
        return whole

    def _build_train_step(self) -> None:
        if self.sparse_embed:
            step = embed_lib.make_sparse_embed_train_step(
                self.model, self.tx, self.loss_fn, self.sparse_embed,
                distributed=self.session.distributed)
        else:
            step = step_lib.make_train_step(
                self.model, self.tx, self.loss_fn,
                distributed=self.session.distributed, trainable=self.trainable,
                accum_steps=self.accum_steps,
                guard_nonfinite=self._guard_nonfinite, mesh=self.session.mesh,
                zero=self.zero)
        # the signature ledger: a new input signature is the eager step's
        # "compile", one telemetry event each (telemetry/anatomy.py)
        self._train_step = anatomy_lib.instrument(
            step, name="train_step", plan=self.plan, device=self.device)

    def init(self) -> TrainState:
        """The initial state: the model's params, the optimizer's state
        (over the params that train, are not sparse tables and pass the
        optimizer's mask), the dropout generator seeded from ``seed``, the
        model's buffers (BatchNorm statistics) and the sparse tables' zero
        row accumulators."""
        params = dict(self.model.named_parameters())
        trains = (embed_lib.dense_trainable(self.sparse_embed)
                  if self.sparse_embed else self.trainable)
        names = self._optimizer_names(params)
        pipe = None
        if self._whole_names is not None:
            from distributeddeeplearningspark_tpu_torch.parallel.pipeline import (
                PipeGroup,
                StageState,
            )

            pipe = StageState(PipeGroup.of(self.session.mesh), tuple(names), tuple(
                step_lib.optimizer_params(self._whole_names, self.tx, trains)))
        opt_params = [params[n] for n in names]
        self.state = TrainState(
            step=0, params=params,
            opt_state=(self.tx.init(opt_params) if self.zero is None
                       else self.zero.init(self.tx, opt_params)),
            generator=torch.Generator(self.device).manual_seed(self.seed),
            mutable=dict(self.model.named_buffers()),
            embed_state=embed_lib.init_embed_state(self.sparse_embed, params),
            pipe=pipe)
        logger.info("initialized %s params on %s",
                    f"{self.state.num_params:,}", self.device)
        return self.state

    def _optimizer_names(self, params: dict[str, torch.Tensor]) -> list[str]:
        """The names of the params the optimizer updates, in order: those
        that train (not sparse tables), pass its mask and are floating
        point (the int8 base never trains)."""
        trains = (embed_lib.dense_trainable(self.sparse_embed)
                  if self.sparse_embed else self.trainable)
        return [n for n in step_lib.optimizer_params(params, self.tx, trains)
                if params[n].is_floating_point()]

    def load_pretrained(self, params: dict[str, Any], *,
                        batch_stats: dict[str, Any] | None = None,
                        strict: bool = False,
                        allow_uncovered: Sequence[str] = ("lora_",)) -> TrainState:
        """Overlay imported weights (e.g. ``models.llama_io``'s
        ``load_llama_safetensors``) on the state, in place.

        ``params`` maps param names (``named_parameters()``'s) to tensors or
        numpy arrays of the params' shapes; each is cast to its param's
        dtype and copied onto its device. Params absent from ``params``
        keep their values. With ``strict``, both names that are not params
        and params ``params`` does not cover (except those matching a
        pattern of ``allow_uncovered``, by default the LoRA adapters)
        raise; without, each kind is logged as a warning. On a pipeline
        ``params`` is the whole model's tree: the layers other stages hold
        are theirs, neither extra nor written here. ``batch_stats``:
        the model's buffers (BatchNorm's running statistics) by name,
        overlaid the same way."""
        if self.state is None:
            raise RuntimeError("call init() before load_pretrained()")
        live = self.state.params
        seen = set(params) & set(live)
        extra = set(params) - (set(live) if self._whole_names is None
                               else set(self._whole_names))
        uncovered = {k for k in set(live) - seen
                     if not any(re.search(pat, k) for pat in allow_uncovered)}
        if strict and (extra or uncovered):
            raise ValueError(
                f"pretrained overlay mismatch: extra keys {sorted(extra)[:4]}, "
                f"uncovered model params {sorted(uncovered)[:4]}")
        if extra:
            logger.warning("ignored %d pretrained keys not in model", len(extra))
        if uncovered:
            logger.warning("%d model params not covered by pretrained overlay "
                           "(e.g. %s)", len(uncovered), sorted(uncovered)[:3])
        _overlay(live, {k: params[k] for k in seen}, "pretrained")
        if batch_stats is not None:
            if not self.state.mutable:
                raise ValueError("batch_stats given but the model has no "
                                 "buffers (BatchNorm statistics)")
            _overlay(self.state.mutable, {k: v for k, v in batch_stats.items()
                                          if k in self.state.mutable},
                     "batch_stats")
        return self.state

    def restore(self, checkpointer: Checkpointer | None = None, *,
                step: int | None = None) -> tuple[TrainState, dict | None]:
        """Restore ``(state, data_state)`` from a checkpoint (by default the
        newest step that verifies) into this trainer's state, initialising
        it first if needed. Pass ``data_state`` on to :meth:`fit`."""
        ckpt = checkpointer or self.checkpointer
        if ckpt is None:
            raise RuntimeError("Trainer.restore: no checkpointer configured — "
                               "pass one to the constructor or to restore()")
        # bind the run's telemetry first, so the restore's phases land in it
        self._telemetry(ckpt)
        if self.state is None:
            self.init()
        self.state, data_state = ckpt.restore(self.state, step=step)
        logger.info("resumed at step %d", self.state.step)
        return self.state, data_state

    def restore_live_handoff(self, checkpointer: Checkpointer | None = None
                             ) -> tuple[TrainState, dict | None]:
        """Resume from a graceful drain's live handoff: the drained step,
        not the last checkpoint (no walk-back). Every rank reads and
        digest-checks the handoff beside the checkpoints and writes it into
        this trainer's layout (initialising the state first if needed); then
        the handoff is consumed. Returns ``(state, data_state)`` like
        :meth:`restore`. Raises
        :class:`~..parallel.live_reshard.HandoffError` on any mismatch: the
        caller walks back through the checkpoint."""
        from distributeddeeplearningspark_tpu_torch.parallel import live_reshard

        ckpt = checkpointer or self.checkpointer
        if ckpt is None:
            raise RuntimeError("Trainer.restore_live_handoff: no checkpointer "
                               "configured — the handoff lives in its directory")
        if self._whole_names is not None:
            raise live_reshard.HandoffError(
                "a live handoff into a pipeline is not ported (ROADMAP Queue 1 "
                "item 11): walk back through the checkpoint")
        self._telemetry(ckpt)
        if self.state is None:
            self.init()
        _touch_heartbeat()  # the ingest stamps it at every leaf from here
        t0 = time.perf_counter()
        with telemetry_lib.phase("restore", source="live-handoff"):
            self.state, manifest = live_reshard.load_handoff(
                ckpt.directory, self.state, progress=_touch_heartbeat)
        nbytes = sum(math.prod(r["shape"]) * (
            8 if r["dtype"] == live_reshard.INT_DTYPE
            else getattr(torch, r["dtype"]).itemsize) for r in manifest["leaves"])
        stats = live_reshard.TransferStats(
            leaves=len(manifest["leaves"]), leaves_moved=len(manifest["leaves"]),
            bytes_total=nbytes, bytes_moved=nbytes,
            mem_budget_bytes=live_reshard.memory_budget_bytes(),
            wall_s=time.perf_counter() - t0, verified=True)
        step = int(manifest["step"])
        live_reshard.emit_reshard_event(
            stats, step=step, transport="handoff", walk_back=False,
            reason="preemption-resume")
        collectives.barrier()  # every rank has ingested it
        if collectives.rank() == 0:
            live_reshard.clear_handoff(ckpt.directory)
        logger.info("resumed from the live handoff at step %d (%.1f MiB, %.2fs; "
                    "checkpoint-free, no walk-back)", step, nbytes / 2**20,
                    stats.wall_s)
        return self.state, manifest.get("data_state")

    def _graceful_drain(self, step: int, *, examples_seen: int,
                        batch_size: int, doomed: int) -> None:
        """Honour a preemption notice naming host ``doomed``: the step in
        flight is finished, the gang streams every leaf of the state from
        its shards into the handoff (bounded, verified against each rank's
        own digests; rank 0 writes), and after its barrier the ``DRAIN``
        evidence is written last, so the supervisor only ever sees evidence
        an ingestible handoff backs. Every chunk stamps the heartbeat, so a
        long drain is not taken for a hang. A hard kill (``die_host``)
        never gets here: it walks back through the checkpoint."""
        from distributeddeeplearningspark_tpu_torch import supervisor as sup_lib
        from distributeddeeplearningspark_tpu_torch.parallel import live_reshard

        if self._whole_names is not None:
            raise NotImplementedError(
                "the graceful preemption drain of a pipeline is not ported: "
                "the live engine does not carry stage-owned params whole "
                "(ROADMAP Queue 1 item 11)")
        if self.checkpointer is None:
            raise RuntimeError(
                "graceful preemption drain needs a checkpointer: its "
                "directory carries the live handoff the shrunk gang resumes "
                "from")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the step in flight
        saving: dict[str, float] = {}
        stats = live_reshard.save_handoff(
            self.checkpointer.directory, step,
            live_reshard.flatten(self.state.state_dict()),
            data_state={"examples_seen": examples_seen, "batch_size": batch_size},
            timings=saving, progress=_touch_heartbeat)
        live_reshard.emit_reshard_event(
            stats, step=step, transport="collectives", walk_back=False,
            reason="preemption-drain", dead_host=doomed,
            **{f"save_{k}": round(v, 4) for k, v in saving.items()})
        if collectives.rank() == 0:
            sup_lib.write_drain_evidence(self.checkpointer.directory,
                                         host=doomed, step=step)
        self.preempted_at = step
        logger.warning(
            "graceful drain at step %d: host %d preempted — live handoff "
            "committed (%d leaves, %.1f MiB gathered in %d round(s), %.2fs); "
            "exiting clean for the supervisor to shrink without walk-back",
            step, doomed, stats.leaves, stats.bytes_moved / 2**20, stats.rounds,
            stats.wall_s)

    def _telemetry(self, checkpointer: Checkpointer | None = None
                   ) -> telemetry_lib.EventWriter | None:
        """The run's event writer: ``DLS_TELEMETRY_DIR``, else the
        checkpointer's directory, else None (then fit costs nothing
        extra). Binds the process-wide writer, which the checkpointer's
        phases go through."""
        workdir = os.environ.get(telemetry_lib.WORKDIR_ENV)
        ckpt = checkpointer or self.checkpointer
        if not workdir and ckpt is not None:
            workdir = ckpt.directory
        return telemetry_lib.configure(workdir) if workdir else None

    def _shard_range(self) -> tuple[int, int] | None:
        """This rank's data shards: those of its coordinate on the batch
        axes (its ``tensor`` peers take the same)."""
        n = self.session.default_parallelism
        return process_shard_range(
            n, rank=self.session.mesh.batch_index(self.session.rank), world_size=n)

    def _seq_shard(self, batch: dict) -> dict:
        """This rank's block of each row's sequence under context
        parallelism (the batch itself otherwise)."""
        if not self.context_parallel:
            return batch
        mesh = self.session.mesh
        return seq_shard(batch, mesh.seq_index, mesh.shape[AXIS_SEQ])

    def _host_feed(self, dataset: PartitionedDataset, batch_size: int,
                   whole_rows: bool = False, **kw) -> Iterator[dict]:
        """This rank's rows of each global batch (JAX's shard mapping), and
        of those its block of the sequence unless ``whole_rows``."""
        batches = host_batches(dataset, batch_size,
                               num_shards=self.session.default_parallelism,
                               shard_range=self._shard_range(), **kw)
        if whole_rows or not self.context_parallel:
            return batches
        return _mapped(self._seq_shard, batches)

    def _feed(self, dataset: PartitionedDataset, batch_size: int, *,
              skip_batches: int = 0, probe: StarvationProbe | None = None
              ) -> Iterator[dict[str, torch.Tensor]]:
        """This rank's batches on the device, prefetched in a background
        thread. ``skip_batches`` (resume) burns host batches there, with no
        copy to the device."""
        hb = self._host_feed(dataset, batch_size)
        if skip_batches:
            hb = _skip(hb, skip_batches)
        return prefetch_to_device(hb, self.device, probe=probe)

    def fit(self, dataset: PartitionedDataset, *, batch_size: int,
            steps: int | None = None, tokens_per_example: int = 0,
            log_every: int = 10, checkpoint_every: int | None = None,
            eval_dataset: PartitionedDataset | None = None,
            eval_every: int | None = None,
            callbacks: Sequence[Callable[[int, dict], None]] = (),
            data_state: dict | None = None,
            sanitize_every: int | None = None,
            profile: profiling.ProfileSpec | None = None,
            measure_flops: bool = False,
            tensorboard_dir: str | None = None,
            accum_steps: int | None = None, on_nonfinite: str = "raise",
            nonfinite_budget: int = 10, max_rollbacks: int = 2
            ) -> tuple[TrainState, dict[str, float]]:
        """Train until the state's step reaches ``steps`` (or the dataset is
        exhausted). Returns (final state, summary): the :class:`Meter`'s
        summary (``step_time_ms``, ``examples_per_sec_per_chip`` — images/s
        for a vision model —, ``tokens_per_sec_per_chip`` when
        ``tokens_per_example`` is given, ...) and the last logged metrics.

        ``checkpoint_every``: save every N steps and at the end (needs a
        checkpointer). ``data_state`` (from :meth:`restore`): skip the
        ``examples_seen`` the checkpoint had trained on. ``accum_steps``:
        micro-batches per optimizer step (``batch_size`` stays the global
        batch), overriding the constructor's. ``eval_dataset`` /
        ``eval_every``: :meth:`evaluate` every N steps inside an ``eval``
        telemetry phase, logged as ``eval_*``. ``callbacks``: each called
        as ``cb(step, last_logged_metrics)`` after every step.
        ``sanitize_every``: check every N steps that the gang's params are
        in sync (:func:`~..utils.sanitize.assert_replicas_in_sync`).
        ``profile``: trace that window of steps (relative to the step this
        call starts at). ``measure_flops``: count the first step's FLOPs
        (:meth:`measured_cost`) for the laps' MFU. ``tensorboard_dir``: the
        logged metrics as TensorBoard scalars (rank 0).

        ``on_nonfinite``, the policy for NaN/Inf metrics, read at log points:

        - ``"raise"`` (default): ``FloatingPointError``;
        - ``"skip"``: the step itself withholds the update of a step whose
          gradient is not finite (:mod:`.step`'s guard: params, optimizer
          state and buffers keep their values, the poisoned batch is
          consumed); at most ``nonfinite_budget`` steps may be skipped.
          The summary reports ``skipped_steps``;
        - ``"rollback"``: reload the newest verified checkpoint whose params
          are finite (quarantining one that is not) and go on from the
          feed's current position — the model rewinds, the feed does not,
          and the batches passed over are folded into every later
          checkpoint's ``examples_seen``. Needs a checkpointer with a saved
          step; at most ``max_rollbacks``. The summary reports
          ``rollbacks``.

        ``DLS_FAULT`` (:mod:`..faults`) injects ``nan``, ``crash``, ``hang``
        and ``die_host`` at its step and ``truncate_ckpt`` after a save. A
        ``sigterm`` fault or a preemption notice (``DLS_PREEMPT_NOTICE``)
        drains at the first step boundary at or past its step (the module
        docstring) and returns with :attr:`preempted_at` set."""
        if on_nonfinite not in ("raise", "skip", "rollback"):
            raise ValueError(
                f"on_nonfinite must be 'raise'|'skip'|'rollback', got "
                f"{on_nonfinite!r}")
        if on_nonfinite == "skip" and self.sparse_embed:
            raise ValueError(
                "on_nonfinite='skip' is not supported with sparse_embed "
                "tables (the row-sparse step has no update guard); use "
                "'rollback' or 'raise'")
        rebuild = False
        if (on_nonfinite == "skip") != self._guard_nonfinite:
            self._guard_nonfinite = on_nonfinite == "skip"
            rebuild = True
        if accum_steps is not None and accum_steps != self.accum_steps:
            if self.sparse_embed:
                raise ValueError(
                    "accum_steps is not supported with sparse_embed tables "
                    "(train/embed.py) — recommender batches are already large; "
                    "scale batch_size instead")
            self.accum_steps = accum_steps
            rebuild = True
        if rebuild:
            self._build_train_step()
        if batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size {batch_size} must divide by accum_steps "
                f"{self.accum_steps}")
        if measure_flops and self.session.mesh.shape[AXIS_EXPERT] > 1:
            raise NotImplementedError(
                "measure_flops with expert > 1: each expert peer repeats the "
                "dense layers on the same rows, and counting them once there "
                "is not ported")
        if self.state is None:
            self.init()
        meter = Meter(examples_per_step=batch_size,
                      tokens_per_step=batch_size * tokens_per_example,
                      num_chips=self.session.num_devices, device=self.device)
        tele = self._telemetry()
        # the lap's device/host/input split: the instrumented step reports
        # each call's seconds into it, the lap's sync drains into it
        anat = anatomy_lib.StepAnatomy(device=self.device) if tele is not None else None
        self._train_step.attach_anatomy(anat)
        mlog = MetricLogger(telemetry=tele, tensorboard_dir=tensorboard_dir)
        step_i = self.state.step
        skip = 0
        if data_state and data_state.get("examples_seen"):
            stored_bs = data_state.get("batch_size")
            if stored_bs is not None and int(stored_bs) != batch_size:
                raise ValueError(
                    f"resume batch_size mismatch: checkpoint was written with "
                    f"batch_size={int(stored_bs)}, fit() called with "
                    f"{batch_size} — the examples_seen fast-forward would "
                    f"land mid-batch; resume with the original batch size")
            skip = int(data_state["examples_seen"]) // batch_size
        ckpt = self.checkpointer if checkpoint_every else None
        # batches the feed consumed beyond step_i (a rollback rewinds the
        # model, never the feed), folded into examples_seen so that a resume
        # lands on the feed's true position; a resumed run inherits the
        # earlier run's (the skip beyond state.step is that drift)
        rolled_back_batches = max(0, skip - step_i)

        def save(at: int) -> None:
            ckpt.save(at, self.state, data_state={
                "examples_seen": (at + rolled_back_batches) * batch_size,
                "batch_size": batch_size})

        def tele_phase(name: str):
            return (tele.phase(name) if tele is not None
                    else contextlib.nullcontext())

        # drivers launched some other way than through the supervisor's
        # workers: on a relaunch, a die_host target must not train
        faults.die_if_dead_host_on_relaunch()
        fault = faults.get()
        # the preemption notice is scoped out of get(): every rank takes part
        # in the drain, whichever host is leaving. The notice file's step
        # floor is how the ranks agree on one drain step.
        preempt = faults.sigterm_fault()
        notice_path = faults.preempt_notice_path()
        self.preempted_at = None
        skipped_dev = None  # the device's running count of skipped steps
        n_skipped = 0
        rollbacks = 0
        probe = StarvationProbe() if tele is not None else None
        if tele is not None:
            tele.emit("phase", name="run", edge="begin", step=step_i,
                      attempt=int(os.environ.get("DLS_RESTART", "0") or 0))
            tele.heartbeat(step=step_i)
        # opt-in gang-barrier latency, one sample a log lap (a scalar
        # all-reduce timed on the host): in a straggling gang every healthy
        # rank's sample grows by the straggler's lag, the fleet table's
        # comms-wait column (DLS_COMMS_PROBE=1)
        comms_probe = tele is not None and collectives.collective_probes_enabled()
        # the window is relative to this call's first step; stop() syncs the
        # card first, so the trace holds the window's kernels
        profiler = profiling.StepProfiler(
            profile, start_offset=step_i, device=self.device,
            sync=(lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None)
        flops_pending = measure_flops
        feed = self._feed(dataset, batch_size, skip_batches=skip, probe=probe)
        meter.start()
        if anat is not None:
            anat.reset(now=meter.last_time)  # the meter's start
        lap_start = step_i
        last_metrics: dict[str, float] = {}
        got_batch = False
        try:
            for batch in feed:
                got_batch = True
                if steps is not None and step_i >= steps:
                    break
                if fault is not None and step_i + 1 == fault.step \
                        and fault.kind in ("nan", "crash", "hang", "die_host"):
                    kind = fault.kind
                    # one-shot: a rollback rewinds step_i past the trigger,
                    # and re-poisoning the retrained window would turn one
                    # injected spike into a loop
                    fault = None
                    if kind == "nan":
                        batch = faults.nan_batch(batch)
                    elif kind in ("crash", "die_host"):
                        faults.crash()
                    else:
                        faults.hang()
                profiler.observe(step_i)
                with (profiling.step_annotation(step_i) if profile is not None
                      else contextlib.nullcontext()):
                    if flops_pending:
                        # the first step, counted: it is trained, not extra
                        (self.state, metrics), _ = self._train_step.prepare(
                            self.state, batch)
                        flops_pending = False
                        meter.set_flops(self._train_step.flops_per_step)
                    else:
                        self.state, metrics = self._train_step(self.state, batch)
                metrics.pop("weight", None)  # eval-aggregation detail
                step_i += 1
                if "skipped" in metrics:
                    # a device-side add a step; fetched only at log points
                    s = metrics["skipped"]
                    skipped_dev = s if skipped_dev is None else skipped_dev + s
                if step_i % log_every == 0 or (steps is not None and step_i >= steps):
                    # the copy to the host waits for this step: the lap
                    # boundary is a true sync point, so the timing is honest
                    with (anat.drain() if anat is not None
                          else contextlib.nullcontext()):
                        fetched = _to_host(metrics)
                    last_metrics = meter.lap(step_i - lap_start, fetched)
                    lap_start = step_i
                    lap_s, lap_n = meter.last_lap or (0.0, 0)
                    if tele is not None:
                        snap = probe.snapshot()
                        # the anatomy lap closes at the meter's lap
                        anat_rec = anat.lap(
                            steps=lap_n, input_wait_s=snap["input_wait_s"],
                            flops_per_step=self._train_step.flops_per_step,
                            num_chips=self.session.num_devices, now=meter.last_time)
                    mlog.log(step_i, {**last_metrics, **meter.summary()})
                    _touch_heartbeat()
                    if tele is not None:
                        tele.step_metrics(
                            step_i, steps=lap_n, lap_s=lap_s, metrics=last_metrics,
                            **snap, **anat_rec)
                        tele.emit("memory", **anatomy_lib.memory_watermarks(self.device))
                        tele.heartbeat(step=step_i)
                        if comms_probe:
                            collectives.barrier_probe(self.session.mesh)
                    if on_nonfinite == "raise":
                        sanitize.assert_all_finite(last_metrics, step=step_i)
                    elif on_nonfinite == "skip":
                        if skipped_dev is not None:
                            new_skipped = int(skipped_dev)
                            if new_skipped > n_skipped:
                                mlog.event(step_i, "skip", skipped_steps=new_skipped,
                                           nonfinite=sanitize.nonfinite_metrics(
                                               last_metrics))
                            n_skipped = new_skipped
                            if n_skipped > nonfinite_budget:
                                raise FloatingPointError(
                                    f"skipped {n_skipped} non-finite steps, "
                                    f"over nonfinite_budget={nonfinite_budget} "
                                    f"— this divergence is persistent, not a "
                                    f"transient spike; last metrics: "
                                    f"{last_metrics}")
                    else:
                        bad = sanitize.nonfinite_metrics(last_metrics)
                        if bad:
                            rollbacks += 1
                            rolled_to = self._roll_back(step_i, bad, rollbacks,
                                                        max_rollbacks)
                            mlog.event(step_i, "rollback", to_step=rolled_to,
                                       window=step_i - rolled_to, nonfinite=bad)
                            rolled_back_batches += step_i - rolled_to
                            step_i = lap_start = rolled_to
                            last_metrics = {}
                            continue
                if sanitize_every and step_i % sanitize_every == 0:
                    sanitize.assert_replicas_in_sync(self.state.params)
                for cb in callbacks:
                    cb(step_i, last_metrics)
                doomed = None
                if preempt is not None and step_i >= preempt.step:
                    doomed = faults.fault_host()
                elif notice_path is not None:
                    notice = faults.read_preempt_notice(notice_path)
                    if notice is not None and step_i >= notice.step:
                        doomed = notice.host
                if doomed is not None:
                    # drained before this step's checkpoint: the resume
                    # point is this step
                    self._graceful_drain(
                        step_i, examples_seen=(step_i + rolled_back_batches)
                        * batch_size, batch_size=batch_size, doomed=doomed)
                    break
                if ckpt is not None and step_i % checkpoint_every == 0:
                    save(step_i)
                    if (fault is not None and fault.kind == "truncate_ckpt"
                            and step_i >= fault.step):
                        # the kill-mid-finalize drill: the save committed and
                        # manifested, its bytes torn, then death unannounced
                        ckpt.wait()
                        faults.truncate_latest_checkpoint(ckpt.directory)
                        faults.crash()
                if eval_every and eval_dataset is not None and step_i % eval_every == 0:
                    with tele_phase("eval"):
                        emetrics = self.evaluate(eval_dataset, batch_size=batch_size)
                    mlog.log(step_i, {f"eval_{k}": v for k, v in emetrics.items()})
        finally:
            # the trace and the writer are flushed on every exit: the window
            # of a run that failed is the one wanted most
            feed.close()
            profiler.stop()
            self._train_step.attach_anatomy(None)
            if tele is not None:
                tele.emit("phase", name="run", edge="end", step=step_i)
            mlog.close()
        if skip and not got_batch:
            raise RuntimeError(
                f"resume fast-forward consumed the whole dataset: skipping "
                f"{skip} batches (examples_seen="
                f"{int(data_state['examples_seen'])}) exhausted the feed "
                f"before the first post-resume step — pass a .repeat() "
                f"dataset or fewer epochs-already-trained")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        summary = {**meter.summary(), **last_metrics}
        if on_nonfinite == "skip":
            if skipped_dev is not None:
                n_skipped = int(skipped_dev)
            summary["skipped_steps"] = float(n_skipped)
            if n_skipped:
                logger.warning("run skipped %d non-finite step(s) "
                               "(on_nonfinite='skip')", n_skipped)
        elif on_nonfinite == "rollback":
            summary["rollbacks"] = float(rollbacks)
        if ckpt is not None:
            # a drained run committed its handoff: a final checkpoint would
            # move the walk-back point past it
            if self.preempted_at is None and step_i % checkpoint_every:
                save(step_i)
            ckpt.wait()
            _touch_heartbeat()
        # the laps are closed: wait for the window's device-time budget line
        profiler.join_breakdown()
        return self.state, summary

    def measured_cost(self, batch: dict[str, torch.Tensor]) -> float | None:
        """FLOPs per step, global over the gang, counted over one real train
        step on ``batch`` (on the session's device): the counterpart of the
        JAX ``compiled_cost``. An eager step is costed only by running it,
        so the state advances by this step (``fit(measure_flops=True)``
        trains its first step here). The count is route-independent
        (:func:`~..metrics.measured_flops_per_step`)."""
        if self.state is None:
            self.init()
        (self.state, _), rec = self._train_step.prepare(self.state, batch)
        return rec["flops"]

    def _roll_back(self, step_i: int, bad: dict, rollbacks: int,
                   max_rollbacks: int) -> int:
        """Restore the newest verified checkpoint whose params are finite,
        quarantining each byte-intact but non-finite one on the way (a
        divergence checkpointed before a log point could see it); the step
        it restored. Raises FloatingPointError past ``max_rollbacks``,
        without a checkpointer, or when no step is left."""
        if rollbacks > max_rollbacks:
            raise FloatingPointError(
                f"non-finite metrics at step {step_i} after exhausting "
                f"max_rollbacks={max_rollbacks}: {bad}")
        if self.checkpointer is None:
            raise FloatingPointError(
                f"on_nonfinite='rollback' needs a checkpointer with a saved "
                f"step; non-finite at step {step_i}: {bad}")
        try:
            last_bad = None
            while True:
                self.restore()
                if sanitize.tree_all_finite(self.state.params):
                    return self.state.step
                ckpt_step = self.state.step
                if ckpt_step == last_bad:
                    # the quarantine did not take (a read-only filesystem):
                    # refuse to spin on the same step
                    raise RuntimeError(f"could not quarantine poisoned "
                                       f"checkpoint step {ckpt_step}")
                last_bad = ckpt_step
                logger.warning("rollback target step %d holds non-finite "
                               "params; quarantining and walking back further",
                               ckpt_step)
                self.checkpointer.quarantine(ckpt_step)
        except Exception as e:
            raise FloatingPointError(
                f"rollback from non-finite metrics at step {step_i} failed "
                f"({e}); bad metrics: {bad}") from e

    def evaluate(self, dataset: PartitionedDataset, *, batch_size: int
                 ) -> dict[str, float]:
        """Weighted-mean metrics over the whole dataset, the tail batch
        included, combined by the loss's ``"weight"`` metric when it
        reports one, else by rows. In a gang, each batch's weighted sums and
        weights are summed across ranks, and a tail that cannot fill every
        rank equally is padded with ``eval_mask == 0`` rows (a rank holding
        only padding weighs nothing), so the result is one pass over the
        global dataset. The model runs in eval mode (BatchNorm on its
        running statistics). The batches are prefetched as in :meth:`fit`."""
        totals: dict[str, float] = {}
        wsum = 0.0
        feed = prefetch_to_device(
            self._host_feed(dataset, batch_size, drop_remainder=False,
                            pad_remainder=True), self.device)
        try:
            for batch in feed:
                rows = next(iter(batch.values())).shape[0]
                m = _to_host(self._eval_step(batch))
                if "eval_mask" in batch and "weight" not in m:
                    raise RuntimeError(
                        "the loss ignored the tail batch's eval_mask (no "
                        "'weight' metric reported): weight per-row metrics by "
                        "batch['eval_mask'] and report weight=mask.sum()")
                w = float(m.pop("weight", rows))
                if "eval_mask" in batch and not bool(batch["eval_mask"].any()):
                    w = 0.0  # this rank's slice of the tail is all padding
                vec = torch.tensor([w] + [v * w for v in m.values()],
                                   dtype=torch.float64, device=self.device)
                sums = collectives.all_reduce_sum_(
                    vec, self.session.mesh.group(LOSS_AXES)).tolist()
                for k, v in zip(m, sums[1:]):
                    totals[k] = totals.get(k, 0.0) + v
                wsum += sums[0]
                _touch_heartbeat()
        finally:
            feed.close()
        return {k: v / max(wsum, 1e-9) for k, v in totals.items()}

    def predict(self, dataset: PartitionedDataset, *, batch_size: int,
                output_fn: Callable[[Any], Any] | None = None,
                with_inputs: bool = False) -> Iterator[Any]:
        """Yield per-example model outputs (host numpy) over ``dataset``, in
        JAX's *feed order*: shard-interleaved (partition *i* → data shard
        ``i % num_shards``), which is not ``dataset.collect()`` order when
        there are several partitions. ``with_inputs=True`` yields
        ``(example, output)`` pairs instead. ``output_fn`` post-processes
        each output batch on the device before the copy to the host (e.g.
        ``lambda logits: logits.argmax(-1)``).

        In a gang the outputs are gathered (a vocab-split output whole, under
        context parallelism the sequence blocks of each leaf of rank ≥ 2
        along dim 1, then the rows over the batch group), so every rank
        yields the whole global row stream — with ``with_inputs``, only the
        rows whose inputs it holds. As in JAX, a tail that cannot fill every
        rank equally is then dropped."""
        n = self.session.default_parallelism
        srange = self._shard_range()
        group = self.session.mesh.group(BATCH_AXES) if self.session.distributed else None
        gather = self.session.distributed and n > 1
        cp = self.context_parallel and self.session.mesh.shape[AXIS_SEQ] > 1
        seq_group = self.session.mesh.group((AXIS_SEQ,)) if cp else None

        def whole_seq(t: torch.Tensor) -> torch.Tensor:
            if t.dim() < 2:
                return t
            return collectives.all_gather_rows(t.transpose(0, 1).contiguous(),
                                               seq_group).transpose(0, 1)

        self.model.eval()
        for host_batch in self._host_feed(dataset, batch_size, whole_rows=True,
                                          drop_remainder=False):
            with torch.no_grad():  # not inference_mode: see make_eval_step
                out = self.model(to_device(self._seq_shard(host_batch), self.device))
                if is_fused_output(out):  # the logits predict yields (JAX's step)
                    out = materialize_logits(out)
                out = _tree_map(sharding.full, out)
                if output_fn is not None:
                    out = output_fn(out)
                if cp:
                    out = _tree_map(whole_seq, out)
                if gather:
                    out = _tree_map(lambda t: collectives.all_gather_rows(t, group), out)
                host = _tree_map(lambda t: t.cpu().numpy(), out)
            rows = _first_leaf(host).shape[0]
            local_rows = next(iter(host_batch.values())).shape[0]
            lo = 0 if srange is None else srange[0] * (rows // n)
            for r in range(rows):
                row_out = _tree_map(lambda a: a[r], host)
                if with_inputs:
                    if lo <= r < lo + local_rows:
                        yield ({k: v[r - lo] for k, v in host_batch.items()},
                               row_out)
                else:
                    yield row_out

"""MPMD pipeline trainer — each stage its own gang of processes on its own
cards, the port of ``distributeddeeplearningspark_tpu/train/pipeline_trainer.py``.

:mod:`..parallel.pipeline` runs GPipe inside ONE gang: every stage shares
one process group, one failure domain and one launch. Here (PAPERS.md
2412.14374, MPMD pipeline parallelism) stage *k* is a separate gang of OS
processes, one a card (the port's reading of a JAX stage of n devices),
with its own ``torch.distributed`` group and mesh
(:func:`_join_stage_gang`: ``stage_meshes[k]``, else ``mesh``), its own
layout, optimizer and checkpoint lineage, exchanging activations and
gradients over the authenticated socket transport of
:mod:`..parallel.mpmd`, double-buffered so stage *k* computes microbatch
*i* while *i+1* is in flight. Stages never join a collective with each
other. Within a stage the lead (rank 0) alone holds the links; what it
receives goes to its gang over the stage's group, scattered by rows or
broadcast to tensor peers, and what the stage sends is gathered to it
first (:class:`StageGang`), on the compute stream.

**The program** (:class:`LlamaStageProgram`) holds one stage of the
port's Llama (:mod:`..models.llama`): layers ``k·L/P … (k+1)·L/P − 1``
(:func:`..parallel.pipeline.stage_layers`), the embedding on stage 0 only
and ``final_norm`` + ``lm_head`` on the last stage only. The other stages'
layers are :class:`~..models.llama.ElsewhereLayer`\\ s, so the init draws
every value in one card's order from the seed and keeps this stage's
slice, and the param names stay one card's (``layers.<i>....``). Where JAX
recomputes a stage's forward from the saved input in its backward
(``jax.vjp``), the port keeps each microbatch's autograd graph from its
forward, built from a detached input, each layer under the model's own
``checkpoint`` as in :mod:`..models.llama_pp`: the remat, and so the FLOP
count, stay one card's. So on a card K1 runs 2·(L/P)·M times a step on a
stage, and K2 and K3 (L/P)·M times each.

**Numerics.** Two modes, as in JAX:

- ``mode="exact"`` (``loss_mode="full_batch"``, a stage mesh over
  ``data``/``fsdp`` only): params whole on every rank; each rank of the
  stage takes its rows of each microbatch (row shard r holds rows
  r·B/D … (r+1)·B/D − 1 of the batch, the port's data-parallel feed, and
  link microbatch i carries each shard's i-th slice in shard order,
  :meth:`LlamaStageProgram.link_rows`); the per-microbatch gradients
  accumulate in the one-program GPipe order (reverse microbatch order,
  :func:`backward_order`) into the params' ``.grad`` and are summed over
  the row shards once, at the step (``collectives.all_reduce_grads``);
  stage 0 embeds its rows once and back-propagates them once, on the
  concatenated input gradients; the last stage runs norm → head → loss over
  its rows of the full batch in one graph, dividing by the mask weight
  stage 0 computed (:func:`loss_denominator` of its META frame), or over
  row shards with the data-parallel ``Trainer``'s weighing
  (``collectives.weigh_loss``). The same ops in the same order as
  :mod:`..parallel.pipeline`'s step at ``data × pipe``.
- ``mode="sharded"`` (``loss_mode="per_microbatch"``): the 1F1B schedule;
  the last stage backwards each microbatch right after its forward, and
  the gradients accumulate in arrival order. The stage is laid out by its
  plan (``stage_plans[k]``, else ``plan``: ``replicated``, ``fsdp``,
  ``tensor`` or a plan record, :func:`stage_plan_of`) over its mesh with
  :func:`..parallel.sharding.fully_shard_model`: FSDP2's gradients reduce
  at each microbatch's backward, as JAX's; a ``tensor`` stage's layers run
  Megatron's splits on local shards, each rank on every row. ``zero``
  stays refused (ROADMAP Queue 1 item 5, :func:`refuse_multi_card_stage`).

**Scheduling.** 1F1B: middle stages prefer a waiting gradient over the next
forward, and with ``loss_mode="per_microbatch"`` the last stage holds at
most one activation; warmup and cooldown give the bubble (P−1)/(M+P−1),
which the trace spans measure (the port's ``dlstatus --traces`` pipeline
block, :func:`..telemetry.fleet.pipeline_anatomy`).

**Recovery.** Each stage checkpoints its own state
(``<workdir>/stage<k>/ckpt``) through :class:`..checkpoint.Checkpointer`,
whole tensors gathered from its gang (so a stage restores on any mesh,
JAX's reshard-on-restore). When a rank of a stage dies, its peers'
transport raises a typed error; they re-listen/re-dial while
:class:`..supervisor.PipelineSupervisor` restarts only the dead stage's
gang, then all stages agree on the resume step
(:meth:`..parallel.mpmd.PipelineTransport.sync_step`), roll back to it and
go on. A stage stamps ``DLS_HEARTBEAT_FILE`` in every long phase: every
second of its init and of a checkpoint save or restore,
every second it waits in ``connect`` or the resync, and each step; so the
supervisor's hang watchdog never takes a survivor that waits for a
restarted peer for a hang.

On a card a stage moves each activation to the host once, into pinned
memory, and each received one to the card with ``non_blocking``
(:func:`..parallel.mpmd.encode_payload`, :func:`..parallel.mpmd.to_device`),
and waits for its card after each compute phase (where JAX blocks), so the
spans time the card's work. Run one stage with ``python -m
distributeddeeplearningspark_tpu_torch.train.pipeline_trainer`` under the
supervisor's env (:func:`stage_main`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from distributeddeeplearningspark_tpu_torch import faults
from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib
from distributeddeeplearningspark_tpu_torch.models.llama import (
    ElsewhereLayer,
    LlamaConfig,
    LlamaForCausalLM,
)
from distributeddeeplearningspark_tpu_torch.models.llama_pp import (
    _stage_forward,
    check_pp_config,
)
from distributeddeeplearningspark_tpu_torch.parallel import collectives, mpmd, sharding
from distributeddeeplearningspark_tpu_torch.parallel import plan as plan_lib
from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    MeshSpec,
    num_data_shards,
)
from distributeddeeplearningspark_tpu_torch.parallel.pipeline import stage_layers
from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.train.state import TrainState, map_leaves
from distributeddeeplearningspark_tpu_torch.train.step import _rewrap
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.pipeline")

#: span names the pipeline emits; telemetry/fleet.pipeline_anatomy folds
#: busy vs wait into the measured bubble fraction.
BUSY_SPANS = ("pipe-fwd", "pipe-bwd", "pipe-loss", "pipe-embed",
              "pipe-embed-bwd", "pipe-opt")
WAIT_SPANS = ("pipe-recv-wait", "pipe-send-wait")
STEP_SPAN = "pipe-step"
#: seconds between two stamps of the heartbeat in a long phase
BEAT_S = 1.0


def theoretical_bubble(m: int, p: int) -> float:
    """The GPipe/1F1B pipeline-fill bound: (P−1)/(M+P−1)."""
    return (p - 1) / float(m + p - 1)


def backward_order(m: int) -> list[int]:
    """The microbatches the last stage back-propagates in GPipe mode, in
    order: last to first, the one-program GPipe's accumulation order."""
    return list(reversed(range(m)))


def loss_denominator(meta: dict) -> float:
    """The loss's denominator from stage 0's META frame: the full batch's
    shifted-mask weight, at least 1 (``losses.causal_lm``'s)."""
    return max(float(meta["weight"]), 1.0)


def touch_heartbeat() -> None:
    """Stamp ``DLS_HEARTBEAT_FILE`` (the supervisor's hang watchdog reads
    its mtime); a no-op without it."""
    path = os.environ.get("DLS_HEARTBEAT_FILE")
    if not path:
        return
    try:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass


@contextlib.contextmanager
def beating(period: float = BEAT_S):
    """Stamp the heartbeat every ``period`` seconds while the body runs (a
    checkpoint save or restore: one blocking call that can outlast the
    watchdog's timeout). The stamping thread touches only the file."""
    if not os.environ.get("DLS_HEARTBEAT_FILE"):
        yield
        return
    done = threading.Event()

    def beat():
        while not done.wait(period):
            touch_heartbeat()

    touch_heartbeat()
    thread = threading.Thread(target=beat, name="dls-pipe-heartbeat", daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join()
        touch_heartbeat()


# -- per-stage Llama program --------------------------------------------------


def ce_sums(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σ per-token CE · mask, Σ mask)`` in f32 over the shifted targets:
    :func:`..losses.causal_lm`'s expression, before its division. Logits
    split over the vocab (a ``tensor`` stage's head) take the
    vocab-parallel cross-entropy."""
    labels = ids[:, 1:].long()
    split = sharding.tensor_split(logits)
    if split is not None:
        per_tok = losses._vocab_parallel_xent(logits, labels, split)
    else:
        lg = logits[:, :-1].float()
        per_tok = F.cross_entropy(lg.flatten(0, 1), labels.flatten(),
                                  reduction="none").view(labels.shape)
    m = mask[:, 1:].float()
    return (per_tok * m).sum(), m.sum()


class _StageCalls:
    """A stage program's ``model.pipe``: ``model({"call": f, "args": a})``
    runs ``f(*a)`` inside the model's own forward, so that where FSDP2
    shards the model its root hooks wrap the stage's embedding, layers and
    head (the root's params gathered, their gradients reduced after the
    backward) as they wrap a whole model's forward."""

    def forward(self, model: LlamaForCausalLM, batch: dict):
        return batch["call"](*batch["args"])


class LlamaStageProgram:
    """The compute owned by ONE pipeline stage of a Llama model, on one
    device or on a gang of them (``mesh``).

    Stage 0 holds ``token_embed`` and its layers; the last stage its layers,
    ``final_norm`` and ``lm_head`` (and the loss). The values are the whole
    model's own init from the seed (:meth:`init_state`), or ``init_params``
    (a whole state dict, e.g. ``llama_io.params_from_flax``'s), so N
    stages reassemble to one card's model.

    ``mesh`` (a :class:`~..parallel.mesh.Mesh` over the stage's gang, None:
    one device): the rows of each microbatch split over its batch axes
    (``data × fsdp``; ``tensor`` peers take the same rows). ``exact`` keeps
    the params whole on every rank and sums the accumulated gradients over
    the batch group once, at :meth:`apply_grads` (a mesh with another axis
    above 1 is refused, as in JAX); ``sharded`` lays the params out by
    ``plan`` (:func:`..parallel.plan.stage_plan`) with
    :func:`..parallel.sharding.fully_shard_model`: FSDP2's gradients reduce
    at each microbatch's backward, the others' once at :meth:`apply_grads`.

    Per step: :meth:`start_step`; stage 0 :meth:`embed`; :meth:`fwd` of
    each microbatch (its graph kept under its index); the last stage
    :meth:`loss_backward`; :meth:`bwd` of each microbatch (its params'
    gradients accumulate in ``.grad``); stage 0 :meth:`embed_backward`;
    :meth:`apply_grads`.
    """

    def __init__(self, cfg: LlamaConfig, stage: int, num_stages: int,
                 tx: optim.GradientTransformation, *, device="cuda",
                 mode: str = "exact", loss_mode: str = "full_batch",
                 init_params: dict[str, Any] | None = None,
                 mesh: Mesh | None = None, plan: plan_lib.Plan | None = None):
        if mode not in ("exact", "sharded"):
            raise ValueError(f"mode must be 'exact'|'sharded', got {mode!r}")
        if loss_mode not in ("full_batch", "per_microbatch"):
            raise ValueError(
                f"loss_mode must be 'full_batch'|'per_microbatch', got "
                f"{loss_mode!r}")
        if mode == "exact" and loss_mode != "full_batch":
            raise ValueError(
                "mode='exact' requires loss_mode='full_batch': bitwise "
                "parity with the single-program baseline needs the loss "
                "computed over the full concatenated logits")
        check_pp_config(cfg, num_stages)
        shape = mesh.shape if mesh is not None else MeshSpec(data=1).shape(1)
        if mode == "exact":
            extra = {a: s for a, s in shape.items() if a not in BATCH_AXES and s > 1}
            if extra:
                raise ValueError(
                    f"mode='exact' shards rows over (data, fsdp) only; this "
                    f"stage mesh also has {extra} — use mode='sharded'")
            plan = None
        #: the mesh a plan is validated and lowered on (one device's
        #: without a gang)
        self._layout_mesh = mesh if mesh is not None else Mesh(shape)
        if plan is not None:
            plan.validate(self._layout_mesh)
        self.cfg = cfg
        self.stage = stage
        self.num_stages = num_stages
        self.tx = tx
        self.mode = mode
        self.mesh = mesh
        self.plan = plan
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.loss_mode = loss_mode
        self.first = stage == 0
        self.last = stage == num_stages - 1
        self.layers = stage_layers(cfg.num_layers, num_stages, stage)
        self.stage_len = len(self.layers)
        #: the ranks that take distinct rows, this rank's place among them
        #: and their process group (None: one rank, or the whole gang)
        self.row_shards = num_data_shards(shape)
        self.row_index = mesh.batch_index(mesh.rank) if mesh is not None else 0
        self.row_group = mesh.group(BATCH_AXES) if self.row_shards > 1 else None
        self._init_params = init_params
        self.model: LlamaForCausalLM | None = None
        self.names: list[str] = []
        self._graphs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._embed_out: torch.Tensor | None = None

    # -- state ---------------------------------------------------------------

    def _build(self) -> LlamaForCausalLM:
        """The model on the meta device, the other stages' layers (and on
        all but the last stage the norm and head) taken out, laid out by
        the plan, then allocated on the device. Every stage keeps
        ``token_embed``: the init draws it first."""
        model = LlamaForCausalLM(self.cfg, device="meta")
        for i in range(self.cfg.num_layers):
            if i not in self.layers:
                model.layers[i] = ElsewhereLayer(i, i // self.stage_len)
        if not self.last:
            model.final_norm = None
            model.lm_head = None
        if not self.first:
            model.token_embed.weight.requires_grad_(False)
        if self.plan is not None:
            sharding.fully_shard_model(model, self.plan.rules, self._layout_mesh)
        model.to_empty(device=self.device)
        model.pipe = _StageCalls()
        self.names = [n for n, _ in model.named_parameters()
                      if self.first or not n.startswith("token_embed.")]
        return model.train()

    def _call(self, fn: Callable, *args):
        """``fn(*args)`` through the model's forward (:class:`_StageCalls`)."""
        return self.model({"call": fn, "args": args})

    def init_state(self, seed: int) -> TrainState:
        """This stage's :class:`TrainState` at step 0: the whole model's draws
        from ``seed`` (one card's) or ``init_params``, this stage's slice
        (each rank its shard of a sharded param); fresh optimizer state. A
        second call draws into the same tensors."""
        if self.model is None:
            self.model = self._build()
        model = self.model
        with torch.no_grad():
            if self._init_params is None:
                model.init_weights(torch.Generator(self.device).manual_seed(seed))
            else:
                for n, p in model.named_parameters():
                    if n in self.names:
                        sharding.assign(p, torch.as_tensor(self._init_params[n]))
        self.start_step()
        params = dict(model.named_parameters())
        params = {n: params[n] for n in self.names}
        return TrainState(step=0, params=params,
                          opt_state=self.tx.init([params[n] for n in self.names]),
                          generator=torch.Generator(self.device).manual_seed(seed))

    # -- per-step compute (called by the runner) -----------------------------

    def start_step(self) -> None:
        """Drop a step's partial state: kept graphs and gradients."""
        self._graphs.clear()
        self._embed_out = None
        if self.model is not None:
            for p in self.model.parameters():
                p.grad = None

    def put_rows(self, x) -> torch.Tensor:
        """Rows (numpy, or a host tensor from the transport) on the device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return mpmd.to_device(x, self.device)

    def my_rows(self, x):
        """This rank's rows of ``x`` (its chunk of the row shards)."""
        if self.row_shards == 1:
            return x
        n = x.shape[0] // self.row_shards
        return x[self.row_index * n:(self.row_index + 1) * n]

    def link_rows(self, batch_size: int, m: int, mb: int) -> np.ndarray:
        """The batch rows microbatch ``mb`` carries on the links: each row
        shard's ``mb``-th slice of its own rows, in shard order (shard r
        holds rows r·B/D … (r+1)·B/D − 1, the port's data-parallel feed)."""
        block = batch_size // self.row_shards
        per = block // m
        return np.concatenate([np.arange(r * block + mb * per, r * block + (mb + 1) * per)
                               for r in range(self.row_shards)])

    def split_rows(self, x: torch.Tensor, m: int) -> list[torch.Tensor]:
        """``[B, ...]`` → M row-contiguous microbatches."""
        return list(torch.split(x, x.shape[0] // m))

    def concat_rows(self, parts: list) -> torch.Tensor:
        return torch.cat(list(parts), dim=0)

    def embed(self, state: TrainState, ids_dev: torch.Tensor) -> torch.Tensor:
        """Stage 0: its rows' embedding (the graph kept for
        :meth:`embed_backward`)."""
        with torch.enable_grad():
            x = self._call(self.model._embed, ids_dev)
        self._embed_out = x
        return x.detach()

    def embed_backward(self, state: TrainState, ids_dev: torch.Tensor,
                       d_x_full: torch.Tensor) -> None:
        """Stage 0: back-propagate the concatenated input gradients into the
        embedding, once."""
        out, self._embed_out = self._embed_out, None
        torch.autograd.backward(out, d_x_full)

    def fwd(self, state: TrainState, x_mb: torch.Tensor, mb: int) -> torch.Tensor:
        """This stage's layers on microbatch ``mb`` (its graph kept, from a
        detached input, until :meth:`bwd`)."""
        inp = x_mb.detach().requires_grad_(True)
        layers = [self.model.layers[i] for i in self.layers]
        with torch.enable_grad():
            out = self._call(lambda x: _stage_forward(layers, x, self.cfg.remat), inp)
        self._graphs[mb] = (inp, out)
        return out.detach()

    def bwd(self, state: TrainState, mb: int, dy: torch.Tensor) -> torch.Tensor:
        """Back-propagate ``dy`` through microbatch ``mb``'s graph (the
        params' gradients accumulate); its input's gradient."""
        inp, out = self._graphs.pop(mb)
        torch.autograd.backward(out, dy)
        return inp.grad

    def grads(self) -> dict[str, torch.Tensor | None]:
        """The accumulated gradient of each of this stage's params."""
        params = dict(self.model.named_parameters())
        return {n: params[n].grad for n in self.names}

    def mask_weight(self, mask_dev: torch.Tensor) -> float:
        """The loss denominator's weight: the shifted mask's sum (f32)."""
        return float(mask_dev[:, 1:].float().sum())

    def _sum_rows(self, *values: torch.Tensor) -> list[float]:
        """f32 sums of ``values`` over the row shards (this rank's own
        where it holds every row)."""
        vec = torch.stack([v.detach().float() for v in values])
        if self.row_shards > 1:
            collectives.all_reduce_sum_(vec, self.row_group)
        return vec.tolist()

    def loss_backward(self, state: TrainState, acts: torch.Tensor,
                      ids_dev: torch.Tensor, mask_dev: torch.Tensor,
                      denom: float) -> tuple[dict, torch.Tensor]:
        """(metrics, d_acts) for ``acts`` (this rank's rows of the full
        batch or of one microbatch): norm → head → cross-entropy summed,
        over ``denom`` (the GLOBAL mask weight), back-propagated in one
        graph; the norm's and head's gradients accumulate. ``exact`` over
        row shards takes the data-parallel ``Trainer``'s loss instead: each
        rank's mean over its rows weighed by its share of the global weight
        (``collectives.weigh_loss``), the same ops as the GPipe step's."""
        a = acts.detach().requires_grad_(True)
        model = self.model

        def head(x):
            return model._head(model.final_norm(x), counted=True)

        with torch.enable_grad():
            logits = self._call(head, a)
            if self.mode == "exact" and self.row_shards > 1:
                loss, out = losses.causal_lm(logits, {"input_ids": ids_dev,
                                                      "loss_mask": mask_dev})
                loss, out = collectives.weigh_loss(loss, out, ids_dev.shape[0],
                                                   self.row_group)
                loss.backward()
                return {"loss": float(out["loss"]), "weight": float(out["weight"])}, a.grad
            s, w = ce_sums(logits, ids_dev, mask_dev)
            loss = s / torch.tensor(denom, dtype=torch.float32, device=s.device)
        loss.backward()
        loss_sum, weight = self._sum_rows(s, w)
        loss_sum = np.float32(loss_sum)
        return {"loss": float(np.float32(loss_sum / np.float32(denom))),
                "loss_sum": float(loss_sum), "weight": float(weight)}, a.grad

    def apply_grads(self, state: TrainState) -> TrainState:
        """One optimizer step from the accumulated gradients (a param the
        step did not reach takes a zero gradient, as JAX's): the gradients
        FSDP2 did not reduce summed over the row shards first, then the
        update on each rank's local shards."""
        params = [state.params[n] for n in self.names]
        grads = [sharding.local(torch.zeros_like(p) if p.grad is None else p.grad)
                 for p in params]
        local = [sharding.local(p) for p in params]
        with torch.no_grad():
            if self.row_shards > 1:
                collectives.all_reduce_grads(
                    [g for g, p in zip(grads, params) if not sharding.fsdp_reduced(p)],
                    self.row_group)
            updates, opt_state = self.tx.update(
                grads, map_leaves(sharding.local, state.opt_state), local)
            torch._foreach_add_(local, updates)
        state.opt_state = map_leaves(_rewrap, state.opt_state, opt_state)
        for p in params:
            p.grad = None
        state.step += 1
        return state


# -- span bookkeeping ---------------------------------------------------------


class _StepSpans:
    """Per-step span collector for one stage: a stage-local ``pipe-step``
    tree (bubble accounting) plus per-microbatch spans that join the
    cross-stage trace minted by stage 0 (the trace context carried in the
    transport frames)."""

    def __init__(self, stage: int, step: int, m: int, p: int, schedule: str):
        self.stage, self.step, self.m, self.p = stage, step, m, p
        self.schedule = schedule
        self.trace_id = f"pipe-{os.urandom(4).hex()}"
        self.root_id = trace_lib.new_span_id()
        self.t0 = time.time()
        self.records: list[dict] = []

    def add(self, name: str, t0: float, t1: float, *,
            trace_id: str | None = None, parent_id: str | None = None,
            span_id: str | None = None, **attrs) -> str:
        sid = span_id or trace_lib.new_span_id()
        rec = trace_lib.span(
            trace_id or self.trace_id, sid, name, t0, t1,
            parent_id=(parent_id if trace_id else
                       (parent_id or self.root_id)),
            stage=self.stage, step=self.step, **attrs)
        self.records.append(rec)
        return sid

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        t0 = time.time()
        try:
            yield
        finally:
            self.add(name, t0, time.time(), **kw)

    def flush(self, writer) -> None:
        self.records.append(trace_lib.span(
            self.trace_id, self.root_id, STEP_SPAN, self.t0, time.time(),
            stage=self.stage, step=self.step, m=self.m, p=self.p,
            schedule=self.schedule))
        if writer is not None:
            writer.emit_many(trace_lib.SPAN_KIND, self.records)
        self.records = []


# -- the stage's gang ------------------------------------------------------------


class StageGang:
    """The ranks of one stage, joined in its own process group (the default
    one of each stage process), as the runner sees them.

    Rank 0, the *lead*, alone holds the stage's transport links; a frame it
    receives reaches the gang in two parts: its header (microbatch, labels,
    mask, trace) over ``ctrl``, a gloo group, by :meth:`share`, then its
    tensor over the stage's group on the compute stream: scattered by rows
    where the ranks split them (``data``, ``fsdp``), broadcast where they
    all need every row (``tensor``) (:meth:`spread`). What the stage sends
    is first gathered to the lead (:meth:`collect`). Every branch the lead
    takes on what its links hold (a gradient waiting or not, the resume
    step) is shared the same way, so the ranks make the same collectives in
    the same order. A link error the lead meets is held
    (:attr:`error`) and raised on every rank at the next :meth:`share`:
    the ranks then resync together, none left waiting in a collective.
    Counts the bytes each of the three moves carried and their seconds
    (:attr:`stats`), on the lead."""

    def __init__(self, program: LlamaStageProgram, ctrl=None):
        mesh = program.mesh
        self.program = program
        self.size = math.prod(mesh.shape.values()) if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.lead = self.rank == 0
        self.ctrl = ctrl
        self.error: mpmd.TransportError | None = None
        self.stats = {"broadcast": [0, 0], "scatter": [0, 0], "gather": [0, 0],
                      "collective_s": 0.0}

    def fail(self, err: mpmd.TransportError) -> None:
        """Hold a link error for the next :meth:`share` (raise it at once
        in a gang of one)."""
        if self.size == 1:
            raise err
        self.error = self.error or err

    def share(self, obj: Any = None) -> Any:
        """The lead's ``obj`` on every rank; raises on every rank the link
        error the lead holds. The ranks that wait stamp their heartbeats."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [("error", repr(self.error)) if self.error is not None else ("ok", obj)]
        if self.lead:
            dist.broadcast_object_list(box, src=0, group=self.ctrl)
        else:
            with beating():
                dist.broadcast_object_list(box, src=0, group=self.ctrl)
        tag, value = box[0]
        if tag == "error":
            err = self.error or mpmd.PeerDiedError(f"stage lead: {value}")
            self.error = None
            raise err
        return value

    def _timed(self, kind: str, nbytes: int, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.program.device.type == "cuda":
            torch.cuda.synchronize(self.program.device)
        if self.lead:
            self.stats[kind][0] += 1
            self.stats[kind][1] += nbytes
            self.stats["collective_s"] += time.perf_counter() - t0
        return out

    def spread(self, whole: torch.Tensor | None, shape: tuple, dtype: torch.dtype
               ) -> torch.Tensor:
        """The lead's ``whole`` (a link microbatch on its device) to every
        rank: each rank's rows of it."""
        import torch.distributed as dist

        prog = self.program
        if self.size == 1:
            return whole
        nbytes = math.prod(shape) * dtype.itemsize
        rows = prog.row_shards
        if rows == self.size:
            part = torch.empty((shape[0] // rows, *shape[1:]), dtype=dtype,
                               device=prog.device)
            chunks = list(whole.chunk(rows)) if self.lead else None
            self._timed("scatter", nbytes, lambda: dist.scatter(part, chunks, src=0))
            return part
        buf = whole if self.lead else torch.empty(shape, dtype=dtype, device=prog.device)
        self._timed("broadcast", nbytes, lambda: dist.broadcast(buf, src=0))
        return prog.my_rows(buf)

    def collect(self, part: torch.Tensor) -> torch.Tensor | None:
        """Every rank's rows of a link microbatch, whole on the lead (None
        on the other ranks)."""
        import torch.distributed as dist

        prog = self.program
        if self.size == 1:
            return part
        rows = prog.row_shards
        if rows == 1:  # tensor peers: the lead's rows are the whole
            return part if self.lead else None
        nbytes = part.numel() * part.element_size() * rows
        part = part.contiguous()
        if rows == self.size:
            parts = [torch.empty_like(part) for _ in range(rows)] if self.lead else None
            self._timed("gather", nbytes, lambda: dist.gather(part, parts, dst=0))
            return torch.cat(parts) if self.lead else None
        whole = self._timed("gather", nbytes,
                            lambda: collectives.all_gather_rows(part, prog.row_group))
        return whole if self.lead else None


# -- the stage runner ---------------------------------------------------------


@dataclasses.dataclass
class StageRunConfig:
    steps: int
    batch_size: int
    microbatches: int
    checkpoint_every: int | None = None
    seed: int = 0
    recv_timeout_s: float = 300.0
    connect_timeout_s: float = 300.0
    #: total wall budget for surviving a dead peer (reconnect + resync);
    #: past it the stage exits nonzero and the supervisor restarts it too.
    resync_budget_s: float = 600.0


class PipelineStageRunner:
    """Drive ONE stage program against the transport for ``steps`` steps.

    ``batch_fn(step) -> {"input_ids", "loss_mask"}`` (stage 0 only) must be
    a pure function of the step index — that is what makes rollback-resync
    trivial (no stream state to rewind), and lets each rank of stage 0
    take its own rows of the step's batch. The runner owns scheduling,
    checkpointing, telemetry (spans + step_metrics + heartbeats), fault
    injection hooks, and peer-death resync. On a stage of several ranks
    (``gang``) it runs on every rank, the lead alone holding ``transport``
    (None on the others). ``stats`` holds what the transport cost: the
    seconds moving tensors to the host (``d2h_s``) and to the card
    (``h2d_s``), the frames and tensor bytes of the activations and
    gradients sent (``sent``), and each step's seconds (``lap_s``).
    """

    def __init__(self, program: LlamaStageProgram,
                 transport: mpmd.PipelineTransport | None, run: StageRunConfig, *,
                 batch_fn: Callable[[int], dict] | None = None,
                 checkpointer=None, gang: StageGang | None = None):
        self.program = program
        self.gang = gang or StageGang(program)
        self.transport = transport
        self.run_cfg = run
        self.batch_fn = batch_fn
        self.ckpt = checkpointer
        if program.first and batch_fn is None:
            raise ValueError("stage 0 needs a batch_fn (it owns the feed)")
        if self.gang.lead and transport is None:
            raise ValueError("the stage's lead rank needs the transport")
        if run.batch_size % run.microbatches:
            raise ValueError(
                f"batch_size {run.batch_size} must divide by microbatches "
                f"{run.microbatches}")
        rows = run.batch_size // run.microbatches
        if rows % program.row_shards:
            raise ValueError(
                f"microbatch of {rows} row(s) (batch {run.batch_size} / "
                f"{run.microbatches} microbatches) cannot shard over this "
                f"stage's {program.row_shards} (data x fsdp) device(s) — use "
                f"fewer microbatches, a bigger batch, or a narrower stage mesh")
        self._tele = telemetry_lib.get()
        self._losses: list[float] = []
        self._cuda = program.device.type == "cuda"
        self.stats: dict[str, Any] = {
            "d2h_s": 0.0, "h2d_s": 0.0, "transfers": 0, "lap_s": [],
            "sent": {"act": [0, 0], "grad": [0, 0]}}

    # -- lifecycle -----------------------------------------------------------

    def _committed_step(self) -> int:
        if self.ckpt is None:
            return 0
        return self.ckpt.latest_verified_step() or 0

    def _restore(self, state: TrainState, step: int) -> TrainState:
        assert self.ckpt is not None
        with beating():
            restored, data_state = self.ckpt.restore(state, step=step)
        saved = (data_state or {}).get("losses")
        if saved is not None:
            self._losses = [float(x) for x in saved][:step]
        return restored

    def _agree(self, committed: int) -> int:
        """The lead (re)connects its links and agrees the resume step with
        the other stages; every rank gets it."""
        cfg = self.run_cfg
        agreed = None
        if self.gang.lead:
            try:
                self.transport.connect(hello={"step": committed},
                                       timeout=cfg.connect_timeout_s)
                agreed = self.transport.sync_step(committed,
                                                  timeout=cfg.connect_timeout_s)
            except mpmd.TransportError as e:
                self.gang.fail(e)
        return self.gang.share(agreed)

    def run(self) -> dict:
        cfg = self.run_cfg
        if self._cuda:
            torch.cuda.set_device(self.program.device)
        with beating():
            state = self.program.init_state(cfg.seed)
        committed = self._committed_step()
        if committed > 0:
            state = self._restore(state, committed)
        step = state.step
        resync_t0: float | None = None
        try:
            agreed = self._agree(committed)
            if agreed != step:
                state = self._reposition(state, agreed)
                step = agreed
            if self._tele is not None:
                self._tele.emit("phase", name="run", edge="begin", step=step)
                self._tele.heartbeat(step=step)
            fault = faults.get()
            while step < cfg.steps:
                if fault is not None and step + 1 == fault.step and \
                        fault.kind in ("crash", "die_host", "hang"):
                    kind, fault = fault.kind, None
                    if kind == "hang":
                        faults.hang()
                    else:
                        faults.crash()
                lap_t0 = time.time()
                try:
                    state, metrics = self._run_step(state, step)
                except mpmd.TransportError as e:
                    now = time.monotonic()
                    if resync_t0 is None:
                        resync_t0 = now
                    if now - resync_t0 > cfg.resync_budget_s:
                        raise
                    state = self._resync(state, e)
                    step = state.step
                    continue
                resync_t0 = None
                step += 1
                lap = time.time() - lap_t0
                self.stats["lap_s"].append(lap)
                self._losses.append(metrics.get("loss", float("nan")))
                if self._tele is not None:
                    self._tele.step_metrics(
                        step, steps=1, lap_s=lap,
                        metrics=metrics, stage=self.program.stage)
                    self._tele.heartbeat(step=step)
                touch_heartbeat()
                if (cfg.checkpoint_every and self.ckpt is not None
                        and step % cfg.checkpoint_every == 0):
                    self._save(state, step)
            if self.ckpt is not None:
                self._save(state, step)
            if self.transport is not None:
                self.stats["links"] = {
                    side: {mpmd._KIND_NAMES[k]: v for k, v in link.sent.items()}
                    for side, link in (("up", self.transport.up),
                                       ("down", self.transport.down))
                    if link is not None}
                self.transport.close()
            self.stats["gang"] = dict(self.gang.stats)
            return {"step": step, "losses": self._losses,
                    "stage": self.program.stage, "state": state,
                    "stats": self.stats}
        except BaseException:
            # dying of a NON-transport error (shape bug, OOM, SIGTERM
            # unwinding): tear the sockets now so peers get a typed
            # PeerDiedError immediately instead of burning their full
            # recv timeout discovering it
            if self.transport is not None:
                self.transport.reset()
            raise
        finally:
            if self._tele is not None:
                self._tele.emit("phase", name="run", edge="end", step=step)

    def _save(self, state: TrainState, step: int) -> None:
        assert self.ckpt is not None
        # the loss trajectory rides the checkpoint: a restarted stage-0
        # process must report the WHOLE run's losses in its summary/DONE,
        # not just the steps since its own restore
        with beating():
            self.ckpt.save(step, state, data_state={
                "examples_seen": step * self.run_cfg.batch_size,
                "batch_size": self.run_cfg.batch_size,
                "losses": list(self._losses[:step])})
            self.ckpt.wait()

    def _reposition(self, state: TrainState, step: int) -> TrainState:
        """Move this stage's state to ``step``: restore the per-stage
        checkpoint, or re-init deterministically when the pipeline agreed
        on step 0 (no checkpoint anywhere)."""
        # rollback rewinds the loss trajectory too — the steps past the
        # resume point will re-run and re-append
        del self._losses[step:]
        if step == 0:
            state.opt_state = None  # freed before the fresh one is made
            with beating():
                return self.program.init_state(self.run_cfg.seed)
        if state.step == step:
            return state
        return self._restore(state, step)

    def _resync(self, state: TrainState, err: mpmd.TransportError) -> TrainState:
        """A peer died mid-step: drop partial step state, block on the
        transport until the supervisor brings the stage back, agree on the
        resume step, roll back to it (every rank of the gang together)."""
        cfg = self.run_cfg
        while True:
            committed = self._committed_step()
            logger.warning(
                "stage %d: peer failure (%s: %s) — reconnecting and resyncing "
                "from checkpoint step %d",
                self.program.stage, type(err).__name__, err, committed)
            if self._tele is not None:
                self._tele.recovery(committed or None, "pipeline-resync",
                                    stage=self.program.stage,
                                    error=type(err).__name__,
                                    detail=str(err)[:200])
            self.program.start_step()
            if self.transport is not None:
                self.transport.reset()
            t0 = time.monotonic()
            try:
                agreed = self._agree(committed)
            except mpmd.TransportError as e:
                if time.monotonic() - t0 > cfg.resync_budget_s:
                    raise
                err = e
                continue
            return self._reposition(state, agreed)

    # -- one training step ---------------------------------------------------

    def _run_step(self, state: TrainState, step: int):
        cfg = self.run_cfg
        prog = self.program
        spans = _StepSpans(prog.stage, step, cfg.microbatches,
                           prog.num_stages,
                           "gpipe" if prog.loss_mode == "full_batch"
                           else "1f1b")
        prog.start_step()
        try:
            if prog.first:
                metrics = self._step_first(state, step, spans)
            elif prog.last:
                metrics = self._step_last(state, step, spans)
            else:
                metrics = self._step_mid(state, step, spans)
            with spans.span("pipe-opt"):
                state = prog.apply_grads(state)
                self._block()
        finally:
            spans.flush(self._tele)
        return state, metrics

    def _block(self, x=None):
        """Wait for the card's queued work (JAX's ``block_until_ready``)."""
        if self._cuda:
            torch.cuda.synchronize(self.program.device)
        return x

    def _put(self, x) -> torch.Tensor:
        """A received tensor on the card, timed as the transport's."""
        t0 = time.perf_counter()
        out = self._block(self.program.put_rows(x))
        self.stats["h2d_s"] += time.perf_counter() - t0
        self.stats["transfers"] += 1
        return out

    def _recv(self, link: mpmd.StageLink, kind: int, spans: _StepSpans,
              pending: "list | None" = None):
        """Blocking receive, booked as recv-wait only when it actually
        blocks (a buffered frame is free — that is the double-buffering
        paying off, not a bubble). ``pending`` frames (drained while a
        send was blocked) are consumed first."""
        if pending:
            return pending.pop(0)
        got = link.try_recv(kind)
        if got is not None:
            return got
        with spans.span("pipe-recv-wait",
                        kind=mpmd._KIND_NAMES.get(kind, kind)):
            return link.recv(kind, timeout=self.run_cfg.recv_timeout_s)

    def _take(self, fetch: Callable[[], tuple], key: str | None = None) -> tuple:
        """A frame on every rank: the lead ``fetch()``\\ es it from a link
        (its ``key`` tensor then put on the card), the gang gets its header
        and its rows of the tensor (:meth:`StageGang.spread`)."""
        gang = self.gang
        item = None
        if gang.lead:
            try:
                item = fetch()
            except mpmd.TransportError as e:
                gang.fail(e)
        head = None
        if item is not None:
            mb, payload = item
            t = payload.get(key) if key else None
            head = (mb, {k: v for k, v in payload.items() if k != key},
                    None if t is None else (tuple(t.shape), t.dtype))
        mb, payload, tensor = gang.share(head)
        if tensor is not None:
            whole = self._put(item[1][key]) if gang.lead else None
            payload[key] = gang.spread(whole, *tensor)
        return mb, payload

    def _send(self, link: mpmd.StageLink | None, kind: int, obj: Any, mb: int,
              spans: _StepSpans, *, drain=None) -> None:
        """Bounded send that never deadlocks the bidirectional flow: while
        the send queue is full, incoming frames are drained into a local
        pending list (``drain``), so the opposite direction keeps moving.
        Booked as send-wait only when it actually blocked. The payload is
        encoded once, here (a card's tensors copied to pinned host
        memory). On a gang the activation or gradient is first gathered to
        the lead, which alone sends; a link error it meets is held for the
        gang (:meth:`StageGang.fail`)."""
        for name in ("act", "grad"):
            t = obj.get(name) if isinstance(obj, dict) else None
            if isinstance(t, torch.Tensor):
                obj = {**obj, name: self.gang.collect(t)}
        if not self.gang.lead:
            return
        try:
            self._send_lead(link, kind, obj, mb, spans, drain=drain)
        except mpmd.TransportError as e:
            self.gang.fail(e)

    def _send_lead(self, link: mpmd.StageLink, kind: int, obj: Any, mb: int,
                   spans: _StepSpans, *, drain=None) -> None:
        t0 = time.perf_counter()
        enc = mpmd.encode_payload(obj, pin=self._cuda)
        self.stats["d2h_s"] += time.perf_counter() - t0
        for name in ("act", "grad"):
            t = obj.get(name) if isinstance(obj, dict) else None
            if isinstance(t, torch.Tensor):
                self.stats["sent"][name][0] += 1
                self.stats["sent"][name][1] += t.numel() * t.element_size()
        t0 = time.time()
        blocked = False
        deadline = time.monotonic() + self.run_cfg.recv_timeout_s
        while True:
            try:
                link.send(kind, enc, mb=mb, timeout=0.02)
                break
            except mpmd.TransportTimeout:
                blocked = True
                if drain is not None:
                    drain()
                if time.monotonic() > deadline:
                    raise
        if blocked:
            spans.add("pipe-send-wait", t0, time.time(), mb=mb)

    @staticmethod
    def _drainer(link: mpmd.StageLink | None, kind: int, pending: list):
        """A drain callback: move any available ``kind`` frame off the
        link's bounded inbox into ``pending`` (no compute — just free the
        inbox so the peer's sender unblocks)."""
        def drain():
            if link is None:
                return
            try:
                item = link.try_recv(kind)
            except mpmd.TransportError:
                return  # surfaced by the next blocking call, typed
            if item is not None:
                pending.append(item)
        return drain

    def _links(self):
        """(up, down): the lead's links, None on the other ranks."""
        tr = self.transport
        return (tr.up, tr.down) if tr is not None else (None, None)

    # stage 0 — owns the batch, the embedding, and the microbatch traces.
    def _step_first(self, state: TrainState, step: int, spans: _StepSpans) -> dict:
        cfg, prog = self.run_cfg, self.program
        m = cfg.microbatches
        _, down = self._links()
        assert down is not None or not self.gang.lead
        batch = self.batch_fn(step)
        ids = np.ascontiguousarray(batch["input_ids"], np.int32)
        mask = np.ascontiguousarray(
            batch.get("loss_mask",
                      np.ones(ids.shape, np.float32)), np.float32)
        if ids.shape[0] != cfg.batch_size:
            raise ValueError(
                f"batch_fn returned {ids.shape[0]} rows, expected "
                f"{cfg.batch_size}")
        block = cfg.batch_size // prog.row_shards
        mine = slice(prog.row_index * block, (prog.row_index + 1) * block)
        with spans.span("pipe-embed"):
            ids_dev = prog.put_rows(ids[mine])
            x_full = self._block(prog.embed(state, ids_dev))
            weight = prog.mask_weight(prog.put_rows(mask)) if self.gang.lead else None
        pending: list = []
        drain = self._drainer(down, mpmd.GRAD, pending)
        self._send(down, mpmd.META, {
            "step": step, "m": m, "p": prog.num_stages,
            "weight": weight, "loss_mode": prog.loss_mode}, -1, spans)
        x_mbs = prog.split_rows(x_full, m)
        traces: list[tuple[str, str, float]] = []
        for i in range(m):
            tid = trace_lib.new_trace_id()
            root = trace_lib.new_span_id()
            mb_t0 = time.time()
            fwd_sid = trace_lib.new_span_id()
            with spans.span("pipe-fwd", trace_id=tid, parent_id=root,
                            span_id=fwd_sid, mb=i):
                act = self._block(prog.fwd(state, x_mbs[i], i))
            rows = prog.link_rows(cfg.batch_size, m, i)
            self._send(down, mpmd.ACT, {
                "step": step, "act": act,
                "labels": ids[rows], "mask": mask[rows],
                "trace": {"trace_id": tid, "parent_id": fwd_sid},
            }, i, spans, drain=drain)
            traces.append((tid, root, mb_t0))
        d_x: list = [None] * m
        for _ in range(m):
            mb, payload = self._take(
                lambda: self._recv(down, mpmd.GRAD, spans, pending), "grad")
            tid, root, mb_t0 = traces[mb]
            ctx = payload.get("trace") or {}
            with spans.span("pipe-bwd", trace_id=tid,
                            parent_id=ctx.get("parent_id") or root, mb=mb):
                d_x[mb] = self._block(prog.bwd(state, mb, payload["grad"]))
            # close the cross-stage microbatch root: fwd → transit →
            # downstream stages → grad return → local bwd, end to end
            spans.add("microbatch", mb_t0, time.time(), trace_id=tid,
                      span_id=root, parent_id=None, mb=mb, m=m,
                      p=prog.num_stages)
        with spans.span("pipe-embed-bwd"):
            prog.embed_backward(state, ids_dev, prog.concat_rows(d_x))
            self._block()
        _, payload = self._take(lambda: self._recv(down, mpmd.METRICS, spans))
        return dict(payload.get("metrics") or {})

    # middle stages — pure relay compute: 1F1B (prefer a waiting gradient
    # over the next forward).
    def _step_mid(self, state: TrainState, step: int, spans: _StepSpans) -> dict:
        cfg, prog = self.run_cfg, self.program
        m = cfg.microbatches
        up, down = self._links()
        pending_g: list = []
        drain_g = self._drainer(down, mpmd.GRAD, pending_g)
        _, meta = self._take(lambda: self._recv(up, mpmd.META, spans))
        self._send(down, mpmd.META, meta, -1, spans, drain=drain_g)
        tids: dict[int, str | None] = {}
        done_f = done_b = 0
        while done_b < m:
            item = None
            if self.gang.lead:
                try:
                    item = pending_g.pop(0) if pending_g else down.try_recv(mpmd.GRAD)
                except mpmd.TransportError as e:
                    self.gang.fail(e)
            waiting = self.gang.share(item is not None)
            if not waiting and done_f < m:
                mb, payload = self._take(
                    lambda: self._recv(up, mpmd.ACT, spans), "act")
                ctx = payload.get("trace") or {}
                fwd_sid = trace_lib.new_span_id()
                with spans.span(
                        "pipe-fwd",
                        trace_id=ctx.get("trace_id") or spans.trace_id,
                        parent_id=ctx.get("parent_id"),
                        span_id=fwd_sid, mb=mb):
                    y = self._block(prog.fwd(state, payload["act"], mb))
                tids[mb] = ctx.get("trace_id")
                self._send(down, mpmd.ACT, {
                    "step": step, "act": y,
                    "labels": payload["labels"], "mask": payload["mask"],
                    "trace": {"trace_id": ctx.get("trace_id"),
                              "parent_id": fwd_sid},
                }, mb, spans, drain=drain_g)
                done_f += 1
                continue
            mb, payload = self._take(
                lambda: item if item is not None else self._recv(down, mpmd.GRAD, spans),
                "grad")
            ctx = payload.get("trace") or {}
            bwd_sid = trace_lib.new_span_id()
            tid = tids.get(mb) or spans.trace_id
            with spans.span("pipe-bwd", trace_id=tid,
                            parent_id=ctx.get("parent_id"),
                            span_id=bwd_sid, mb=mb):
                dx = self._block(prog.bwd(state, mb, payload["grad"]))
            self._send(up, mpmd.GRAD, {
                "step": step, "grad": dx,
                "trace": {"trace_id": tid, "parent_id": bwd_sid},
            }, mb, spans, drain=drain_g)
            done_b += 1
        _, payload = self._take(lambda: self._recv(down, mpmd.METRICS, spans))
        self._send(up, mpmd.METRICS, payload, -1, spans)
        return dict(payload.get("metrics") or {})

    # last stage — the loss. full_batch: all forwards, one full-batch loss,
    # backwards in reverse (the one-program GPipe's accumulation order).
    # per_microbatch: loss+backward per arrival (1F1B memory).
    def _step_last(self, state: TrainState, step: int, spans: _StepSpans) -> dict:
        cfg, prog = self.run_cfg, self.program
        m = cfg.microbatches
        up, _ = self._links()
        _, meta = self._take(lambda: self._recv(up, mpmd.META, spans))
        denom = loss_denominator(meta)
        if prog.loss_mode == "full_batch":
            metrics = self._last_full_batch(state, step, spans, m, denom)
        else:
            metrics = self._last_per_microbatch(state, step, spans, m, denom)
        self._send(up, mpmd.METRICS, {"step": step, "metrics": metrics},
                   -1, spans)
        return metrics

    def _last_full_batch(self, state, step, spans, m, denom) -> dict:
        prog = self.program
        up, _ = self._links()
        pending_a: list = []
        drain_a = self._drainer(up, mpmd.ACT, pending_a)
        h_out, labels, masks, ctxs = {}, {}, {}, {}
        for _ in range(m):
            mb, payload = self._take(
                lambda: self._recv(up, mpmd.ACT, spans, pending_a), "act")
            ctx = payload.get("trace") or {}
            fwd_sid = trace_lib.new_span_id()
            with spans.span("pipe-fwd",
                            trace_id=ctx.get("trace_id") or spans.trace_id,
                            parent_id=ctx.get("parent_id"),
                            span_id=fwd_sid, mb=mb):
                h_out[mb] = self._block(prog.fwd(state, payload["act"], mb))
            labels[mb] = prog.my_rows(np.asarray(payload["labels"], np.int32))
            masks[mb] = prog.my_rows(np.asarray(payload["mask"], np.float32))
            ctxs[mb] = {"trace_id": ctx.get("trace_id"), "fwd": fwd_sid}
        with spans.span("pipe-loss"):
            acts = prog.concat_rows([h_out[i] for i in range(m)])
            lab_dev = prog.put_rows(np.concatenate(
                [labels[i] for i in range(m)], axis=0))
            mask_dev = prog.put_rows(np.concatenate(
                [masks[i] for i in range(m)], axis=0))
            metrics, d_acts = prog.loss_backward(state, acts, lab_dev,
                                                 mask_dev, denom)
            d_mbs = prog.split_rows(self._block(d_acts), m)
        for mb in backward_order(m):
            bwd_sid = trace_lib.new_span_id()
            tid = ctxs[mb]["trace_id"] or spans.trace_id
            with spans.span("pipe-bwd", trace_id=tid,
                            parent_id=ctxs[mb]["fwd"], span_id=bwd_sid,
                            mb=mb):
                dx = self._block(prog.bwd(state, mb, d_mbs[mb]))
            self._send(up, mpmd.GRAD, {
                "step": step, "grad": dx,
                "trace": {"trace_id": tid, "parent_id": bwd_sid},
            }, mb, spans, drain=drain_a)
        metrics["perplexity"] = float(np.exp(np.float32(metrics["loss"])))
        return metrics

    def _last_per_microbatch(self, state, step, spans, m, denom) -> dict:
        prog = self.program
        up, _ = self._links()
        pending_a: list = []
        drain_a = self._drainer(up, mpmd.ACT, pending_a)
        loss_sum = weight = 0.0
        for _ in range(m):
            mb, payload = self._take(
                lambda: self._recv(up, mpmd.ACT, spans, pending_a), "act")
            ctx = payload.get("trace") or {}
            tid = ctx.get("trace_id") or spans.trace_id
            fwd_sid = trace_lib.new_span_id()
            with spans.span("pipe-fwd", trace_id=tid,
                            parent_id=ctx.get("parent_id"),
                            span_id=fwd_sid, mb=mb):
                h = self._block(prog.fwd(state, payload["act"], mb))
            with spans.span("pipe-loss", trace_id=tid, parent_id=fwd_sid,
                            mb=mb):
                mrec, d_h = prog.loss_backward(
                    state, h,
                    prog.put_rows(prog.my_rows(np.asarray(payload["labels"], np.int32))),
                    prog.put_rows(prog.my_rows(np.asarray(payload["mask"], np.float32))),
                    denom)
                loss_sum += mrec["loss_sum"]
                weight += mrec["weight"]
            bwd_sid = trace_lib.new_span_id()
            with spans.span("pipe-bwd", trace_id=tid, parent_id=fwd_sid,
                            span_id=bwd_sid, mb=mb):
                dx = self._block(prog.bwd(state, mb, d_h))
            self._send(up, mpmd.GRAD, {
                "step": step, "grad": dx,
                "trace": {"trace_id": tid, "parent_id": bwd_sid},
            }, mb, spans, drain=drain_a)
        loss = float(np.float32(np.float32(loss_sum) / np.float32(denom)))
        return {"loss": loss, "weight": weight,
                "perplexity": float(np.exp(np.float32(loss)))}


# -- env-configured stage entry point -----------------------------------------
#
# ``python -m distributeddeeplearningspark_tpu_torch.train.pipeline_trainer``
# runs one rank of one stage, entirely env-configured — the worker half of
# the PipelineSupervisor contract. DLS_PIPE_SPEC carries the run recipe;
# DLS_STAGE_ID / DLS_NUM_STAGES / DLS_PIPE_PORTS / DLS_PIPE_AUTHKEY the
# topology; DLS_COORDINATOR / DLS_NUM_PROCESSES / DLS_PROCESS_ID the stage's
# gang; DLS_TELEMETRY_DIR the shared run directory (per-stage checkpoints
# live under ``<workdir>/stage<k>/ckpt``, each stage's summary in
# ``<workdir>/stage<k>/summary-<attempt>.json``, written by its lead).

#: the spec's ``cfg`` keys that name a torch dtype
_DTYPE_KEYS = ("dtype", "param_dtype")
#: seconds a stage's gloo control group waits in one collective: a rank
#: waits there while its lead waits for a peer stage (its connect and the
#: resync budget)
CTRL_TIMEOUT_S = 900.0


def _tiny_cfg(spec: dict) -> LlamaConfig:
    """The built-in CPU-trainable Llama geometry for drills/CI (f32);
    ``spec["cfg"]`` overrides (a dtype by its name, e.g. ``"bfloat16"``:
    Llama-2 7B's widths with ``"dtype": "bfloat16"`` are config 5's
    compute with f32 params, LlamaConfig's defaults)."""
    base = dict(vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
                num_kv_heads=2, intermediate_size=256, max_position=128,
                dtype=torch.float32)
    for k, v in (spec.get("cfg") or {}).items():
        base[k] = getattr(torch, v) if k in _DTYPE_KEYS and isinstance(v, str) else v
    return LlamaConfig(**base)


def _optimizer(spec: dict) -> optim.GradientTransformation:
    """JAX's stage optimizers: optax's ``adamw`` (its default weight decay,
    1e-4) or ``sgd``."""
    opt = dict(spec.get("optimizer") or {})
    name = opt.get("name", "adamw")
    lr = float(opt.get("lr", 1e-3))
    if name == "adamw":
        return optim.adamw(lr, weight_decay=1e-4)
    if name == "sgd":
        return optim.sgd(lr, momentum=float(opt.get("momentum", 0.0)))
    raise ValueError(f"unknown optimizer {name!r} in DLS_PIPE_SPEC")


def stage_mesh_axes(spec: dict, stage: int) -> dict[str, int]:
    """Stage ``stage``'s mesh axes: ``stage_meshes[stage]``, else ``mesh``,
    else JAX's default ``{"data": -1}`` (every device the stage sees)."""
    per_stage = (spec.get("stage_meshes") or {}).get(str(stage))
    return {k: int(v) for k, v in dict(per_stage or spec.get("mesh") or {"data": -1}).items()}


def stage_processes(spec: dict, stage: int, cards: int | None = None) -> int:
    """How many processes stage ``stage``'s gang takes: its mesh's size, a
    ``-1`` axis absorbing ``cards`` (the cards the stage is given; one
    process without them)."""
    axes = stage_mesh_axes(spec, stage)
    fixed = math.prod(v for v in axes.values() if v != -1)
    if -1 not in axes.values():
        return fixed
    if cards is None:
        return fixed
    if cards % fixed:
        raise ValueError(f"DLS_PIPE_SPEC stage {stage}: mesh {axes} does not "
                         f"divide its {cards} card(s)")
    return cards


def _stage_plan_name(spec: dict, stage: int):
    """Stage ``stage``'s plan entry: ``stage_plans[stage]``, else ``plan``,
    else ``replicated`` (a name or a serialized plan record)."""
    return (spec.get("stage_plans") or {}).get(str(stage), spec.get("plan", "replicated"))


def stage_plan_of(spec: dict, stage: int, cfg: LlamaConfig) -> plan_lib.Plan:
    """Stage ``stage``'s layout for ``mode="sharded"`` (JAX's
    ``_stage_plan``): its plan entry by name
    (:func:`..parallel.plan.stage_plan`, ``fsdp_min_size`` from the spec,
    JAX's default 2**10) or a serialized plan record
    (``Plan.from_record``); the program validates it on the stage's mesh.
    ``zero`` raises naming ROADMAP Queue 1 item 5."""
    name = _stage_plan_name(spec, stage)
    try:
        if isinstance(name, dict):
            return plan_lib.Plan.from_record(name)
        return plan_lib.stage_plan(
            name, cfg, fsdp_min_size=int(spec.get("fsdp_min_size", 2**10)))
    except plan_lib.PlanError as e:
        raise ValueError(f"DLS_PIPE_SPEC stage {stage}: {e}") from e


def refuse_multi_card_stage(spec: dict, stage: int) -> None:
    """What a stage still cannot be: raise ``ValueError``, naming why, for
    a ``zero`` stage plan (ZeRO weight-update sharding, ROADMAP Queue 1 item
    5) and, in ``mode="exact"``, a stage mesh with an axis other than
    ``data``/``fsdp`` above 1 (JAX's own refusal: exact mode splits rows
    only)."""
    name = _stage_plan_name(spec, stage)
    if name == "zero" or (isinstance(name, dict) and name.get("zero_axes")):
        raise ValueError(f"DLS_PIPE_SPEC stage {stage}: the 'zero' stage plan "
                         f"(ZeRO weight-update sharding) is not ported yet: "
                         f"ROADMAP Queue 1 item 5")
    if spec.get("mode", "exact") == "exact":
        extra = {a: s for a, s in stage_mesh_axes(spec, stage).items()
                 if a not in BATCH_AXES and s not in (1, -1)}
        if extra:
            raise ValueError(
                f"DLS_PIPE_SPEC stage {stage}: mode='exact' shards rows over "
                f"(data, fsdp) only; this stage mesh also has {extra} — use "
                f"mode='sharded'")


def synthetic_batch_fn(spec: dict) -> Callable[[int], dict]:
    """Deterministic pure-function-of-step batch stream (JAX's bytes): the
    property that makes resync rollback trivial (re-running step *s*
    reproduces its batch bit-for-bit at any attempt, on any stage
    geometry)."""
    b = int(spec.get("batch_size", 8))
    t = int(spec.get("seq", 32))
    vocab = int((spec.get("cfg") or {}).get("vocab_size", 512))
    data_seed = int(spec.get("data_seed", 1234))

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng(data_seed + step)
        return {
            "input_ids": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "loss_mask": np.ones((b, t), np.float32),
        }

    return batch_fn


def param_digests(params: dict[str, torch.Tensor]) -> dict[str, str]:
    """Each param's bytes under SHA-256 (16 hex digits), hashed on the
    host, a sharded param gathered whole first (a collective: every rank of
    its gang calls it): two runs' final params compare bit for bit through
    their summaries, without a checkpoint, whatever their layouts."""
    return {n: hashlib.sha256(sharding.full(p.detach()).to("cpu").contiguous()
                              .reshape(-1).view(torch.uint8).numpy()).hexdigest()[:16]
            for n, p in params.items()}


def _layout(model: torch.nn.Module, params: dict[str, torch.Tensor]) -> dict:
    """How a stage's params lie: each sharded param's mesh axes and
    placements, and how many modules FSDP2 wraps."""
    from torch.distributed.fsdp import FSDPModule

    return {"sharded": {n: [list(p.device_mesh.mesh_dim_names or ()),
                            [f"Shard({x.dim})" if x.is_shard() else type(x).__name__
                             for x in p.placements]]
                        for n, p in params.items() if sharding.is_sharded(p)},
            "fsdp_modules": sum(isinstance(m, FSDPModule) for m in model.modules())}


def stage_summary(runner: PipelineStageRunner, result: dict) -> dict:
    """What a stage reports at its end (every rank calls it; the lead's is
    the stage's): its steps, losses, transport and gang stats, its layout,
    its final params' digests (:func:`param_digests`) and each rank's pid,
    params held, K1/K2/K3 launches and (on a card) peak memory."""
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa

    prog = runner.program
    state = result["state"]
    card = {"rank": runner.gang.rank, "pid": os.getpid(),
            "params": sum(sharding.local(p).numel() for p in state.params.values()),
            "flash_launches": {k.__name__: k.launches
                               for k in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}}
    if prog.device.type == "cuda":
        card["max_memory_allocated"] = torch.cuda.max_memory_allocated(prog.device)
    out = {"stage": prog.stage, "step": result["step"], "losses": result["losses"],
           "attempt": int(os.environ.get("DLS_RESTART", "0") or 0),
           "mesh": prog.mesh.shape if prog.mesh is not None else None,
           "mode": prog.mode, "plan": prog.plan.name if prog.plan is not None else None,
           "params": sum(p.numel() for p in state.params.values()),
           "stats": result["stats"], "layout": _layout(prog.model, state.params),
           "flash_launches": card["flash_launches"]}
    if "max_memory_allocated" in card:
        out["max_memory_allocated"] = card["max_memory_allocated"]
    out["param_digests"] = param_digests(state.params)
    if runner.gang.size > 1:
        import torch.distributed as dist

        cards = [None] * runner.gang.size
        dist.all_gather_object(cards, card, group=runner.gang.ctrl)
        out["ranks"] = cards
    else:
        out["ranks"] = [card]
    return out


def _join_stage_gang(device: torch.device, spec: dict, stage: int):
    """This process's place in its stage's gang: the stage's process group
    (NCCL on a card, gloo on the CPU, as a ``Session``'s gang joins it; no
    fallback), its :class:`~..parallel.mesh.Mesh` from the spec's stage
    mesh, its gloo control group (None on the CPU: the stage's own group is
    gloo) and its device; no mesh and no group for a stage of one
    process."""
    from distributeddeeplearningspark_tpu_torch.session import _device_mesh, _join_group
    from distributeddeeplearningspark_tpu_torch.utils.env import (
        NUM_PROCESSES_ENV,
        distributed_env,
    )

    n = int(os.environ.get(NUM_PROCESSES_ENV) or 1)
    shape = MeshSpec(**stage_mesh_axes(spec, stage)).shape(n)
    if n == 1:
        return None, None, device
    env = distributed_env()
    import datetime

    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", env.rank)
        torch.cuda.set_device(device)
    _join_group(env, device)
    device_mesh, groups = _device_mesh(shape, env.rank, device)
    ctrl = (dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=CTRL_TIMEOUT_S))
            if device.type == "cuda" else None)
    return Mesh(shape, device_mesh, groups, env.rank), ctrl, device


def stage_main() -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    touch_heartbeat()
    spec = json.loads(os.environ[mpmd.ENV_SPEC])
    stage = int(os.environ[mpmd.ENV_STAGE])
    num_stages = int(os.environ[mpmd.ENV_NUM_STAGES])
    refuse_multi_card_stage(spec, stage)
    mode = spec.get("mode", "exact")
    device = resolve_device(spec.get("device", "cuda"))
    mesh, ctrl, device = _join_stage_gang(device, spec, stage)
    rank = mesh.rank if mesh is not None else 0
    workdir = os.environ.get(telemetry_lib.WORKDIR_ENV)
    if workdir and rank == 0:  # the lead writes the stage's telemetry
        telemetry_lib.configure(workdir, process=f"p{stage}")
    cfg = _tiny_cfg(spec)
    init_params = None
    if spec.get("init_params"):
        init_params = torch.load(spec["init_params"], map_location="cpu",
                                 weights_only=True)
    program = LlamaStageProgram(
        cfg, stage, num_stages, _optimizer(spec), device=device, mode=mode,
        loss_mode=spec.get("loss_mode",
                           "full_batch" if mode == "exact"
                           else "per_microbatch"),
        init_params=init_params, mesh=mesh,
        plan=stage_plan_of(spec, stage, cfg) if mode == "sharded" else None)
    gang = StageGang(program, ctrl)
    transport = mpmd.PipelineTransport.from_env(
        depth=int(spec.get("depth", 2)), pinned=device.type == "cuda",
        tick=touch_heartbeat) if gang.lead else None
    ckpt = None
    if workdir and spec.get("checkpoint_every"):
        from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer

        ckpt = Checkpointer(os.path.join(workdir, f"stage{stage}", "ckpt"),
                            async_save=False)
    run = StageRunConfig(
        steps=int(spec["steps"]),
        batch_size=int(spec.get("batch_size", 8)),
        microbatches=int(spec.get("microbatches", 4)),
        checkpoint_every=spec.get("checkpoint_every"),
        seed=int(spec.get("seed", 0)),
    )
    runner = PipelineStageRunner(
        program, transport, run,
        batch_fn=synthetic_batch_fn(spec) if stage == 0 else None,
        checkpointer=ckpt, gang=gang)
    logger.info("stage %d/%d rank %d/%d: mesh %s mode=%s on %s serving pipeline",
                stage, num_stages, gang.rank, gang.size,
                mesh.shape if mesh is not None else None, mode, device)
    try:
        result = runner.run()
    finally:
        if ckpt is not None:
            ckpt.close()
        if transport is not None:
            transport.close()
    if workdir:
        summary = stage_summary(runner, result)
        if gang.lead:
            path = os.path.join(workdir, f"stage{stage}",
                                f"summary-{summary['attempt']}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(summary, f)
            if stage == 0:
                with open(os.path.join(workdir, "DONE"), "w") as f:
                    json.dump({"step": result["step"], "losses": result["losses"],
                               "attempt": summary["attempt"]}, f)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(stage_main())

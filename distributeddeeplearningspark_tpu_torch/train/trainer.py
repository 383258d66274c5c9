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
lap's split in the JAX package's anatomy keys (``anatomy_wall_s``;
``device_s``, the host time spent in the train step's calls and waiting at
the lap's sync; ``input_wait_s``; ``host_s``, the rest), so the JAX
package's ``dlstatus --anatomy`` reads it.

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
``truncate_ckpt`` after a save. Each log lap stamps the supervisor's
liveness file (``DLS_HEARTBEAT_FILE``). ``eval_every`` runs
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

Not ported yet: the graceful preemption drain (a ``sigterm`` fault or a
preemption notice raises; ROADMAP Queue 1 item 7); sharding plans and
rules; ``profile``, ``measure_flops`` and ``tensorboard_dir`` (Queue 1
item 9).
"""

from __future__ import annotations

import contextlib
import logging
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
    to_device,
)
from distributeddeeplearningspark_tpu_torch.data.prefetch import (
    StarvationProbe,
    prefetch_to_device,
)
from distributeddeeplearningspark_tpu_torch.metrics import Meter, MetricLogger
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import Session
from distributeddeeplearningspark_tpu_torch.train import embed as embed_lib
from distributeddeeplearningspark_tpu_torch.train import step as step_lib
from distributeddeeplearningspark_tpu_torch.train.optim import GradientTransformation
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from distributeddeeplearningspark_tpu_torch.utils import sanitize

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.trainer")


def _touch_heartbeat() -> None:
    """Stamp the supervisor's liveness file (``DLS_HEARTBEAT_FILE``, set by
    :class:`~..supervisor.Supervisor`) at a log lap: progress between
    checkpoints is then visible to its hang watchdog, and a stuck worker
    stops stamping."""
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


def _skip(it: Iterator, n: int) -> Iterator:
    """``it`` past its first ``n`` items; closing this closes ``it``."""
    for _ in range(n):
        if next(it, None) is None:
            return
    yield from it


def _lap_anatomy(lap_s: float, dispatch_s: float, drain_s: float,
                 dispatches: int, input_wait_s: float, num_chips: int) -> dict:
    """A lap's wall split in the JAX package's anatomy keys: ``device_s``
    is the host time given to the device (the train step's calls and the
    wait at the lap's sync), ``host_s`` the rest after the input wait."""
    device = dispatch_s + drain_s
    return dict(anatomy_wall_s=lap_s, device_s=device,
                device_dispatch_s=dispatch_s, device_drain_s=drain_s,
                host_s=max(0.0, lap_s - device - input_wait_s),
                compile_in_lap_s=0.0, device_dispatches=dispatches,
                num_chips=num_chips)


def _overlay(live: dict[str, torch.Tensor], new: dict[str, Any], what: str
             ) -> None:
    """Copy each of ``new`` into ``live``'s tensor of its name, in place,
    cast to its dtype, after checking every shape."""
    for k, v in new.items():
        if tuple(v.shape) != tuple(live[k].shape):
            raise ValueError(f"{what} {k}: shape {tuple(v.shape)} != model "
                             f"{tuple(live[k].shape)}")
    with torch.no_grad():
        for k, v in new.items():
            live[k].copy_(torch.as_tensor(v))


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
    the predicate the optimizer is ``masked`` with."""

    def __init__(self, session: Session | None, model: torch.nn.Module,
                 loss_fn: Callable, optimizer: GradientTransformation, *,
                 seed: int = 0,
                 sparse_embed: Sequence[embed_lib.SparseEmbedSpec] = (),
                 checkpointer: Checkpointer | None = None,
                 accum_steps: int = 1,
                 trainable: Callable[[str], bool] | None = None):
        self.session = session or Session.get_or_default()
        self.device = self.session.device
        wrong = {str(p.device) for p in model.parameters()
                 if p.device != self.device}
        if wrong:
            raise ValueError(f"model params lie on {sorted(wrong)}, the "
                             f"session's device is {self.device}")
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
        self.accum_steps = accum_steps
        self.trainable = trainable
        self._guard_nonfinite = False  # fit(on_nonfinite="skip") rebuilds
        self._build_train_step()
        self._eval_step = step_lib.make_eval_step(model, loss_fn)

    def _build_train_step(self) -> None:
        if self.sparse_embed:
            self._train_step = embed_lib.make_sparse_embed_train_step(
                self.model, self.tx, self.loss_fn, self.sparse_embed,
                distributed=self.session.distributed)
        else:
            self._train_step = step_lib.make_train_step(
                self.model, self.tx, self.loss_fn,
                distributed=self.session.distributed, trainable=self.trainable,
                accum_steps=self.accum_steps,
                guard_nonfinite=self._guard_nonfinite)

    def init(self) -> TrainState:
        """The initial state: the model's params, the optimizer's state
        (over the params that train, are not sparse tables and pass the
        optimizer's mask), the dropout generator seeded from ``seed``, the
        model's buffers (BatchNorm statistics) and the sparse tables' zero
        row accumulators."""
        params = dict(self.model.named_parameters())
        trains = (embed_lib.dense_trainable(self.sparse_embed)
                  if self.sparse_embed else self.trainable)
        names = step_lib.optimizer_params(params, self.tx, trains)
        self.state = TrainState(
            step=0, params=params,
            opt_state=self.tx.init([params[n] for n in names]),
            generator=torch.Generator(self.device).manual_seed(self.seed),
            mutable=dict(self.model.named_buffers()),
            embed_state=embed_lib.init_embed_state(self.sparse_embed, params))
        logger.info("initialized %s params on %s",
                    f"{self.state.num_params:,}", self.device)
        return self.state

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
        raise; without, each kind is logged as a warning. ``batch_stats``:
        the model's buffers (BatchNorm's running statistics) by name,
        overlaid the same way."""
        if self.state is None:
            raise RuntimeError("call init() before load_pretrained()")
        live = self.state.params
        seen = set(params) & set(live)
        extra = set(params) - seen
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

    def _host_feed(self, dataset: PartitionedDataset, batch_size: int,
                   **kw) -> Iterator[dict]:
        """This rank's rows of each global batch (JAX's shard mapping)."""
        n = self.session.default_parallelism
        return host_batches(dataset, batch_size, num_shards=n,
                            shard_range=process_shard_range(n), **kw)

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
        and ``die_host`` at its step and ``truncate_ckpt`` after a save; a
        ``sigterm`` fault or a preemption-notice path raises, since the
        graceful drain is not ported (ROADMAP Queue 1 item 7)."""
        if on_nonfinite not in ("raise", "skip", "rollback"):
            raise ValueError(
                f"on_nonfinite must be 'raise'|'skip'|'rollback', got "
                f"{on_nonfinite!r}")
        if on_nonfinite == "skip" and self.sparse_embed:
            raise ValueError(
                "on_nonfinite='skip' is not supported with sparse_embed "
                "tables (the row-sparse step has no update guard); use "
                "'rollback' or 'raise'")
        if faults.sigterm_fault() is not None or faults.preempt_notice_path():
            raise NotImplementedError(
                "a preemption notice (DLS_FAULT=sigterm@N or "
                f"{faults.PREEMPT_NOTICE_ENV}) asks for the graceful drain "
                "and live handoff, which the port does not have yet (ROADMAP "
                "Queue 1 item 7); refusing to train as if none was given")
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
        if self.state is None:
            self.init()
        meter = Meter(examples_per_step=batch_size,
                      tokens_per_step=batch_size * tokens_per_example,
                      num_chips=self.session.num_devices)
        tele = self._telemetry()
        mlog = MetricLogger(telemetry=tele)
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
        skipped_dev = None  # the device's running count of skipped steps
        n_skipped = 0
        rollbacks = 0
        probe = StarvationProbe() if tele is not None else None
        if tele is not None:
            tele.emit("phase", name="run", edge="begin", step=step_i,
                      attempt=int(os.environ.get("DLS_RESTART", "0") or 0))
            tele.heartbeat(step=step_i)
        feed = self._feed(dataset, batch_size, skip_batches=skip, probe=probe)
        meter.start()
        lap_start = step_i
        last_metrics: dict[str, float] = {}
        got_batch = False
        dispatch_s = 0.0
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
                t0 = time.perf_counter()
                self.state, metrics = self._train_step(self.state, batch)
                dispatch_s += time.perf_counter() - t0
                metrics.pop("weight", None)  # eval-aggregation detail
                step_i += 1
                if "skipped" in metrics:
                    # a device-side add a step; fetched only at log points
                    s = metrics["skipped"]
                    skipped_dev = s if skipped_dev is None else skipped_dev + s
                if step_i % log_every == 0 or (steps is not None and step_i >= steps):
                    # the copy to the host waits for this step: the lap
                    # boundary is a true sync point, so the timing is honest
                    t0 = time.perf_counter()
                    fetched = _to_host(metrics)
                    drain_s = time.perf_counter() - t0
                    last_metrics = meter.lap(step_i - lap_start, fetched)
                    lap_start = step_i
                    lap_s, lap_n = meter.last_lap or (0.0, 0)
                    mlog.log(step_i, {**last_metrics, **meter.summary()})
                    _touch_heartbeat()
                    if tele is not None:
                        snap = probe.snapshot()
                        tele.step_metrics(
                            step_i, steps=lap_n, lap_s=lap_s, metrics=last_metrics,
                            **snap, **_lap_anatomy(
                                lap_s, dispatch_s, drain_s, lap_n,
                                snap["input_wait_s"], self.session.num_devices))
                        tele.heartbeat(step=step_i)
                    dispatch_s = 0.0
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
            feed.close()
            if tele is not None:
                tele.emit("phase", name="run", edge="end", step=step_i)
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
            if step_i % checkpoint_every:
                save(step_i)
            ckpt.wait()
        return self.state, summary

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
                sums = collectives.all_reduce_sum_(vec).tolist()
                for k, v in zip(m, sums[1:]):
                    totals[k] = totals.get(k, 0.0) + v
                wsum += sums[0]
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

        In a gang the outputs are gathered, so every rank yields the whole
        global row stream — with ``with_inputs``, only the rows whose inputs
        it holds. As in JAX, a tail that cannot fill every rank equally is
        then dropped."""
        n = self.session.default_parallelism
        srange = process_shard_range(n)
        gather = self.session.distributed and self.session.world_size > 1
        self.model.eval()
        for host_batch in self._host_feed(dataset, batch_size,
                                          drop_remainder=False):
            with torch.inference_mode():
                out = self.model(to_device(host_batch, self.device))
                if output_fn is not None:
                    out = output_fn(out)
                if gather:
                    out = _tree_map(collectives.all_gather_rows, out)
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

"""Trainer — the driver-side loop, the port of ``train/trainer.py``.

``Trainer(session, model, loss_fn, optimizer)`` binds a model on the
session's device to a loss and an optax-shaped optimizer
(:mod:`.optim`); :meth:`Trainer.fit` feeds batches from a
:class:`~..rdd.PartitionedDataset` through the train step and syncs with
the device only at log points, where it laps the :class:`~..metrics.Meter`,
logs, writes a ``step_metrics`` record (when ``DLS_TELEMETRY_DIR`` names a
workdir) and raises on a non-finite metric, as the JAX loop's default
``on_nonfinite="raise"`` does.

``sparse_embed`` specs (:mod:`.embed`) train their tables row-sparsely:
the step gathers the batch's rows outside autograd and applies row-wise
AdaGrad to them, and the optimizer state is built over the other params
only, so no moment of table size exists.

One device. Not ported yet: checkpoints and resume, ``accum_steps``,
``trainable``, ``on_nonfinite="skip"|"rollback"``, sharding plans and
rules, eval during fit, callbacks, profiling, sanitize and TensorBoard,
``predict``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Sequence

import torch

from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib
from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
from distributeddeeplearningspark_tpu_torch.metrics import Meter, MetricLogger
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import Session
from distributeddeeplearningspark_tpu_torch.train import embed as embed_lib
from distributeddeeplearningspark_tpu_torch.train import step as step_lib
from distributeddeeplearningspark_tpu_torch.train.optim import GradientTransformation
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.trainer")


def _to_host(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Device metrics → floats with one copy (one sync)."""
    if not metrics:
        return {}
    vals = torch.stack([torch.as_tensor(v).float().reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


class Trainer:
    """Bind (session, model, loss, optimizer) into a train loop.

    ``model(batch, generator=g)`` returns the outputs consumed by
    ``loss_fn(outputs, batch) → (loss, metrics)``; its params must lie on
    the session's device. ``seed`` seeds the generator the dropout masks
    are drawn from (the weights come from the model's own seed).
    ``sparse_embed``: :class:`~.embed.SparseEmbedSpec` s of the tables that
    train row-sparsely (``models.dlrm.sparse_embed_specs``); the model then
    takes ``overrides`` in train mode."""

    def __init__(self, session: Session | None, model: torch.nn.Module,
                 loss_fn: Callable, optimizer: GradientTransformation, *,
                 seed: int = 0,
                 sparse_embed: Sequence[embed_lib.SparseEmbedSpec] = ()):
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
        self.state: TrainState | None = None
        self.sparse_embed = tuple(sparse_embed)
        names = dict(model.named_parameters())
        missing = [s.param_path for s in self.sparse_embed if s.param_path not in names]
        if missing:
            raise ValueError(f"sparse_embed tables {missing} are not params of "
                             f"the model")
        if self.sparse_embed:
            self._train_step = embed_lib.make_sparse_embed_train_step(
                model, optimizer, loss_fn, self.sparse_embed)
        else:
            self._train_step = step_lib.make_train_step(model, optimizer, loss_fn)
        self._eval_step = step_lib.make_eval_step(model, loss_fn)

    def init(self) -> TrainState:
        """The initial state: the model's params, the optimizer's state
        (over the params that are not sparse tables), the dropout generator
        seeded from ``seed``, the model's buffers (BatchNorm statistics) and
        the sparse tables' zero row accumulators."""
        params = dict(self.model.named_parameters())
        dense = embed_lib.dense_trainable(self.sparse_embed)
        self.state = TrainState(
            step=0, params=params,
            opt_state=self.tx.init([p for n, p in params.items() if dense(n)]),
            generator=torch.Generator(self.device).manual_seed(self.seed),
            mutable=dict(self.model.named_buffers()),
            embed_state=embed_lib.init_embed_state(self.sparse_embed, params))
        logger.info("initialized %s params on %s",
                    f"{self.state.num_params:,}", self.device)
        return self.state

    def _telemetry(self) -> telemetry_lib.EventWriter | None:
        """The run's event writer when ``DLS_TELEMETRY_DIR`` names a
        workdir, else None (then fit costs nothing extra)."""
        workdir = os.environ.get(telemetry_lib.WORKDIR_ENV)
        return telemetry_lib.configure(workdir) if workdir else None

    def fit(self, dataset: PartitionedDataset, *, batch_size: int,
            steps: int | None = None, tokens_per_example: int = 0,
            log_every: int = 10) -> tuple[TrainState, dict[str, float]]:
        """Train until the state's step reaches ``steps`` (or the dataset is
        exhausted). Returns (final state, summary): the :class:`Meter`'s
        summary (``step_time_ms``, ``examples_per_sec_per_chip`` — images/s
        for a vision model —, ``tokens_per_sec_per_chip`` when
        ``tokens_per_example`` is given, ...) and the last logged metrics."""
        if self.state is None:
            self.init()
        meter = Meter(examples_per_step=batch_size,
                      tokens_per_step=batch_size * tokens_per_example,
                      num_chips=self.session.num_devices)
        tele = self._telemetry()
        mlog = MetricLogger()
        step_i = self.state.step
        if tele is not None:
            tele.emit("phase", name="run", edge="begin", step=step_i,
                      attempt=int(os.environ.get("DLS_RESTART", "0") or 0))
            tele.heartbeat(step=step_i)
        meter.start()
        lap_start = step_i
        last_metrics: dict[str, float] = {}
        try:
            for batch in device_batches(dataset, batch_size, self.device):
                if steps is not None and step_i >= steps:
                    break
                self.state, metrics = self._train_step(self.state, batch)
                metrics.pop("weight", None)  # eval-aggregation detail
                step_i += 1
                if step_i % log_every == 0 or (steps is not None and step_i >= steps):
                    # the copy to the host waits for this step: the lap
                    # boundary is a true sync point, so the timing is honest
                    last_metrics = meter.lap(step_i - lap_start, _to_host(metrics))
                    lap_start = step_i
                    lap_s, lap_n = meter.last_lap or (0.0, 0)
                    mlog.log(step_i, {**last_metrics, **meter.summary()})
                    if tele is not None:
                        tele.step_metrics(step_i, steps=lap_n, lap_s=lap_s,
                                          metrics=last_metrics)
                        tele.heartbeat(step=step_i)
                    bad = {k: v for k, v in last_metrics.items()
                           if not math.isfinite(v)}
                    if bad:
                        raise FloatingPointError(
                            f"non-finite metrics at step {step_i}: {bad}")
        finally:
            if tele is not None:
                tele.emit("phase", name="run", edge="end", step=step_i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.state, {**meter.summary(), **last_metrics}

    def evaluate(self, dataset: PartitionedDataset, *, batch_size: int
                 ) -> dict[str, float]:
        """Weighted-mean metrics over the whole dataset, the short tail
        batch included (marked with ``eval_mask``), combined by the loss's
        ``"weight"`` metric when it reports one, else by rows. The model
        runs in eval mode (BatchNorm on its running statistics)."""
        totals: dict[str, float] = {}
        wsum = 0.0
        for batch in device_batches(dataset, batch_size, self.device,
                                    drop_remainder=False, pad_remainder=True):
            rows = next(iter(batch.values())).shape[0]
            m = _to_host(self._eval_step(batch))
            if "eval_mask" in batch and "weight" not in m:
                raise RuntimeError(
                    "the loss ignored the tail batch's eval_mask (no "
                    "'weight' metric reported): weight per-row metrics by "
                    "batch['eval_mask'] and report weight=mask.sum()")
            w = float(m.pop("weight", rows))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v * w
            wsum += w
        return {k: v / max(wsum, 1e-9) for k, v in totals.items()}

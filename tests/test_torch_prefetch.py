"""The port's device prefetch and starvation probe (``data/prefetch.py``) and
``Trainer.fit``/``evaluate`` through them, on the CPU.

- ``StarvationProbe`` with a fake clock gives the JAX package's snapshot on
  the same calls.
- ``prefetch_to_device`` keeps the host stream's order, raises a producer
  error in the consumer, and closing the consumer early stops and joins
  the ``dls-prefetch`` thread and reaps the worker pool behind it.
- A small BERT trained over ``mlm_dataset(num_workers=2)`` gives the bits
  of the run with 0 workers, and a resume the bits of an uninterrupted
  run; its ``step_metrics`` carry the probe's and the pool's gauges, which
  the JAX package's ``dlstatus`` reads (``input_workers_from``, the
  ``--anatomy`` input-wait line). After ``fit``, ``evaluate`` and a
  ``WorkerCrashed``, no worker, segment or prefetch thread is left.

Every wait is bounded: the prefetch's own waits poll, and each test checks
its elapsed time.
"""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import status
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import prefetch as jprefetch
from distributeddeeplearningspark_tpu.telemetry import anatomy as janatomy
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.data import workers as W
from distributeddeeplearningspark_tpu_torch.data.feed import device_batches, host_batches
from distributeddeeplearningspark_tpu_torch.data.prefetch import (
    StarvationProbe,
    prefetch_to_device,
)
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from test_torch_deadline import bounded, per_test

DEADLINE_S = 30.0
SEQ, BATCH, STEPS, LOG_EVERY = 64, 4, 6, 2


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _live() -> dict:
    return dict(
        threads={t for t in threading.enumerate() if t.name == "dls-prefetch"},
        workers={p for p in mp.active_children() if p.name.startswith("dls-worker")},
        segments={f for f in os.listdir("/dev/shm")
                  if f.startswith(f"dlsw-{os.getpid()}-")})


def leftovers(before: dict) -> dict:
    """What of the input path started since ``before`` (a :func:`_live`
    snapshot) is still alive: prefetch threads, pool workers, shared-memory
    segments. The JAX package's threads and workers share these names, and
    its ``fit`` leaves its prefetch thread parked on the ring, so only what
    is new counts. Children and threads get a bounded moment to end."""
    deadline = time.monotonic() + 5.0
    while True:
        left = {k: sorted(getattr(x, "name", x) for x in v - before[k])
                for k, v in _live().items()}
        if not any(left.values()) or time.monotonic() > deadline:
            return {k: v for k, v in left.items() if v}
        time.sleep(0.05)


@pytest.fixture
def before():
    return _live()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_probe_snapshot_matches_jax_on_the_same_calls():
    probes = []
    for cls in (StarvationProbe, jprefetch.StarvationProbe):
        clock = FakeClock()
        p = cls(clock=clock)
        for dt, depth in ((0.5, 0), (0.25, 2), (1.0, 1)):
            p.record_depth(depth)
            p.record_wait(dt)
        p.record_assembly(0.75)

        def slow():
            for i in range(3):
                clock.t += 0.125 * (i + 1)
                yield i

        assert list(p.timed(slow())) == [0, 1, 2]
        first = p.snapshot()
        probes.append((first, p.snapshot(reset=False)))
    assert probes[0] == probes[1]
    first, after = probes[0]
    assert first["input_wait_s"] == 0.5 + 0.25 + 1.0 + 0.125 + 0.25 + 0.375
    assert first["input_waits"] == 6 and first["prefetch_depth_min"] == 0
    assert after == {"input_wait_s": 0.0, "input_waits": 0, "input_wait_max_s": 0.0,
                     "input_assembly_s": 0.0}


def _numbered(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"bad batch {i}")
        yield {"x": np.full((3, 2), i, np.float32), "i": np.array([i], np.int64)}


@pytest.mark.parametrize("background", [True, False])
def test_prefetch_keeps_order_and_probes(background, before):
    probe = StarvationProbe()
    t0 = time.monotonic()
    got = list(prefetch_to_device(_numbered(9), "cpu", background=background,
                                  probe=probe))
    assert time.monotonic() - t0 < DEADLINE_S
    assert [int(b["i"][0]) for b in got] == list(range(9))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
               and float(b["x"][0, 0]) == i for i, b in enumerate(got))
    snap = probe.snapshot()
    assert snap["input_waits"] == 9
    assert ("prefetch_depth_mean" in snap) == background
    assert (snap["input_assembly_s"] > 0) == background
    assert not leftovers(before)


def test_producer_error_reaches_the_consumer(before):
    it = prefetch_to_device(_numbered(9, fail_at=4), "cpu", buffer_size=2)
    got = []
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="bad batch 4"):
        for b in it:
            got.append(int(b["i"][0]))
    assert time.monotonic() - t0 < DEADLINE_S
    assert got == [0, 1, 2, 3]
    assert not leftovers(before)


def _pooled(n=400, parts=2, workers=2):
    rows = [{"x": np.full((8, 8), i, np.float32)} for i in range(n)]
    return W.WorkerMappedDataset(PartitionedDataset.parallelize(rows, parts).repeat(),
                                 lambda ex: {"x": ex["x"] + 1.0}, workers)


def test_early_close_stops_the_thread_and_reaps_the_pool(before):
    """The consumer stops after 3 batches of an endless pooled stream: the
    producer, parked on the full ring, stops, closes the host iterator in
    its thread (the pools reap their workers and unlink their segments)
    and is joined before ``close`` returns."""
    it = prefetch_to_device(host_batches(_pooled(), 4), "cpu", buffer_size=2)
    got = [float(next(it)["x"][0, 0, 0]) for _ in range(3)]
    assert got == [1.0, 3.0, 5.0]  # partitions dealt in turn
    assert len(_live()["threads"] - before["threads"]) == 1
    assert W.pool_gauges()["input_workers"] == 2
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < DEADLINE_S
    assert not _live()["threads"] - before["threads"]
    assert W.pool_gauges() == {}
    assert not leftovers(before)


def test_abandoned_device_batches_reaps_the_pool(before):
    it = device_batches(_pooled(), 4, torch.device("cpu"), num_workers=1)
    assert float(next(it)["x"][0, 0, 0]) == 1.0
    assert W.pool_gauges()["input_workers"] == 2  # at least one a partition
    del it
    assert not leftovers(before)


# -- Trainer.fit and evaluate through the prefetch and a pool ------------------


def _corpus():
    docs = ttext.synthetic_wikipedia(48, num_partitions=2, seed=1)
    return docs, ttext.WordPieceTokenizer.train(docs.collect(), vocab_size=64)


def _trainer(spark, checkpointer=None):
    model = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=2, dropout_rate=0.1,
                                                   max_position=SEQ), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    tx = optim.with_grad_clip(optim.adamw(optim.warmup_linear(2e-3, 2, STEPS)), 1.0)
    return Trainer(spark, model, losses.masked_lm, tx, checkpointer=checkpointer)


def _dataset(num_workers):
    docs, tok = _corpus()
    return ttext.mlm_dataset(docs, tok, seq_len=SEQ, max_predictions=10,
                             num_workers=num_workers).repeat()


def _fit(spark, workdir, num_workers, mp_):
    mp_.setenv(ttele.WORKDIR_ENV, str(workdir))
    try:
        state, _ = _trainer(spark).fit(_dataset(num_workers), batch_size=BATCH,
                                       steps=STEPS, tokens_per_example=SEQ,
                                       log_every=LOG_EVERY)
    finally:
        ttele.reset()
        mp_.delenv(ttele.WORKDIR_ENV)
    return {k: v.detach().clone() for k, v in state.params.items()}


@pytest.fixture(scope="module")
@bounded()
def runs(tmp_path_factory):
    """The same BERT run at 0 and at 2 workers, and at 2 workers in two
    halves with a restore between them: (workdirs, params by run, what was
    left after each fit)."""
    root = tmp_path_factory.mktemp("fit")
    mp_ = pytest.MonkeyPatch()
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    params, left = {}, {}
    start = _live()
    try:
        for n in (0, 2):
            params[n] = _fit(spark, root / f"w{n}", n, mp_)
            left[n] = leftovers(start)
        with Checkpointer(root / "ck", async_save=False) as ck:
            _trainer(spark, ck).fit(_dataset(2), batch_size=BATCH, steps=STEPS // 2,
                                    checkpoint_every=STEPS // 2, log_every=LOG_EVERY)
            resumed = _trainer(spark, ck)
            _, data_state = resumed.restore()
            state, _ = resumed.fit(_dataset(2), batch_size=BATCH, steps=STEPS,
                                   log_every=LOG_EVERY, data_state=data_state)
        ttele.reset()
        params["resumed"] = {k: v.detach().clone() for k, v in state.params.items()}
        left["resumed"] = leftovers(start)
        yield root, params, left, spark
    finally:
        spark.stop()
        ttele.reset()
        mp_.undo()


def _laps(workdir):
    return [e for e in jtele.read_events(str(workdir)) if e["kind"] == "step_metrics"]


def test_fit_with_workers_gives_the_bits_of_fit_without(runs):
    root, params, left, _ = runs
    losses0 = [e["metrics"]["loss"] for e in _laps(root / "w0")]
    losses2 = [e["metrics"]["loss"] for e in _laps(root / "w2")]
    assert len(losses0) == STEPS // LOG_EVERY and losses0 == losses2
    assert params[0].keys() == params[2].keys()
    assert all(torch.equal(params[0][k], params[2][k]) for k in params[0])
    assert left == {0: {}, 2: {}, "resumed": {}}


def test_resume_with_workers_gives_the_bits_of_an_uninterrupted_run(runs):
    _, params, *_ = runs
    assert all(torch.equal(params["resumed"][k], params[2][k]) for k in params[2])


def test_step_metrics_carry_the_gauges_and_dlstatus_reads_them(runs):
    root, *_ = runs
    laps = _laps(root / "w2")
    assert all(e["input_wait_s"] >= 0 and e["input_waits"] == LOG_EVERY
               and "prefetch_depth_mean" in e and e["anatomy_wall_s"] == e["lap_s"]
               for e in laps)
    workers = [e["input_workers"] for e in laps if "input_workers" in e]
    assert workers and set(workers) <= {1, 2} and 2 in workers
    assert all("input_workers" not in e for e in _laps(root / "w0"))
    events = jtele.read_events(str(root / "w2"))
    pool = status.input_workers_from(events)
    assert pool is not None and pool["input_workers"] in (1, 2)
    assert pool["worker_items"] > 0
    report = janatomy.anatomy_report(events)
    assert report["steps"]["steps"] == STEPS and report["steps"]["laps"] == len(laps)
    assert report["steps"]["input_wait_s"] == pytest.approx(
        sum(e["input_wait_s"] for e in laps), abs=1e-5)
    lines = status.render_anatomy(report)
    assert any(line.lstrip().startswith("input-wait") for line in lines), lines


def test_evaluate_through_the_prefetch_leaves_nothing(runs, before):
    *_, spark = runs
    docs, tok = _corpus()
    ds = ttext.mlm_dataset(docs, tok, seq_len=SEQ, max_predictions=10)
    pooled = ttext.mlm_dataset(docs, tok, seq_len=SEQ, max_predictions=10,
                               num_workers=2)
    trainer = _trainer(spark)
    want = trainer.evaluate(ds, batch_size=3)
    got = trainer.evaluate(pooled, batch_size=3)
    assert got == want and np.isfinite(got["loss"])
    assert not leftovers(before)


def test_a_raising_worker_ends_fit_with_worker_crashed(runs, before):
    *_, spark = runs
    rows = [{"x": np.ones(8, np.float32), "label": np.int32(i % 2)} for i in range(64)]

    def poisoned(ex):
        if int(ex["label"]) == 1 and ex["x"][0] > 0:
            raise ValueError("poisoned example")
        return ex

    ds = W.WorkerMappedDataset(PartitionedDataset.parallelize(rows, 1).repeat(),
                               poisoned, 2)
    model = torch.nn.Sequential(torch.nn.Linear(8, 2))
    trainer = Trainer(spark, _Wrap(model), losses.softmax_xent, optim.sgd(0.1))
    t0 = time.monotonic()
    with pytest.raises(W.WorkerCrashed, match="poisoned example"):
        trainer.fit(ds, batch_size=4, steps=10, log_every=5)
    assert time.monotonic() - t0 < DEADLINE_S
    assert not leftovers(before)


class _Wrap(torch.nn.Module):
    """A model over ``batch["x"]``."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch, generator=None):
        return self.inner(batch["x"])

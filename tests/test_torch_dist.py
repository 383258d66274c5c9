"""Data parallelism over processes: the port at ``local[2]``, two gloo
processes launched by the port's cli, against the JAX package at
``local[2]`` (two devices of one process) and against the port on one
process, mirroring ``tests/test_train_mnist.py``.

One gang runs every scenario: this file is its script (run as ``python
tests/test_torch_dist.py OUTDIR`` by each rank; it imports no jax). Each
rank writes what the tests read into OUTDIR:

- 20 steps of LeNet-5 under ``sgd(0.1)`` from the JAX trainer's initial
  params: the logged losses and the final params, held to JAX's
  (rtol 1e-4, atol 1e-5) and to one process's; the replicas in sync;
- one step's reduced gradient, held to the round loop's average of the
  two halves' gradients (``grad_average``) and to JAX's global-batch gradient;
- a tiny BERT under ``masked_lm`` with 1 masked token a row on rank 0 and
  5 on rank 1: the reduced gradient equals one process's on the whole
  batch;
- ``evaluate`` with a tail of 1 and of 3 rows over the 2 ranks, equal to
  one full-batch pass and to JAX's;
- ``predict``'s stream and its ``with_inputs`` pairs in JAX's feed order;
- LeNet over a ``WorkerMappedDataset`` (2 worker processes a rank) through
  the prefetch: the losses and final params of the run with 0 workers,
  bit for bit, and a resume's bits equal to an uninterrupted run's; the
  steps' telemetry carries the probe's and the pool's gauges, which the
  JAX package's ``dlstatus`` reads, and no worker, segment or prefetch
  thread outlives ``fit``;
- what a Trainer once refused at 2 ranks and now trains with its replicas
  in sync: a model with buffers (ResNet) and ``sparse_embed`` (DLRM).
"""

import json
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import LeNet5, Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data.feed import stack_examples
from distributeddeeplearningspark_tpu_torch.data.workers import WorkerMappedDataset
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from distributeddeeplearningspark_tpu_torch.train.step import make_train_step
from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides; 20 SGD steps compound the order of the sums
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
# one gradient: the reduction's order against the global batch's
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-6
EVAL_RTOL, EVAL_ATOL = 2e-5, 1e-6
GANG_DEADLINE_S = 300
FIT_DATA = dict(num_examples=512, num_partitions=2, seed=1)
EVAL_SIZES = (65, 67)  # batch 32 over 2 ranks: tails of 1 and 3 rows
# the pooled LeNet runs: a budget of 4 workers over the 2 partitions is 2
# worker processes on each rank, which opens only its own partition
POOL_WORKERS, POOL_STEPS = 4, 12


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _capture_tx(store: list):
    """An optimizer that records the gradients it is handed (the reduced
    ones) and moves nothing."""
    def update(updates, state, params):
        store.extend(u.detach().clone() for u in updates)
        return [torch.zeros_like(u) for u in updates], state
    return optim.GradientTransformation(lambda params: (), update)


def _grads_of(model, loss_fn, batch, *, distributed=False) -> dict:
    """The gradient one train step hands its optimizer."""
    store: list = []
    state = TrainState(step=0, params=dict(model.named_parameters()), opt_state=(),
                       generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, _capture_tx(store), loss_fn,
                           distributed=distributed)
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {n: g.numpy() for n, g in zip(state.params, store)}


def _lenet(init: dict) -> LeNet5:
    model = LeNet5(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _round_loop_batch() -> dict:
    return stack_examples(tsources.synthetic_mnist(64, num_partitions=2, seed=3).take(16))


def _bert_batch() -> dict:
    """8 rows of 16 tokens: rows 0-3 with 1 masked token each, 4-7 with 5."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 1024, (8, 16)).astype(np.int32)
    weights = np.zeros((8, 16), np.float32)
    weights[:4, :1] = 1.0
    weights[4:, :5] = 1.0
    return {"input_ids": ids, "attention_mask": np.ones((8, 16), np.int32),
            "mlm_labels": rng.integers(0, 1024, (8, 16)).astype(np.int32),
            "mlm_weights": weights}


def _bert() -> tbert.BertForMLM:
    model = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=1, dropout_rate=0.0),
                             device="cpu")
    return model.init_weights(torch.Generator().manual_seed(0))


def _eval_dataset(size: int) -> PartitionedDataset:
    rows = tsources.synthetic_mnist(128, num_partitions=1, seed=31).collect()[:size]
    return PartitionedDataset.parallelize(rows, 2)


def _predict_dataset():
    return tsources.synthetic_mnist(100, num_partitions=2, seed=3)


def _flip(ex: dict) -> dict:
    """The pooled runs' per-example map (numpy only, as a worker's must be)."""
    return {**ex, "image": np.ascontiguousarray(ex["image"][:, ::-1])}


def _pooled_mnist(num_workers: int) -> WorkerMappedDataset:
    return WorkerMappedDataset(tsources.synthetic_mnist(**FIT_DATA).repeat(), _flip,
                               num_workers)


def _input_leftovers() -> dict:
    """Prefetch threads, pool workers and segments still alive here."""
    deadline = time.monotonic() + 5.0
    while True:
        left = dict(
            threads=[t.name for t in threading.enumerate() if t.name == "dls-prefetch"],
            workers=[p.name for p in mp.active_children()
                     if p.name.startswith("dls-worker")],
            segments=[f for f in os.listdir("/dev/shm")
                      if f.startswith(f"dlsw-{os.getpid()}-")])
        if not any(left.values()) or time.monotonic() > deadline:
            return {k: v for k, v in left.items() if v}
        time.sleep(0.05)


def _pooled_runs(spark, init: dict, outdir: Path) -> dict:
    """LeNet at 0 and POOL_WORKERS workers, then at POOL_WORKERS in two
    halves with a restore between them: whether the params agree bitwise,
    and what of the input path outlived each fit."""
    def fit(num_workers, steps, checkpointer=None, resume=False):
        trainer = Trainer(spark, _lenet(init), losses.softmax_xent,
                          optim.sgd(0.1, momentum=0.9), checkpointer=checkpointer)
        data_state = trainer.restore()[1] if resume else None
        state, _ = trainer.fit(_pooled_mnist(num_workers), batch_size=32, steps=steps,
                               log_every=2, data_state=data_state,
                               checkpoint_every=steps if checkpointer else None)
        return {k: v.detach().clone() for k, v in state.params.items()}

    params, left = {}, {}
    for n in (0, POOL_WORKERS):
        os.environ[ttele.WORKDIR_ENV] = str(outdir / f"pool{n}")
        params[n] = fit(n, POOL_STEPS)
        ttele.reset()
        del os.environ[ttele.WORKDIR_ENV]
        left[n] = _input_leftovers()
    ck = Checkpointer(outdir / "pool_ck", async_save=False)
    fit(POOL_WORKERS, POOL_STEPS // 2, ck)
    params["resumed"] = fit(POOL_WORKERS, POOL_STEPS, ck, resume=True)
    ttele.reset()
    left["resumed"] = _input_leftovers()
    return dict(
        equal=all(torch.equal(params[0][k], params[POOL_WORKERS][k]) for k in params[0]),
        resume_equal=all(torch.equal(params["resumed"][k], params[POOL_WORKERS][k])
                         for k in params[0]),
        left={str(k): v for k, v in left.items()})


def _worker(outdir: Path) -> None:
    """One rank of the gang: every scenario, in order."""
    spark = Session.builder.appName("dist").getOrCreate()
    rank, out = spark.rank, {}
    assert spark.world_size == 2 and spark.backend == "gloo"
    init = dict(np.load(outdir / "init.npz"))

    os.environ[ttele.WORKDIR_ENV] = str(outdir / "fit")
    trainer = Trainer(spark, _lenet(init), losses.softmax_xent,
                      optim.sgd(0.1, momentum=None))
    state, _ = trainer.fit(tsources.synthetic_mnist(**FIT_DATA).repeat(),
                           batch_size=32, steps=20, log_every=1)
    ttele.reset()
    del os.environ[ttele.WORKDIR_ENV]
    collectives.assert_replicas_in_sync(state.params)
    if rank == 0:
        np.savez(outdir / "fit_final.npz",
                 **{k: v.detach().numpy() for k, v in state.params.items()})

    half = {k: v[8 * rank:8 * (rank + 1)] for k, v in _round_loop_batch().items()}
    lenet_grads = _grads_of(_lenet(init), losses.softmax_xent, half, distributed=True)
    bert = {k: v[4 * rank:4 * (rank + 1)] for k, v in _bert_batch().items()}
    bert_grads = _grads_of(_bert(), losses.masked_lm, bert, distributed=True)

    evaluator = Trainer(spark, _lenet(init), losses.softmax_xent, optim.sgd(0.1))
    out["evaluate"] = {size: evaluator.evaluate(_eval_dataset(size), batch_size=32)
                       for size in EVAL_SIZES}
    stream = [int(p) for p in evaluator.predict(
        _predict_dataset(), batch_size=16, output_fn=lambda o: o.argmax(-1))]
    pairs = [(int(ex["label"]), float(ex["image"].sum()), int(p))
             for ex, p in evaluator.predict(_predict_dataset(), batch_size=16,
                                            output_fn=lambda o: o.argmax(-1),
                                            with_inputs=True)]
    out["predict"] = {"stream": stream, "pairs": pairs}

    from distributeddeeplearningspark_tpu_torch.models.dlrm import DLRM, sparse_embed_specs
    from distributeddeeplearningspark_tpu_torch.models.resnet import BasicBlock, ResNet
    from distributeddeeplearningspark_tpu_torch.train.embed import ROW_ACCUM

    def resnet():
        model = ResNet((1,), BasicBlock, num_classes=4, width=8, dtype=torch.float32,
                       device="cpu").init_weights(torch.Generator().manual_seed(0))
        trainer = Trainer(spark, model, losses.softmax_xent, optim.sgd(0.1))
        ds = tsources.synthetic_images(32, image_size=16, num_classes=4,
                                       num_partitions=2).repeat()
        state, summary = trainer.fit(ds, batch_size=8, steps=3, log_every=3)
        return summary, {**state.params, **state.mutable}

    def dlrm():
        model = DLRM((10,) * 26, 8, (16, 8), (16, 1), dtype=torch.float32,
                     device="cpu").init_weights(torch.Generator().manual_seed(0))
        trainer = Trainer(spark, model, losses.binary_xent, optim.adamw(1e-3),
                          sparse_embed=sparse_embed_specs(model, lr=1e-2))
        ds = tsources.synthetic_criteo(64, vocab_sizes=(10,) * 26,
                                       num_partitions=2).repeat()
        state, summary = trainer.fit(ds, batch_size=16, steps=3, log_every=3)
        return summary, {**state.params, **{f"{n}.{ROW_ACCUM}": s[ROW_ACCUM]
                                            for n, s in state.embed_state.items()}}

    trained = {}
    for name, run in (("resnet", resnet), ("sparse_embed", dlrm)):
        summary, replicated = run()
        collectives.assert_replicas_in_sync(replicated, what=name)
        trained[name] = dict(loss=summary["loss"],
                             digest=collectives.params_digest(replicated))
    out["trained"] = trained
    out["pooled"] = _pooled_runs(spark, init, outdir)
    if rank == 0:
        np.savez(outdir / "grads_lenet.npz", **lenet_grads)
        np.savez(outdir / "grads_bert.npz", **bert_grads)
    (outdir / f"rank{rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the test side ------------------------------------------------------------


def run_gang(args: list[str], *, deadline_s: float = GANG_DEADLINE_S,
             env: dict | None = None) -> subprocess.CompletedProcess:
    """The port's cli in a subprocess, bounded: past the deadline the
    launcher is terminated (it stops its ranks), then killed, and the test
    fails."""
    cmd = [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.cli", *args]
    full_env = {**os.environ, **(env or {}),
                "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=full_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=15)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        pytest.fail(f"gang {args} passed its {deadline_s} s deadline")
    except BaseException:  # the test's own deadline: never leave the gang
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    """The JAX run at local[2] (its init params seed the gang), then the
    gang; (outdir, init params, JAX losses, JAX final params)."""
    import jax
    import optax

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.data import sources as jsources
    from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu_torch.models.lenet_io import params_from_flax

    outdir = tmp_path_factory.mktemp("gang")
    jspark = JSession.builder.master("local[2]").getOrCreate()
    jtrainer = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.1))
    jds = jsources.synthetic_mnist(**FIT_DATA)
    jtrainer.init(jtrainer._sample_batch(jds, 32))
    flax_init = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    init = {k: v.numpy() for k, v in params_from_flax(flax_init).items()}
    np.savez(outdir / "init.npz", **init)
    jloss = []
    jtrainer.fit(jds.repeat(), batch_size=32, steps=20, log_every=1,
                 callbacks=[lambda s, m: jloss.append(m["loss"])])
    jfinal = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))).items()}
    jspark.stop()

    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return outdir, init, flax_init, jloss, jfinal


@pytest.fixture
def cpu_spark():
    s = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield s
    s.stop()
    ttele.reset()


def _assert_same_init(jtrainer, flax_init) -> None:
    import jax

    for a, b in zip(jax.tree.leaves(jax.device_get(jtrainer.state.params)),
                    jax.tree.leaves(flax_init)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _rank(outdir, r) -> dict:
    return json.loads((outdir / f"rank{r}.json").read_text())


def _fit_losses(workdir) -> dict:
    from distributeddeeplearningspark_tpu import telemetry as jtele

    by_proc: dict = {}
    for e in jtele.read_events(str(workdir)):
        if e["kind"] == "step_metrics":
            by_proc.setdefault(e["process"], []).append(e["metrics"]["loss"])
    return by_proc


def test_two_processes_match_jax_local2(gang):
    outdir, _, _, jloss, jfinal = gang
    by_proc = _fit_losses(outdir / "fit")
    assert sorted(by_proc) == ["p0", "p1"]
    # the logged metrics are the global batch's, the same on both ranks
    assert by_proc["p0"] == by_proc["p1"] and len(by_proc["p0"]) == 20
    np.testing.assert_allclose(by_proc["p0"], jloss, rtol=FIT_RTOL, atol=FIT_ATOL)
    final = np.load(outdir / "fit_final.npz")
    for k, v in jfinal.items():
        np.testing.assert_allclose(final[k], v, rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=k)


def test_one_process_matches_two(gang, cpu_spark, tmp_path, monkeypatch):
    outdir, init, *_ = gang
    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path))
    trainer = Trainer(cpu_spark, _lenet(init), losses.softmax_xent,
                      optim.sgd(0.1, momentum=None))
    state, _ = trainer.fit(tsources.synthetic_mnist(**FIT_DATA).repeat(),
                           batch_size=32, steps=20, log_every=1)
    ttele.reset()
    np.testing.assert_allclose(_fit_losses(tmp_path)["p0"],
                               _fit_losses(outdir / "fit")["p0"],
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    final = np.load(outdir / "fit_final.npz")
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), final[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)


def test_reduced_gradient_equals_round_loop_average_and_jax(gang, cpu_spark):
    """The step's all-reduced gradient equals the average of the two
    halves' gradients in one process (the reference's treeAggregate round
    loop) and JAX's gradient of the global batch's mean loss."""
    import jax

    from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu_torch.models.lenet_io import params_from_flax

    outdir, init, flax_init, *_ = gang
    got = dict(np.load(outdir / "grads_lenet.npz"))
    batch = _round_loop_batch()
    halves = [{k: v[8 * r:8 * (r + 1)] for k, v in batch.items()} for r in (0, 1)]
    averaged = collectives.grad_average(
        [_grads_of(_lenet(init), losses.softmax_xent, h) for h in halves])

    def jloss(p):
        logits = JLeNet5().apply({"params": p}, batch, train=True)
        return jlosses.softmax_xent(logits, batch)[0]

    jgrads = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(
        np.asarray, jax.grad(jloss)(flax_init))).items()}
    assert set(got) == set(averaged) == set(jgrads)
    for k in got:
        np.testing.assert_allclose(got[k], averaged[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], jgrads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_masked_lm_gradient_exact_with_unequal_masked_tokens(gang, cpu_spark):
    """Rank 0 holds 4 masked tokens, rank 1 holds 20: the step weighs each
    rank's loss by its share, so the reduced gradient is the whole batch's
    (a mean of the two per-rank means would weigh rank 0's tokens 5×)."""
    outdir, *_ = gang
    got = dict(np.load(outdir / "grads_bert.npz"))
    want = _grads_of(_bert(), losses.masked_lm, _bert_batch())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("size", EVAL_SIZES)
def test_evaluate_exact_with_subshard_tail(gang, cpu_spark, size):
    """Both ranks report the same metrics, equal to one process's pass in
    one full batch and to the JAX trainer's at local[2]."""
    import optax

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses

    outdir, init, flax_init, *_ = gang
    got = [_rank(outdir, r)["evaluate"][str(size)] for r in (0, 1)]
    assert got[0] == got[1]
    one = Trainer(cpu_spark, _lenet(init), losses.softmax_xent, optim.sgd(0.1))
    want = one.evaluate(_eval_dataset(size), batch_size=size)
    jspark = JSession.builder.master("local[2]").getOrCreate()
    jt = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.1))
    rows = tsources.synthetic_mnist(128, num_partitions=1, seed=31).collect()[:size]
    jds = JDataset.parallelize(rows, 2)
    jt.init(jt._sample_batch(jds, 4))  # seed 0: the gang's init params
    _assert_same_init(jt, flax_init)
    jwant = jt.evaluate(jds, batch_size=32)
    jspark.stop()
    assert set(got[0]) == set(want) == set(jwant)
    for k in want:
        np.testing.assert_allclose(got[0][k], want[k], rtol=EVAL_RTOL, atol=EVAL_ATOL)
        np.testing.assert_allclose(got[0][k], jwant[k], rtol=EVAL_RTOL, atol=EVAL_ATOL)


def test_predict_keeps_jax_feed_order(gang):
    """Every rank yields the gathered global stream in JAX's feed order;
    with ``with_inputs`` each yields the pairs of its own rows. JAX in one
    process keeps the last 4 rows (2 a shard); its multi-process feed,
    which each rank's is, drops a tail short of a full batch."""
    import jax.numpy as jnp
    import optax

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.data import sources as jsources
    from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
    from distributeddeeplearningspark_tpu.train import losses as jlosses

    outdir, _, flax_init, *_ = gang
    jspark = JSession.builder.master("local[2]").getOrCreate()
    jt = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.1))
    jds = jsources.synthetic_mnist(100, num_partitions=2, seed=3)
    jt.init(jt._sample_batch(jds, 4))
    _assert_same_init(jt, flax_init)
    jpairs = [(int(ex["label"]), float(ex["image"].sum()), int(p))
              for ex, p in jt.predict(jds, batch_size=16, with_inputs=True,
                                      output_fn=lambda o: jnp.argmax(o, -1))]
    jspark.stop()
    ranks = [_rank(outdir, r)["predict"] for r in (0, 1)]
    assert len(jpairs) == 100
    assert ranks[0]["stream"] == ranks[1]["stream"] == [p for *_, p in jpairs[:96]]
    for r, got in enumerate(ranks):
        mine = [jpairs[b * 16 + 8 * r + i] for b in range(6) for i in range(8)]
        assert [tuple(p) for p in got["pairs"]] == mine


def test_two_ranks_refuse_what_would_differ_from_jax(gang):
    """Nothing is refused at 2 ranks any more: a model with BatchNorm
    buffers (ResNet, global statistics) and ``sparse_embed`` tables (DLRM,
    the merged row update) train, and every param, buffer and row
    accumulator is the same bytes on both ranks."""
    ranks = [_rank(gang[0], r)["trained"] for r in (0, 1)]
    assert sorted(ranks[0]) == ["resnet", "sparse_embed"]
    for name in ranks[0]:
        assert np.isfinite(ranks[0][name]["loss"])
        assert ranks[0][name] == ranks[1][name]


def test_pooled_lenet_gives_the_bits_of_the_run_without_workers(gang):
    """At 2 ranks, with 2 worker processes on each and the prefetch: the
    losses and params of the run with 0 workers, a resume's bits equal to
    the uninterrupted run's, the gauges in every rank's telemetry (read by
    the JAX package's ``dlstatus``), nothing of the input path left."""
    from distributeddeeplearningspark_tpu import status
    from distributeddeeplearningspark_tpu import telemetry as jtele

    outdir = gang[0]
    for r in (0, 1):
        pooled = _rank(outdir, r)["pooled"]
        assert pooled["equal"] and pooled["resume_equal"]
        assert pooled["left"] == {"0": {}, str(POOL_WORKERS): {}, "resumed": {}}
    plain = _fit_losses(outdir / "pool0")
    assert sorted(plain) == ["p0", "p1"] and len(plain["p0"]) == POOL_STEPS // 2
    assert _fit_losses(outdir / f"pool{POOL_WORKERS}") == plain
    events = jtele.read_events(str(outdir / f"pool{POOL_WORKERS}"))
    laps = [e for e in events if e["kind"] == "step_metrics"]
    assert sorted({e["process"] for e in laps}) == ["p0", "p1"]
    assert all(e["input_wait_s"] >= 0 and e["input_workers"] == 2 for e in laps)
    pool = status.input_workers_from(events)
    assert pool["input_workers"] == 2 and pool["worker_items"] > 0
    assert all("input_workers" not in e for e in jtele.read_events(str(outdir / "pool0"))
               if e["kind"] == "step_metrics")


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

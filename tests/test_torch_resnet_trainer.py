"""ResNet training in the port against the JAX package on the CPU:
``softmax_xent``, ``sgd`` and ``warmup_cosine`` against the JAX package's
(optax), and ``Trainer.fit``/``evaluate`` of a tiny fused ResNet (stage
sizes (1, 1), width 16, 32×32 images, b=8, f32, every 1×1 pair through the
K4 path) on a one-device CPU session against the JAX ``Trainer`` from the
same weights (the JAX init carried across by ``params_from_flax``), fed by
each package's ``synthetic_images`` → ``imagenet_train(repeat=True)``. The
logged losses come from each run's ``step_metrics`` telemetry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.models import resnet as jresnet
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch import Session, Trainer, TrainState
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.models import resnet as tresnet
from distributeddeeplearningspark_tpu_torch.models.resnet_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.ops import conv_bn as tconv
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from test_torch_deadline import bounded, per_test

BATCH, SIZE, CLASSES, STEPS, LOG_EVERY = 8, 32, 10, 6, 2
# f32 on both sides; the residue is summation order (convolutions by other
# algorithms), carried through 6 SGD steps
RTOL = 2e-4


# -- loss and optimizer ---------------------------------------------------------


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.mark.parametrize("classes", [5, 10])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(classes, masked):
    rng = np.random.default_rng(classes)
    logits = rng.normal(0, 2, (7, classes)).astype(np.float32)
    batch = {"label": rng.integers(0, classes, 7).astype(np.int32)}
    if masked:
        batch["eval_mask"] = np.array([1, 1, 0, 1, 0, 1, 1], np.float32)
    _, want = jlosses.softmax_xent(jnp.asarray(logits),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = tlosses.softmax_xent(torch.from_numpy(logits),
                                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    assert ("top5_accuracy" in got) == (classes > 5)
    assert float(loss) == float(got["loss"])
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(end_factor=0.1), dict(warmup=0)])
def test_warmup_cosine_matches_optax(kw):
    warmup = kw.pop("warmup", 3)
    got = toptim.warmup_cosine(0.1, warmup, 12, **kw)
    want = joptim.warmup_cosine(0.1, warmup, 12, **kw)
    for count in range(16):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(count))


@pytest.mark.parametrize("kw", [
    dict(momentum=0.9, weight_decay=1e-4),
    dict(momentum=0.9, nesterov=True),
    dict(momentum=None),
])
def test_sgd_matches_optax_over_a_dozen_steps(kw):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 3, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes]
             for _ in range(12)]
    jtx = joptim.sgd(joptim.warmup_cosine(0.1, 3, 12), **kw)
    ttx = toptim.sgd(toptim.warmup_cosine(0.1, 3, 12), **kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = [p + u for p, u in zip(jp, ju)]
        tu, tstate = ttx.update([torch.from_numpy(x.copy()) for x in g], tstate, tp)
        torch._foreach_add_(tp, tu)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# -- Trainer.fit and evaluate -------------------------------------------------------


def _model_kw(fused=True):
    return dict(stage_sizes=(1, 1), num_classes=CLASSES, width=16,
                fused_conv_bn=fused)


def _train_ds(sources_mod, vision_mod, **kw):
    src = sources_mod.synthetic_images(4 * BATCH, image_size=SIZE,
                                       num_classes=CLASSES, num_partitions=2)
    return vision_mod.imagenet_train(src, size=SIZE, repeat=True, **kw)


def _eval_ds(sources_mod, vision_mod, **kw):
    src = sources_mod.synthetic_images(11, image_size=SIZE, num_classes=CLASSES,
                                       num_partitions=1, seed=9)
    return vision_mod.imagenet_eval(src, size=SIZE, **kw)


def _step_metrics(workdir):
    return [(e["step"], e["metrics"]) for e in jtele.read_events(str(workdir))
            if e["kind"] == "step_metrics"]


def _tx(optim_mod):
    return optim_mod.sgd(optim_mod.warmup_cosine(0.05, 2, STEPS), momentum=0.9,
                         weight_decay=1e-4)


@pytest.fixture(scope="module")
@bounded()
def runs(tmp_path_factory):
    """One JAX run and one port run from the same weights: (JAX workdir,
    port workdir, JAX eval before/after, port eval before/after, JAX final
    batch_stats as a port state dict, port trainer, port summary, K4 calls
    in the port's fit)."""
    root = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    try:
        jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
        jtrainer = JTrainer(jspark, jresnet.ResNet(
            block_cls=jresnet.BottleneckBlock, dtype=jnp.float32, **_model_kw()),
            jlosses.softmax_xent, _tx(joptim))
        jds = _train_ds(jsources, jvision, num_workers=0)
        jtrainer.init(jtrainer._sample_batch(jds, BATCH))
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        stats = jax.tree.map(np.asarray, jax.device_get(
            jtrainer.state.mutable["batch_stats"]))
        jeval_ds = _eval_ds(jsources, jvision, num_workers=0)
        jeval = [jtrainer.evaluate(jeval_ds, batch_size=3)]
        mp.setenv(jtele.WORKDIR_ENV, str(root / "jax"))
        jtrainer.fit(jds, batch_size=BATCH, steps=STEPS, log_every=LOG_EVERY)
        jtele.reset()
        mp.delenv(jtele.WORKDIR_ENV)
        jeval.append(jtrainer.evaluate(jeval_ds, batch_size=3))
        jstats = params_from_flax(params, jax.tree.map(np.asarray, jax.device_get(
            jtrainer.state.mutable["batch_stats"])))
        jspark.stop()

        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock,
                               dtype=torch.float32, device="cpu", **_model_kw())
        model.load_state_dict(params_from_flax(params, stats))
        trainer = Trainer(spark, model, tlosses.softmax_xent, _tx(toptim))
        teval_ds = _eval_ds(tsources, tvision)
        teval = [trainer.evaluate(teval_ds, batch_size=3)]
        calls = []
        plain = tconv.matmul_stats
        mp.setattr(tconv, "matmul_stats", lambda x, w: calls.append(1) or plain(x, w))
        mp.setenv(ttele.WORKDIR_ENV, str(root / "port"))
        _, summary = trainer.fit(_train_ds(tsources, tvision), batch_size=BATCH,
                                 steps=STEPS, log_every=LOG_EVERY)
        ttele.reset()
        mp.undo()
        teval.append(trainer.evaluate(teval_ds, batch_size=3))
        spark.stop()
    finally:
        mp.undo()
    return (root / "jax", root / "port", jeval, teval, jstats, trainer,
            summary, len(calls))


def test_fit_logs_the_jax_losses(runs):
    jdir, tdir, *_ = runs
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6]
    for (_, tm), (_, jm) in zip(got, want):
        assert set(tm) == set(jm) == {"loss", "accuracy", "top5_accuracy",
                                      "grad_norm"}
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
        assert tm["accuracy"] == jm["accuracy"]


def test_fit_leaves_the_jax_batch_stats(runs):
    *_, jstats, trainer, _, _ = runs
    got = trainer.model.state_dict()
    names = [k for k in jstats if k.endswith((".mean", ".var"))]
    assert set(trainer.state.mutable) == set(names)
    for k in names:
        want = jstats[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=k)


def test_evaluate_matches_jax_before_and_after_training(runs):
    """The whole finite set of 11 images in batches of 3 (a short tail
    batch), the model in eval mode on the running statistics."""
    _, _, jeval, teval, *_ = runs
    for got, want in zip(teval, jeval):
        assert set(got) == set(want) == {"loss", "accuracy", "top5_accuracy"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert teval[0]["loss"] != teval[1]["loss"]


def test_fit_runs_the_k4_path_and_reports_images_per_second(runs):
    *_, trainer, summary, calls = runs
    assert calls == 4 * STEPS  # every 1×1 pair of the tiny model, each step
    assert isinstance(trainer.state, TrainState) and trainer.state.step == STEPS
    assert summary["examples_per_sec_per_chip"] == pytest.approx(
        BATCH / (summary["step_time_ms"] / 1e3))
    # BN statistics are buffers: never params, never in the optimizer state
    params = set(trainer.state.params)
    assert not params & set(trainer.state.mutable)
    n_params = len(params)
    assert all(len(t) == n_params for t in trainer.state.opt_state[1])

"""The port's divergence recovery against the JAX package's, on the CPU:
``Trainer.fit(on_nonfinite="skip"|"rollback")`` with ``DLS_FAULT=nan@k``
(one env drives both packages' fault hooks), eval inside ``fit`` and
``callbacks``, from the same weights (the JAX init carried across by
``params_from_flax``) and the same batches.

Two models: LeNet-5 under SGD with momentum (a ``trace`` in the optimizer
state) and a tiny fused ResNet (stage sizes (1, 1), width 16, 32×32, f32,
the 1×1 pairs through K4's plain version) under SGD with weight decay and
``warmup_cosine`` (a schedule count, BatchNorm buffers). For each policy
the runs' final params, ``trace``, schedule count and buffers agree at the
tolerances of ``test_torch_lenet.py`` / ``test_torch_resnet_trainer.py``,
``skipped_steps`` / ``rollbacks`` are equal, and so are the checkpoints'
``examples_seen``. Then the failure edges (the skip budget,
``max_rollbacks``, a rollback without a checkpointer, the walk past a
checkpoint whose params are not finite) and the guard's own properties
(the skipped step's state bitwise the one before it, no snapshot
allocated afresh)."""

import contextlib
import glob
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu import Checkpointer as JCheckpointer
from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
from distributeddeeplearningspark_tpu.models import resnet as jresnet
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch import Checkpointer, LeNet5, Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.models import lenet_io, resnet_io
from distributeddeeplearningspark_tpu_torch.models import resnet as tresnet
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.train.optim import TraceState
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import bounded, per_test

# the tolerances of test_torch_lenet.py and test_torch_resnet_trainer.py:
# f32 on both sides, summation order compounded through the steps
LENET_RTOL, LENET_ATOL = 1e-4, 1e-5
RESNET_RTOL = 2e-4
BATCH, STEPS = 8, 8
#: rollback: checkpoints every 4 steps, metrics every 2, NaN at step 6 ->
#: back to step 4, then on with the feed at batch 6
EVERY, LOG_EVERY, NAN_AT = 4, 2, 6
POLICIES = ("skip", "rollback")


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@contextlib.contextmanager
def _logged_metrics():
    """``{package: [(step, metrics)]}`` of both MetricLoggers' lines."""
    got: dict[str, list] = {"jax": [], "port": []}

    class Grab(logging.Handler):
        def __init__(self, key):
            super().__init__(logging.INFO)
            self.key = key

        def emit(self, record):
            if record.msg == "step %d: %s":
                step, text = record.args
                got[self.key].append((step, json.loads(text)))

    pairs = [(logging.getLogger("distributeddeeplearningspark_tpu.metrics"), Grab("jax")),
             (logging.getLogger("distributeddeeplearningspark_tpu_torch.metrics"),
              Grab("port"))]
    levels = [lg.level for lg, _ in pairs]
    for lg, h in pairs:
        lg.setLevel(logging.INFO)
        lg.addHandler(h)
    try:
        yield got
    finally:
        for (lg, h), level in zip(pairs, levels):
            lg.removeHandler(h)
            lg.setLevel(level)


def _find_trace(tree):
    """The ``trace`` tree of an optax state (a TraceState anywhere in it)."""
    if hasattr(tree, "trace"):
        return tree.trace
    if isinstance(tree, tuple):
        for t in tree:
            found = _find_trace(t)
            if found is not None:
                return found
    return None


def _find_count(tree):
    """The schedule's count of an optax state, or None."""
    fields = getattr(tree, "_fields", ())
    if "count" in fields and "mu" not in fields:
        return int(np.asarray(tree.count))
    if isinstance(tree, tuple):
        for t in tree:
            found = _find_count(t)
            if found is not None:
                return found
    return None


def _jax_examples_seen(directory: str) -> dict[int, int]:
    """``{step: examples_seen}`` of a JAX checkpoint root (the orbax JSON
    item)."""
    out = {}
    for path in glob.glob(os.path.join(directory, "*", "data", "metadata")):
        step = os.path.basename(os.path.dirname(os.path.dirname(path)))
        if not step.isdigit():
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and "examples_seen" in doc:
            out[int(step)] = int(doc["examples_seen"])
    return out


def _port_examples_seen(directory: str) -> dict[int, int]:
    out = {}
    for path in glob.glob(os.path.join(directory, "*", "data_state.json")):
        step = os.path.basename(os.path.dirname(path))
        if step.isdigit():
            with open(path) as f:
                out[int(step)] = json.load(f)["examples_seen"]
    return out


# -- the two models, each package's side --------------------------------------


class LeNetCase:
    name = "lenet"
    rtol, atol = LENET_RTOL, LENET_ATOL

    @staticmethod
    def data(sources_mod, vision_mod):
        return sources_mod.synthetic_mnist(512, num_partitions=2, seed=1).repeat()

    @staticmethod
    def eval_data(sources_mod, vision_mod):
        return sources_mod.synthetic_mnist(40, num_partitions=1, seed=3)

    @staticmethod
    def jax_trainer(jspark, ckpt):
        return JTrainer(jspark, JLeNet5(), jlosses.softmax_xent,
                        optax.sgd(0.05, momentum=0.9), checkpointer=ckpt)

    @staticmethod
    def init(jtrainer):
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        return params, None

    @staticmethod
    def to_port(params, stats):
        return lenet_io.params_from_flax(params)

    @staticmethod
    def port_trainer(spark, params, stats, ckpt):
        model = LeNet5(device="cpu")
        model.load_state_dict(lenet_io.params_from_flax(params))
        return Trainer(spark, model, tlosses.softmax_xent,
                       toptim.sgd(0.05, momentum=0.9), checkpointer=ckpt)


class ResNetCase:
    name = "resnet"
    rtol, atol = RESNET_RTOL, 0.0

    @staticmethod
    def _kw():
        return dict(stage_sizes=(1, 1), num_classes=10, width=16, fused_conv_bn=True)

    @staticmethod
    def data(sources_mod, vision_mod):
        src = sources_mod.synthetic_images(4 * BATCH, image_size=32, num_classes=10,
                                           num_partitions=2)
        kw = {"num_workers": 0} if vision_mod is jvision else {}
        return vision_mod.imagenet_train(src, size=32, repeat=True, **kw)

    @staticmethod
    def eval_data(sources_mod, vision_mod):
        src = sources_mod.synthetic_images(11, image_size=32, num_classes=10,
                                           num_partitions=1, seed=9)
        kw = {"num_workers": 0} if vision_mod is jvision else {}
        return vision_mod.imagenet_eval(src, size=32, **kw)

    @staticmethod
    def _tx(optim_mod):
        return optim_mod.sgd(optim_mod.warmup_cosine(0.05, 2, STEPS), momentum=0.9,
                             weight_decay=1e-4)

    @classmethod
    def jax_trainer(cls, jspark, ckpt):
        return JTrainer(jspark, jresnet.ResNet(
            block_cls=jresnet.BottleneckBlock, dtype=jnp.float32, **cls._kw()),
            jlosses.softmax_xent, cls._tx(joptim), checkpointer=ckpt)

    @staticmethod
    def init(jtrainer):
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        stats = jax.tree.map(np.asarray, jax.device_get(
            jtrainer.state.mutable["batch_stats"]))
        return params, stats

    @staticmethod
    def to_port(params, stats):
        return resnet_io.params_from_flax(params, stats)

    @classmethod
    def port_trainer(cls, spark, params, stats, ckpt):
        model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock,
                               dtype=torch.float32, device="cpu", **cls._kw())
        model.load_state_dict(resnet_io.params_from_flax(params, stats))
        return Trainer(spark, model, tlosses.softmax_xent, cls._tx(toptim),
                       checkpointer=ckpt)


CASES = {"lenet": LeNetCase, "resnet": ResNetCase}


def _fit_kw(policy: str, eval_ds) -> dict:
    kw = dict(batch_size=BATCH, steps=STEPS, log_every=LOG_EVERY,
              on_nonfinite=policy, eval_dataset=eval_ds, eval_every=EVERY)
    if policy == "rollback":
        kw["checkpoint_every"] = EVERY
    return kw


def _jax_run(case, policy: str, root) -> dict:
    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    try:
        ckpt = JCheckpointer(str(root / "jckpt")) if policy == "rollback" else None
        jtrainer = case.jax_trainer(jspark, ckpt)
        jds = case.data(jsources, jvision)
        jtrainer.init(jtrainer._sample_batch(jds, BATCH))
        init = case.init(jtrainer)
        seen = []
        with _logged_metrics() as logged:
            state, summary = jtrainer.fit(
                jds, callbacks=[lambda s, m: seen.append((s, dict(m)))],
                **_fit_kw(policy, case.eval_data(jsources, jvision)))
        params, stats = case.init(jtrainer)
        trace = jax.tree.map(np.asarray, jax.device_get(_find_trace(state.opt_state)))
        if ckpt is not None:
            ckpt.close()
        return dict(init=init, final=case.to_port(params, stats),
                    trace=case.to_port(trace, stats), count=_find_count(state.opt_state),
                    summary=summary, callbacks=seen, logged=logged["jax"],
                    examples_seen=_jax_examples_seen(str(root / "jckpt")))
    finally:
        jspark.stop()


def _port_run(case, policy: str, init, root) -> dict:
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    mp = pytest.MonkeyPatch()
    try:
        ckpt = Checkpointer(root / "tckpt") if policy == "rollback" else None
        trainer = case.port_trainer(spark, *init, ckpt)
        mp.setenv(ttele.WORKDIR_ENV, str(root / "tele"))
        seen = []
        with _logged_metrics() as logged:
            state, summary = trainer.fit(
                case.data(tsources, tvision),
                callbacks=[lambda s, m: seen.append((s, dict(m)))],
                **_fit_kw(policy, case.eval_data(tsources, tvision)))
        names = list(state.params)
        trace, count = None, None
        for part in state.opt_state:
            if isinstance(part, TraceState):
                trace = dict(zip(names, part.trace))
            elif not isinstance(part, tuple):
                count = int(part)
        final = {**state.params, **state.mutable}
        if ckpt is not None:
            ckpt.close()
        return dict(final={k: v.detach().clone() for k, v in final.items()},
                    trace=trace, count=count, summary=summary, callbacks=seen,
                    logged=logged["port"], trainer=trainer, state=state,
                    events=jtele.read_events(str(root / "tele")),
                    examples_seen=_port_examples_seen(str(root / "tckpt")))
    finally:
        ttele.reset()
        mp.undo()
        spark.stop()


@pytest.fixture(scope="module", params=sorted(CASES))
@bounded()
def runs(request, tmp_path_factory):
    """``{policy: (JAX run, port run)}`` of one model, ``DLS_FAULT=nan@6``."""
    case = CASES[request.param]
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("DLS_FAULT", f"nan@{NAN_AT}")
    mp.delenv("DLS_RESTART", raising=False)
    try:
        for policy in POLICIES:
            root = tmp_path_factory.mktemp(f"{case.name}-{policy}")
            jrun = _jax_run(case, policy, root)
            out[policy] = (jrun, _port_run(case, policy, jrun["init"], root))
    finally:
        mp.undo()
    return case, out


@pytest.mark.parametrize("policy", POLICIES)
def test_recovery_leaves_the_jax_params_trace_and_buffers(runs, policy):
    case, out = runs
    jrun, trun = out[policy]
    assert set(trun["final"]) == set(jrun["final"])
    for k, want in jrun["final"].items():
        got = trun["final"][k]
        assert torch.isfinite(got).all(), k
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=case.rtol,
                                   atol=case.atol or case.rtol * float(want.abs().max()),
                                   err_msg=k)
    for k, got in trun["trace"].items():
        want = jrun["trace"][k].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=case.rtol,
                                   atol=case.atol or case.rtol * np.abs(want).max(),
                                   err_msg=f"trace {k}")
    if jrun["count"] is not None:  # a schedule's (optax's constant lr has none)
        assert trun["count"] == jrun["count"]


@pytest.mark.parametrize("policy", POLICIES)
def test_recovery_counts_and_checkpoints_match_jax(runs, policy):
    case, out = runs
    jrun, trun = out[policy]
    key = {"skip": "skipped_steps", "rollback": "rollbacks"}[policy]
    assert trun["summary"][key] == jrun["summary"][key] == 1.0
    assert trun["state"].step == STEPS
    if policy == "rollback":
        # the model went back to step 4 while the feed went on: every later
        # checkpoint says the 2 batches passed over were consumed
        assert trun["examples_seen"] == jrun["examples_seen"]
        assert trun["examples_seen"][STEPS] == (STEPS + 2) * BATCH
        recov = [e for e in trun["events"] if e["kind"] == "recovery"]
        assert [(e["event"], e["to_step"], e["window"]) for e in recov] == \
            [("rollback", EVERY, NAN_AT - EVERY)]
    else:
        recov = [e for e in trun["events"] if e["kind"] == "recovery"]
        assert [(e["event"], e["skipped_steps"]) for e in recov] == [("skip", 1)]


@pytest.mark.parametrize("policy", POLICIES)
def test_eval_in_fit_and_callbacks_match_jax(runs, policy):
    """Every ``eval_*`` line and every callback's ``(step, metrics)``."""
    case, out = runs
    jrun, trun = out[policy]

    def evals(logged):
        return [(s, m) for s, m in logged if any(k.startswith("eval_") for k in m)]

    jev, tev = evals(jrun["logged"]), evals(trun["logged"])
    assert [s for s, _ in tev] == [s for s, _ in jev] and len(tev) >= 2
    for (_, tm), (_, jm) in zip(tev, jev):
        assert set(tm) == set(jm) == {"eval_loss", "eval_accuracy",
                                      "eval_top5_accuracy"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=case.rtol, atol=case.atol,
                                       err_msg=k)
    assert [s for s, _ in trun["callbacks"]] == [s for s, _ in jrun["callbacks"]]
    for (s, tm), (_, jm) in zip(trun["callbacks"], jrun["callbacks"]):
        assert set(tm) == set(jm), s
        if jm and not np.isfinite(jm["loss"]):
            # the poisoned step: the accuracies of NaN logits are arbitrary
            # (argmax/top-k tie order) in both packages; the NaNs must match
            assert not np.isfinite(tm["loss"]) and not np.isfinite(tm["grad_norm"]), s
            continue
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=case.rtol * 10,
                                       atol=case.atol or 1e-6, err_msg=(s, k))
    phases = [e for e in trun["events"] if e["kind"] == "phase" and e["name"] == "eval"]
    assert len(phases) == 2 * len(tev)


# -- the failure edges ---------------------------------------------------------


@pytest.fixture
def spark():
    s = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield s
    s.stop()


def _lenet_trainer(spark, ckpt=None, **kw):
    torch.manual_seed(0)
    return Trainer(spark, LeNet5(device="cpu"), tlosses.softmax_xent,
                   toptim.sgd(0.05, momentum=0.9), checkpointer=ckpt, **kw)


def _mnist():
    return tsources.synthetic_mnist(256, num_partitions=2, seed=1).repeat()


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("edge,fit_kw,match", [
    ("budget", dict(on_nonfinite="skip", nonfinite_budget=0), "nonfinite_budget=0"),
    ("max_rollbacks", dict(on_nonfinite="rollback", max_rollbacks=0,
                           checkpoint_every=1), "max_rollbacks=0"),
    ("no_checkpointer", dict(on_nonfinite="rollback"), "needs a checkpointer"),
    ("raise", dict(), "non-finite metrics at step 2"),
])
def test_failure_edges_raise_as_jax(spark, tmp_path, monkeypatch, package, edge,
                                    fit_kw, match):
    monkeypatch.setenv("DLS_FAULT", "nan@2")
    monkeypatch.delenv("DLS_RESTART", raising=False)
    with_ckpt = "checkpoint_every" in fit_kw
    if package == "jax":
        jspark = JSession.builder.master("local[1]").getOrCreate()
        try:
            trainer = LeNetCase.jax_trainer(
                jspark, JCheckpointer(str(tmp_path / "c")) if with_ckpt else None)
            ds = jsources.synthetic_mnist(256, num_partitions=2, seed=1).repeat()
            trainer.init(trainer._sample_batch(ds, BATCH))
            with pytest.raises(FloatingPointError, match=match):
                trainer.fit(ds, batch_size=BATCH, steps=4, log_every=1, **fit_kw)
        finally:
            jspark.stop()
        return
    trainer = _lenet_trainer(spark, Checkpointer(tmp_path / "c") if with_ckpt else None)
    with pytest.raises(FloatingPointError, match=match):
        trainer.fit(_mnist(), batch_size=BATCH, steps=4, log_every=1, **fit_kw)


def test_rollback_walks_past_a_checkpoint_whose_params_are_not_finite(
        spark, tmp_path, monkeypatch):
    """NaN at step 3 with checkpoints every 2 steps and metrics every 5: the
    step-4 checkpoint holds NaN params byte-intact; the rollback quarantines
    it and restores step 2, as JAX's does."""
    monkeypatch.setenv("DLS_FAULT", "nan@3")
    monkeypatch.delenv("DLS_RESTART", raising=False)
    kw = dict(batch_size=BATCH, steps=8, log_every=5, checkpoint_every=2,
              on_nonfinite="rollback")
    trainer = _lenet_trainer(spark, Checkpointer(tmp_path / "t", max_to_keep=5))
    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path / "tele"))
    try:
        state, summary = trainer.fit(_mnist(), **kw)
    finally:
        ttele.reset()
    assert summary["rollbacks"] == 1.0 and state.step == 8
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert "4.corrupt-0" in os.listdir(tmp_path / "t")
    recov = [(e["event"], e.get("to_step")) for e in
             jtele.read_events(str(tmp_path / "tele")) if e["kind"] == "recovery"]
    assert recov == [("quarantine", None), ("rollback", 2)]

    jspark = JSession.builder.master("local[1]").getOrCreate()
    try:
        jtrainer = LeNetCase.jax_trainer(
            jspark, JCheckpointer(str(tmp_path / "j"), max_to_keep=5))
        ds = jsources.synthetic_mnist(256, num_partitions=2, seed=1).repeat()
        jtrainer.init(jtrainer._sample_batch(ds, BATCH))
        _, jsummary = jtrainer.fit(ds, **kw)
    finally:
        jspark.stop()
    assert jsummary["rollbacks"] == summary["rollbacks"]
    assert "4.corrupt-0" in os.listdir(tmp_path / "j")
    assert _port_examples_seen(str(tmp_path / "t")) == \
        _jax_examples_seen(str(tmp_path / "j"))


def test_the_skipped_step_keeps_every_bit_and_allocates_no_snapshot(
        spark, monkeypatch):
    """On a tiny fused ResNet under AdamW: after the poisoned step 3 the
    params, both Adam moments, the count and every BatchNorm statistic are
    bitwise those after step 2; the guard's buffers are the same storage
    at every step."""
    monkeypatch.setenv("DLS_FAULT", "nan@3")
    monkeypatch.delenv("DLS_RESTART", raising=False)
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, dtype=torch.float32,
                           device="cpu", **ResNetCase._kw())
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(spark, model, tlosses.softmax_xent,
                      toptim.adamw(toptim.warmup_cosine(1e-3, 2, 6)))
    snaps, ptrs = {}, []

    def snap(step, _m):
        st: TrainState = trainer.state
        snaps[step] = {k: v.clone() for k, v in st.state_dict()["params"].items()}
        snaps[step].update({f"buf.{k}": v.clone() for k, v in st.mutable.items()})
        leaves = st.state_dict()["opt_state"]
        snaps[step].update({f"opt.{i}": (v.clone() if isinstance(v, torch.Tensor)
                                         else torch.tensor(v))
                            for i, v in enumerate(leaves)})
        guard = trainer._train_step.guard
        ptrs.append(tuple(g[1].data_ptr() for g in guard._groups))

    _, summary = trainer.fit(ResNetCase.data(tsources, tvision), batch_size=BATCH,
                             steps=5, log_every=1, on_nonfinite="skip",
                             callbacks=[snap])
    assert summary["skipped_steps"] == 1.0
    assert set(snaps[2]) == set(snaps[3])
    for k, before in snaps[2].items():
        assert torch.equal(snaps[3][k], before), k
    assert any(not torch.equal(snaps[4][k], snaps[3][k]) for k in snaps[3])
    assert all(torch.isfinite(v.float()).all() for v in snaps[5].values())
    assert len(set(ptrs)) == 1 and len(ptrs) == 5
    assert trainer._train_step.guard.nbytes > 0


def test_skip_refused_with_sparse_embed_and_bad_policy_named(spark):
    from distributeddeeplearningspark_tpu_torch.models.dlrm import DLRM, sparse_embed_specs

    model = DLRM(vocab_sizes=(10,) * 3, embed_dim=4, bottom_mlp=(8, 4),
                 top_mlp=(8, 1), num_dense=13, dtype=torch.float32, device="cpu")
    trainer = Trainer(spark, model, tlosses.binary_xent, toptim.adamw(1e-3),
                      sparse_embed=sparse_embed_specs(model, lr=1e-2))
    ds = tsources.synthetic_criteo(64, vocab_sizes=(10,) * 3, num_partitions=1)
    with pytest.raises(ValueError, match="not supported with sparse_embed"):
        trainer.fit(ds, batch_size=8, steps=1, on_nonfinite="skip")
    with pytest.raises(ValueError, match="'raise'|'skip'|'rollback'"):
        _lenet_trainer(spark).fit(_mnist(), batch_size=8, steps=1,
                                  on_nonfinite="ignore")


@pytest.mark.parametrize("env", [{"DLS_FAULT": "sigterm@3"},
                                 {"DLS_PREEMPT_NOTICE": "notice.json"}])
def test_a_preemption_notice_raises_naming_its_roadmap_item(spark, monkeypatch, env):
    monkeypatch.delenv("DLS_RESTART", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        _lenet_trainer(spark).fit(_mnist(), batch_size=8, steps=4)

"""Row-sparse embedding training of the port (``train/embed.py``, the
sparse step, ``Trainer(sparse_embed=...)``) against the JAX package on the
CPU: the same numpy inputs and, for models, the same weights (the JAX
init carried across by ``params_from_flax``). The JAX update runs its XLA
scatter and its Pallas kernel in interpret mode, as its own tests do; the
port has one table scatter, K5's wrapper, which takes its plain version
on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data.feed import put_global, stack_examples
from distributeddeeplearningspark_tpu.models import dlrm as jdlrm
from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu.train import embed as jembed
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu.train import step as jstep
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.models import dlrm as tdlrm
from distributeddeeplearningspark_tpu_torch.models.dlrm_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.ops import scatter_rows as tsr
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import embed as tembed
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import bounded, per_test

VOCABS = (11, 7, 5)
# f32 on both sides; the residue is summation order (the mean over D, the
# MLP matmuls), at f32 rounding
RTOL = ATOL = 1e-6
# steps of an f32 model: the MLP backward's sums in another order
STEP_TOL = 1e-5
# logged losses over steps, as test_torch_trainer.py holds BERT
TRAIN_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _update_case(v, d, shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (v, d)).astype(np.float32),
            rng.uniform(0, 0.5, (v,)).astype(np.float32),
            rng.integers(0, v, shape).astype(np.int32),  # heavy duplicates
            rng.normal(0, 1, shape + (d,)).astype(np.float32))


def _jax_update(table, accum, ids, d_vecs, lr, impl):
    out = jembed.rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids),
        jnp.asarray(d_vecs), lr=lr, eps=1e-8, scatter_impl=impl)
    return tuple(np.asarray(a) for a in out)


def _port_update(table, accum, ids, d_vecs, lr):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    out = tembed.rowwise_adagrad_update(t, a, torch.from_numpy(ids),
                                        torch.from_numpy(d_vecs), lr=lr, eps=1e-8)
    assert out[0] is t and out[1] is a  # in place
    return t.numpy(), a.numpy()


@pytest.mark.parametrize("v,d,shape,seed", [
    (24, 8, (6, 2), 5), (13, 4, (5, 2), 1), (40, 16, (32, 3), 9)])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_rowwise_adagrad_matches_jax(v, d, shape, seed, jimpl):
    """The port's one path against both JAX scatters."""
    case = _update_case(v, d, shape, seed)
    want_t, want_a = _jax_update(*case, 0.1, jimpl)
    got_t, got_a = _port_update(*case, 0.1)
    np.testing.assert_allclose(got_t, want_t, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(v), case[2])
    np.testing.assert_array_equal(got_t[untouched], case[0][untouched])
    np.testing.assert_array_equal(got_a[untouched], case[1][untouched])


def test_rowwise_adagrad_gives_the_same_bits_twice():
    """The deterministic segment sum: heavy duplicates, two runs."""
    case = _update_case(30, 8, (16, 4), 11)
    t1, a1 = _port_update(*case, 0.05)
    t2, a2 = _port_update(*case, 0.05)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(a1, a2)


def test_the_table_update_goes_through_the_k5_wrapper(monkeypatch):
    """One call of the K5 wrapper a step, with the padded unique ids
    (sentinels ``v + i`` trailing) and the table itself, not a copy."""
    calls = []

    def spy(table, idx, upd):
        calls.append((table.data_ptr(), idx.clone(), tuple(upd.shape)))
        return tsr.scatter_add_rows(table, idx, upd)

    monkeypatch.setattr(tembed, "scatter_add_rows", spy)
    t, a = torch.zeros(6, 4), torch.zeros(6)
    ids = torch.tensor([[4, 1], [4, 0]], dtype=torch.int32)
    tembed.rowwise_adagrad_update(t, a, ids, torch.ones(2, 2, 4), lr=0.1)
    ((ptr, idx, shape),) = calls
    assert ptr == t.data_ptr() and shape == (4, 4)
    assert idx.tolist() == [0, 1, 4, 6 + 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_padded_unique_is_the_jax_contract(seed):
    """Sorted distinct ids, then the pads v + i in slot i; each id's slot."""
    v = 20
    flat = np.random.default_rng(seed).integers(0, v, 17).astype(np.int32)
    uniq, inv = jnp.unique(jnp.asarray(flat), return_inverse=True, size=17,
                           fill_value=v)
    uniq = jnp.where(uniq == v, v + jnp.arange(17, dtype=uniq.dtype), uniq)
    t_uniq, t_inv, counts = tembed.padded_unique(torch.from_numpy(flat), v)
    np.testing.assert_array_equal(t_uniq.numpy(), np.asarray(uniq))
    np.testing.assert_array_equal(t_inv.numpy(), np.asarray(inv).reshape(-1))
    assert t_uniq.dtype == torch.int32
    assert counts.sum() == 17 and counts.numel() == np.unique(flat).size


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 9, 50).astype(np.int32)
    g = rng.normal(0, 1, (50, 6)).astype(np.float32)
    _, inv, counts = tembed.padded_unique(torch.from_numpy(flat), 9)
    got = tembed.segment_sum(torch.from_numpy(g), inv, counts).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(g), jnp.asarray(inv.numpy()),
                                          num_segments=50))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[counts.numel():].any()  # the pad segments stay zero


# -- one sparse step against make_sparse_embed_train_step ---------------------


def _batch(n, seed, vocabs=VOCABS):
    rng = np.random.default_rng(seed)
    return stack_examples([
        {"dense": rng.normal(0, 1, (13,)).astype(np.float32),
         "sparse": np.array([rng.integers(0, v) for v in vocabs], np.int32),
         "label": np.int32(rng.integers(0, 2))}
        for _ in range(n)])


def _jax_model(kind):
    if kind == "dlrm":
        return jdlrm.DLRM(vocab_sizes=VOCABS, embed_dim=8, bottom_mlp=(16, 8),
                          top_mlp=(16, 1), dtype=jnp.float32)
    return jdlrm.WideAndDeep(vocab_sizes=VOCABS, embed_dim=8, deep_mlp=(16, 1),
                             dtype=jnp.float32)


def _port_model(kind):
    if kind == "dlrm":
        return tdlrm.DLRM(VOCABS, 8, (16, 8), (16, 1), dtype=torch.float32,
                          device="cpu")
    return tdlrm.WideAndDeep(VOCABS, 8, (16, 1), dtype=torch.float32, device="cpu")


def _jax_step(model, batch, steps):
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    specs = jdlrm.sparse_embed_specs(model, lr=0.07)
    tx = joptim.masked(optax.adamw(1e-3), jembed.dense_trainable(specs))
    state, shardings = jstep.init_state(model, tx, batch, mesh, jdlrm.dlrm_rules(),
                                        sparse_embed=specs)
    params0 = jax.tree.map(np.asarray, jax.device_get(state.params))
    step = jstep.jit_train_step(
        jembed.make_sparse_embed_train_step(model.apply, tx, jlosses.binary_xent,
                                            specs), mesh, shardings)
    metrics = []
    for _ in range(steps):
        state, m = step(state, put_global(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, state, metrics


def _port_trainer(model, specs, spark):
    return Trainer(spark, model, tlosses.binary_xent,
                   toptim.adamw(1e-3, weight_decay=1e-4), sparse_embed=specs)


@pytest.fixture
def cpu_session():
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield spark
    spark.stop()


@pytest.mark.parametrize("kind", ["dlrm", "widedeep"])
@pytest.mark.parametrize("data_seed", [3, 5])
def test_sparse_steps_match_jax(kind, data_seed, cpu_session):
    """Metrics of each step, and table(s), row accumulators and MLP params
    after two steps of an f32 model (the second reads the first's
    accumulators); optax.adamw's weight decay 1e-4 reaches the dense
    params only."""
    batch = _batch(4, data_seed)
    params0, jstate, jmetrics = _jax_step(_jax_model(kind), batch, steps=2)
    model = _port_model(kind)
    model.load_state_dict(params_from_flax(params0))
    specs = tdlrm.sparse_embed_specs(model, lr=0.07)
    trainer = _port_trainer(model, specs, cpu_session)
    state = trainer.init()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for want in jmetrics:
        state, m = trainer._train_step(state, tbatch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), want[key], rtol=STEP_TOL)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))).items()}
    got = {k: v.detach().numpy() for k, v in state.params.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=k)
    for s in specs:
        np.testing.assert_allclose(
            state.embed_state[s.name]["row_accum"].numpy(),
            np.asarray(jstate.embed_state[s.name]["row_accum"]),
            rtol=STEP_TOL, atol=STEP_TOL)


def test_only_touched_rows_move(cpu_session):
    batch = _batch(8, 0)
    model = _port_model("dlrm")
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = _port_trainer(model, tdlrm.sparse_embed_specs(model, lr=0.05),
                            cpu_session)
    state = trainer.init()
    table0 = model.embedding.embedding_table.detach().clone()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        state, _ = trainer._train_step(state, tbatch)
    flat = tdlrm.fused_flat_ids(VOCABS, tbatch["sparse"]).reshape(-1).unique()
    untouched = np.setdiff1d(np.arange(sum(VOCABS)), flat.numpy())
    table1 = model.embedding.embedding_table.detach()
    assert torch.equal(table1[untouched], table0[untouched])
    assert (table1[flat] != table0[flat]).any(1).all()
    acc = state.embed_state["embedding"]["row_accum"]
    assert (acc[flat] > 0).all() and not acc[untouched].any()


def test_unconsumed_override_raises_and_updates_nothing(cpu_session):
    """A spec whose name the model does not consume: the JAX step NaNs its
    loss; the port's step raises before any param or table moves."""
    model = _port_model("dlrm")
    model.init_weights(torch.Generator().manual_seed(1))
    good = tdlrm.sparse_embed_specs(model)[0]
    bad = dataclasses.replace(good, name="not_a_module_name")
    trainer = _port_trainer(model, (bad,), cpu_session)
    state = trainer.init()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(4, 2).items()}
    with pytest.raises(RuntimeError, match="not_a_module_name"):
        trainer._train_step(state, tbatch)
    for k, v in state.params.items():
        assert torch.equal(v.detach(), before[k]), k
        assert v.grad is None
    assert not state.embed_state["not_a_module_name"]["row_accum"].any()


def test_trainer_refuses_a_spec_for_a_missing_table(cpu_session):
    model = _port_model("dlrm")
    bad = dataclasses.replace(tdlrm.sparse_embed_specs(model)[0],
                              param_path="embedding.no_such_table")
    with pytest.raises(ValueError, match="no_such_table"):
        _port_trainer(model, (bad,), cpu_session)


# -- Trainer.fit(sparse_embed=...) against the JAX Trainer ---------------------

STEPS, LOG_EVERY, BATCH = 6, 2, 8


def _examples():
    """The data of the JAX package's ``test_trainer_wires_sparse_embed``."""
    return [dict(zip(("dense", "sparse", "label"), t)) for t in zip(
        np.random.default_rng(0).normal(0, 1, (32, 13)).astype(np.float32),
        np.stack([np.random.default_rng(1).integers(0, v, 32) for v in VOCABS],
                 1).astype(np.int32),
        np.zeros((32,), np.int32))]


def _step_metrics(workdir):
    return [(e["step"], e["metrics"]) for e in jtele.read_events(str(workdir))
            if e["kind"] == "step_metrics"]


@pytest.fixture(scope="module")
@bounded()
def fit_runs(tmp_path_factory):
    """The JAX Trainer and the port's on the same data and weights, f32
    models: (JAX workdir, port workdir, port state, port trainer)."""
    root = tmp_path_factory.mktemp("sparse_fit")
    mp = pytest.MonkeyPatch()
    try:
        jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
        jmodel = _jax_model("dlrm")
        jtrainer = JTrainer(jspark, jmodel, jlosses.binary_xent,
                            optax.adamw(1e-3), rules=jdlrm.dlrm_rules(),
                            sparse_embed=jdlrm.sparse_embed_specs(jmodel, lr=0.05))
        jds = JDataset.parallelize(_examples(), num_slices=2)
        jtrainer.init(jtrainer._sample_batch(jds, BATCH))
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        mp.setenv(jtele.WORKDIR_ENV, str(root / "jax"))
        jtrainer.fit(jds.repeat(), batch_size=BATCH, steps=STEPS, log_every=LOG_EVERY)
        jtele.reset()
        jspark.stop()

        spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
        model = _port_model("dlrm")
        model.load_state_dict(params_from_flax(params))
        trainer = Trainer(spark, model, tlosses.binary_xent,
                          toptim.adamw(1e-3, weight_decay=1e-4),
                          sparse_embed=tdlrm.sparse_embed_specs(model, lr=0.05))
        mp.setenv(ttele.WORKDIR_ENV, str(root / "port"))
        state, _ = trainer.fit(TDataset.parallelize(_examples(), num_slices=2).repeat(),
                               batch_size=BATCH, steps=STEPS, log_every=LOG_EVERY)
        ttele.reset()
        spark.stop()
    finally:
        mp.undo()
    return root / "jax", root / "port", state, trainer


def test_fit_logs_the_jax_losses(fit_runs):
    jdir, tdir, *_ = fit_runs
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6]
    for (_, tm), (_, jm) in zip(got, want):
        assert set(tm) == set(jm) == {"loss", "accuracy", "grad_norm"}
        for k in tm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=TRAIN_RTOL)
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_fit_keeps_row_accumulators_and_no_table_sized_moment(fit_runs):
    *_, state, trainer = fit_runs
    assert isinstance(state, TrainState) and state.step == STEPS
    acc = state.embed_state["embedding"]["row_accum"]
    assert acc.shape == (sum(VOCABS),) and (acc > 0).any()
    table = trainer.model.embedding.embedding_table
    moments = [t for t in jax.tree_util.tree_leaves(state.opt_state)
               if isinstance(t, torch.Tensor)]
    assert moments and all(m.shape != table.shape for m in moments)
    n_dense = sum(1 for n, _ in trainer.model.named_parameters()
                  if n != "embedding.embedding_table")
    assert len(state.opt_state[0].mu) == len(state.opt_state[0].nu) == n_dense

"""ResNet and DLRM data-parallel over processes: the port at ``local[2]``,
two gloo processes launched by the port's cli, against the JAX package's
``Trainer`` at ``local[2]`` (two devices of one process, where GSPMD makes
BatchNorm's statistics and the sparse step's unique rows global) from the
same converted weights and the same batches.

One gang runs every scenario: this file is its script (``python
tests/test_torch_dist_models.py OUTDIR`` on each rank; it imports no jax).
Each rank writes what the tests read into OUTDIR:

- ``all_reduce_sum`` forward and backward against sums done by hand;
- ``BatchNorm`` and ``Conv1x1BN`` (K4's fused path on its plain version,
  and the unfused chain), each rank on half a batch: outputs, input
  gradients, running statistics and (summed over the ranks) param
  gradients against one whole batch in one process, at ``HALF_TOL``;
- a tiny fused ResNet (``test_torch_resnet_trainer.py``'s: stage sizes (1,
  1), width 16, f32, 32² images) over 5 SGD steps: the logged losses, the
  final params and BatchNorm statistics against JAX's at that file's
  ``RTOL``, the buffers equal across ranks; one step's reduced gradient,
  from JAX's trained weights, against one process's on the whole batch;
- a tiny DLRM (four tables of 100 rows, ``embed_dim=8``) over 5 steps,
  ids repeating across ranks: the losses, the tables and ``row_accum``
  against JAX's, the replicas equal.

The port's two new drivers run under the cli at ``local[2]`` as gangs of
their own, and every flag they cannot honour is refused at parse time.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.examples import train_dlrm, train_resnet
from distributeddeeplearningspark_tpu_torch.models import dlrm as tdlrm
from distributeddeeplearningspark_tpu_torch.models import resnet as tresnet
from distributeddeeplearningspark_tpu_torch.ops import conv_bn as tconv
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.train.embed import ROW_ACCUM
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from distributeddeeplearningspark_tpu_torch.train.step import make_train_step

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
# test_torch_resnet_trainer.py's model, data and tolerance: f32 on both
# sides, the residue is summation order carried through the SGD steps
RES_BATCH, RES_SIZE, RES_CLASSES, RES_STEPS = 8, 32, 10, 5
RTOL = 2e-4
# one reduced gradient against one process's on the whole batch: the order
# of the sums (global statistics, then the all-reduce), scaled to each
# tensor's largest element where BatchNorm's gradient cancels to ~0
GRAD_RTOL = 2e-4
# f32 statistics and gradients of half batches combined: rounding only
HALF_TOL = 1e-5
DLRM_VOCABS, DLRM_DIM, DLRM_BATCH, DLRM_STEPS, DLRM_LR = (100,) * 4, 8, 16, 5, 0.05
# test_torch_embed.py's tolerance for logged losses over steps
DLRM_RTOL = 1e-4


# -- inputs both sides build --------------------------------------------------


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _res_model_kw() -> dict:
    return dict(stage_sizes=(1, 1), num_classes=RES_CLASSES, width=16,
                fused_conv_bn=True)


def _res_train_ds(sources_mod, vision_mod, **kw):
    src = sources_mod.synthetic_images(4 * RES_BATCH, image_size=RES_SIZE,
                                       num_classes=RES_CLASSES, num_partitions=2)
    return vision_mod.imagenet_train(src, size=RES_SIZE, repeat=True, **kw)


def _res_tx(optim_mod):
    return optim_mod.sgd(optim_mod.warmup_cosine(0.05, 2, RES_STEPS), momentum=0.9,
                         weight_decay=1e-4)


def _port_resnet(init: dict) -> tresnet.ResNet:
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, dtype=torch.float32,
                           device="cpu", **_res_model_kw())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _bn_layers(model: torch.nn.Module) -> int:
    return sum(isinstance(m, (tresnet.BatchNorm, tconv.Conv1x1BN))
               for m in model.modules())


def _grad_batch() -> dict:
    rng = np.random.default_rng(11)
    return {"image": rng.normal(0, 1, (RES_BATCH, RES_SIZE, RES_SIZE, 3)).astype(np.float32),
            "label": rng.integers(0, RES_CLASSES, RES_BATCH).astype(np.int32)}


def _dlrm_examples() -> list[dict]:
    """64 examples whose ids repeat within and across ranks: the first
    table draws from 3 rows, the second from 10, the others from 100."""
    rng = np.random.default_rng(7)
    highs = np.array([3, 10, 100, 100])
    return [{"dense": rng.normal(0, 1, (13,)).astype(np.float32),
             "sparse": rng.integers(0, highs).astype(np.int32),
             "label": np.int32(rng.integers(0, 2))} for _ in range(64)]


def _port_dlrm(init: dict) -> tdlrm.DLRM:
    model = tdlrm.DLRM(DLRM_VOCABS, DLRM_DIM, (16, DLRM_DIM), (16, 1),
                       dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _half_input(layer: str) -> tuple[np.ndarray, np.ndarray]:
    """A batch of 8 and the gradient that reaches the layer's output."""
    rng = np.random.default_rng(3)
    c = 6 if layer == "batchnorm" else 16
    cout = 6 if layer == "batchnorm" else 24
    x = rng.normal(0.5, 2.0, (8, c, 4, 4)).astype(np.float32)
    g = rng.normal(0, 1, (8, cout, 4, 4)).astype(np.float32)
    return x, g


def _half_layer(layer: str) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(5)
    if layer == "batchnorm":
        mod = tresnet.BatchNorm(6, dtype=torch.float32)
    else:
        mod = tconv.Conv1x1BN(16, 24, dtype=torch.float32,
                              fused=layer == "conv1x1bn_fused")
        mod.kernel.data = torch.randn(mod.kernel.shape, generator=gen) * 0.3
    mod.scale.data = 1 + 0.1 * torch.randn(mod.scale.shape, generator=gen)
    mod.bias.data = 0.1 * torch.randn(mod.bias.shape, generator=gen)
    return mod.train()


def _half_run(layer: str, rows: slice) -> dict[str, np.ndarray]:
    """The layer's forward and backward on ``rows`` of the batch: its
    output, the input's and params' gradients, its running statistics."""
    x, g = _half_input(layer)
    mod = _half_layer(layer)
    xt = torch.from_numpy(x[rows]).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    calls = collectives.all_reduce_sum.calls
    out = mod(xt)
    (out * torch.from_numpy(g[rows])).sum().backward()
    res = {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
           "calls": np.int64(collectives.all_reduce_sum.calls - calls)}
    res.update({f"d_{n}": p.grad.numpy() for n, p in mod.named_parameters()})
    res.update({n: b.numpy() for n, b in mod.named_buffers()})
    return res


HALF_LAYERS = ("batchnorm", "conv1x1bn_fused", "conv1x1bn_unfused")


def _capture_tx(store: list):
    def update(updates, state, params):
        store.extend(u.detach().clone() for u in updates)
        return [torch.zeros_like(u) for u in updates], state
    return optim.GradientTransformation(lambda params: (), update)


def _grads_of(model, batch, *, distributed=False) -> dict:
    """The gradient one train step hands its optimizer."""
    store: list = []
    state = TrainState(step=0, params=dict(model.named_parameters()), opt_state=(),
                       generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, _capture_tx(store), losses.softmax_xent,
                           distributed=distributed)
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {n: g.numpy() for n, g in zip(state.params, store)}


# -- the gang's side ----------------------------------------------------------


def _worker(outdir: Path) -> None:
    """One rank of the gang: every scenario, in order."""
    spark = Session.builder.appName("dist-models").getOrCreate()
    rank, out = spark.rank, {}
    assert spark.world_size == 2 and spark.backend == "gloo"

    t = (torch.arange(4.0) + 10 * rank).requires_grad_()
    calls = collectives.all_reduce_sum.calls
    y = collectives.all_reduce_sum(t)
    (y * (rank + 1)).sum().backward()
    out["all_reduce_sum"] = dict(y=y.tolist(), grad=t.grad.tolist(), input=t.tolist(),
                                 calls=collectives.all_reduce_sum.calls - calls)

    for layer in HALF_LAYERS:
        np.savez(outdir / f"half_{layer}_{rank}.npz",
                 **_half_run(layer, slice(4 * rank, 4 * rank + 4)))

    res_init = dict(np.load(outdir / "resnet_init.npz"))
    os.environ[ttele.WORKDIR_ENV] = str(outdir / "resnet")
    trainer = Trainer(spark, _port_resnet(res_init), losses.softmax_xent,
                      _res_tx(optim))
    calls = collectives.all_reduce_sum.calls
    state, _ = trainer.fit(_res_train_ds(tsources, tvision), batch_size=RES_BATCH,
                           steps=RES_STEPS, log_every=1)
    out["resnet_bn_allreduces_per_step"] = (
        collectives.all_reduce_sum.calls - calls) / RES_STEPS
    ttele.reset()
    del os.environ[ttele.WORKDIR_ENV]
    model = trainer.model
    collectives.assert_replicas_in_sync(
        {**dict(model.named_parameters()), **dict(model.named_buffers())})
    np.savez(outdir / f"resnet_final_{rank}.npz",
             **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    half = {k: v[4 * rank:4 * rank + 4] for k, v in _grad_batch().items()}
    trained = dict(np.load(outdir / "resnet_trained.npz"))
    np.savez(outdir / f"resnet_grads_{rank}.npz",
             **_grads_of(_port_resnet(trained), half, distributed=True))

    dlrm_init = dict(np.load(outdir / "dlrm_init.npz"))
    os.environ[ttele.WORKDIR_ENV] = str(outdir / "dlrm")
    model = _port_dlrm(dlrm_init)
    trainer = Trainer(spark, model, losses.binary_xent,
                      optim.adamw(1e-3, weight_decay=1e-4),
                      sparse_embed=tdlrm.sparse_embed_specs(model, lr=DLRM_LR))
    state, _ = trainer.fit(PartitionedDataset.parallelize(_dlrm_examples(), 2).repeat(),
                           batch_size=DLRM_BATCH, steps=DLRM_STEPS, log_every=1)
    ttele.reset()
    del os.environ[ttele.WORKDIR_ENV]
    accum = {f"{n}.{ROW_ACCUM}": s[ROW_ACCUM] for n, s in state.embed_state.items()}
    collectives.assert_replicas_in_sync({**state.params, **accum})
    np.savez(outdir / f"dlrm_final_{rank}.npz",
             **{k: v.detach().numpy() for k, v in {**state.params, **accum}.items()})

    (outdir / f"rank{rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the test side ------------------------------------------------------------


def _step_losses(workdir) -> dict:
    from distributeddeeplearningspark_tpu import telemetry as jtele

    by_proc: dict = {}
    for e in jtele.read_events(str(workdir)):
        if e["kind"] == "step_metrics":
            by_proc.setdefault(e["process"], []).append(e["metrics"]["loss"])
    return by_proc


def _jax_resnet(outdir: Path) -> dict:
    """The JAX Trainer at local[2]: the port's init, the logged losses and
    the final params and batch stats as a port state dict."""
    import jax
    import jax.numpy as jnp

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.data import sources as jsources
    from distributeddeeplearningspark_tpu.data import vision as jvision
    from distributeddeeplearningspark_tpu.models import resnet as jresnet
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim
    from distributeddeeplearningspark_tpu_torch.models.resnet_io import params_from_flax

    def port(trainer) -> dict:
        params, stats = (jax.tree.map(np.asarray, jax.device_get(t)) for t in (
            trainer.state.params, trainer.state.mutable["batch_stats"]))
        return {k: v.numpy() for k, v in params_from_flax(params, stats).items()}

    jspark = JSession.builder.master("local[2]").appName("j").getOrCreate()
    jt = JTrainer(jspark, jresnet.ResNet(block_cls=jresnet.BottleneckBlock,
                                         dtype=jnp.float32, **_res_model_kw()),
                  jlosses.softmax_xent, _res_tx(joptim))
    jds = _res_train_ds(jsources, jvision, num_workers=0)
    jt.init(jt._sample_batch(jds, RES_BATCH))
    init = port(jt)
    losses_ = []
    jt.fit(jds, batch_size=RES_BATCH, steps=RES_STEPS, log_every=1,
           callbacks=[lambda s, m: losses_.append(float(m["loss"]))])
    final = port(jt)
    jspark.stop()
    np.savez(outdir / "resnet_init.npz", **init)
    # trained weights for the gradient test: at init every block's last
    # gamma is 0, which cuts the gradient through the block's other layers
    np.savez(outdir / "resnet_trained.npz", **final)
    return dict(init=init, losses=losses_, final=final)


def _jax_dlrm(outdir: Path) -> dict:
    """The JAX Trainer at local[2] with sparse_embed: the init, the logged
    losses, the final params and row accumulators."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.models import dlrm as jdlrm
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu_torch.models.dlrm_io import params_from_flax

    def port(trainer) -> dict:
        params = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
        return {k: v.numpy() for k, v in params_from_flax(params).items()}

    jspark = JSession.builder.master("local[2]").appName("j").getOrCreate()
    jmodel = jdlrm.DLRM(vocab_sizes=DLRM_VOCABS, embed_dim=DLRM_DIM,
                        bottom_mlp=(16, DLRM_DIM), top_mlp=(16, 1), dtype=jnp.float32)
    jt = JTrainer(jspark, jmodel, jlosses.binary_xent, optax.adamw(1e-3),
                  rules=jdlrm.dlrm_rules(),
                  sparse_embed=jdlrm.sparse_embed_specs(jmodel, lr=DLRM_LR))
    jds = JDataset.parallelize(_dlrm_examples(), num_slices=2)
    jt.init(jt._sample_batch(jds, DLRM_BATCH))
    init = port(jt)
    losses_ = []
    jt.fit(jds.repeat(), batch_size=DLRM_BATCH, steps=DLRM_STEPS, log_every=1,
           callbacks=[lambda s, m: losses_.append(float(m["loss"]))])
    final = port(jt)
    final.update({f"{n}.{ROW_ACCUM}": np.asarray(s[ROW_ACCUM])
                  for n, s in jt.state.embed_state.items()})
    jspark.stop()
    np.savez(outdir / "dlrm_init.npz", **init)
    return dict(init=init, losses=losses_, final=final)


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    """The JAX runs at local[2] (their init params seed the gang), then the
    gang: (outdir, JAX ResNet run, JAX DLRM run)."""
    outdir = tmp_path_factory.mktemp("gang_models")
    jres, jdlrm_run = _jax_resnet(outdir), _jax_dlrm(outdir)
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return outdir, jres, jdlrm_run


def _rank(outdir, r) -> dict:
    return json.loads((outdir / f"rank{r}.json").read_text())


def _npz(path) -> dict:
    return dict(np.load(path))


def test_all_reduce_sum_forward_and_backward_across_two_ranks(gang):
    """Rank r holds ``arange(4) + 10 r`` and weighs the sum by ``r + 1``:
    both get the sum of the two, its input untouched, and the gradient
    ``1 + 2`` (every rank's loss reaches every rank's input); one
    collective forward and one backward."""
    for r in (0, 1):
        got = _rank(gang[0], r)["all_reduce_sum"]
        assert got["y"] == [10.0, 12.0, 14.0, 16.0]
        assert got["input"] == [10.0 * r + i for i in range(4)]
        assert got["grad"] == [3.0] * 4
        assert got["calls"] == 2


def test_all_reduce_sum_is_the_identity_outside_a_group():
    assert not collectives.active()
    t = torch.arange(3.0, requires_grad=True)
    calls = collectives.all_reduce_sum.calls
    y = collectives.all_reduce_sum(t)
    (2 * y).sum().backward()
    assert y is t and t.grad.tolist() == [2.0] * 3
    assert collectives.all_reduce_sum.calls == calls


@pytest.mark.parametrize("layer", HALF_LAYERS)
def test_half_batches_equal_the_whole_batch(gang, layer):
    """Each rank's half through the layer, with global statistics, gives
    the whole batch's rows of the output and the input gradient, the same
    running statistics on both ranks as the whole batch's, and param
    gradients that sum to the whole batch's; one all-reduce forward and
    one backward."""
    halves = [_npz(gang[0] / f"half_{layer}_{r}.npz") for r in (0, 1)]
    whole = _half_run(layer, slice(0, 8))
    assert whole["calls"] == 0 and all(h["calls"] == 2 for h in halves)
    for key in ("out", "dx"):
        np.testing.assert_allclose(np.concatenate([h[key] for h in halves]), whole[key],
                                   rtol=HALF_TOL, atol=HALF_TOL, err_msg=key)
    for key in ("mean", "var"):
        np.testing.assert_array_equal(halves[0][key], halves[1][key])
        np.testing.assert_allclose(halves[0][key], whole[key], rtol=HALF_TOL,
                                   atol=HALF_TOL, err_msg=key)
    params = [k for k in whole if k.startswith("d_")]
    assert len(params) == (2 if layer == "batchnorm" else 3)
    for key in params:
        np.testing.assert_allclose(halves[0][key] + halves[1][key], whole[key],
                                   rtol=HALF_TOL, atol=HALF_TOL, err_msg=key)


def test_resnet_at_two_ranks_matches_jax_local2(gang):
    """5 SGD steps of the tiny fused ResNet: the logged losses (the global
    batch's, the same on both ranks) and the final params and BatchNorm
    statistics are JAX's; each BatchNorm (Conv1x1BN's on K4's path among
    them) made one all-reduce forward and one backward each step."""
    outdir, jres, _ = gang
    by_proc = _step_losses(outdir / "resnet")
    assert sorted(by_proc) == ["p0", "p1"] and by_proc["p0"] == by_proc["p1"]
    np.testing.assert_allclose(by_proc["p0"], jres["losses"], rtol=RTOL)
    final = _npz(outdir / "resnet_final_0.npz")
    assert set(final) == set(jres["final"])
    for k, want in jres["final"].items():
        np.testing.assert_allclose(final[k], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=k)
    n_bn = _bn_layers(_port_resnet(jres["init"]))
    assert n_bn == 9
    assert _rank(outdir, 0)["resnet_bn_allreduces_per_step"] == 2 * n_bn


def test_resnet_replicas_and_batch_stats_in_sync(gang):
    """The params and every BatchNorm buffer are the same bytes on both
    ranks, and the statistics moved."""
    outdir = gang[0]
    r0, r1 = (_npz(outdir / f"resnet_final_{r}.npz") for r in (0, 1))
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    init = _npz(outdir / "resnet_init.npz")
    stats = [k for k in r0 if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * _bn_layers(_port_resnet(init))
    assert all(not np.array_equal(r0[k], init[k]) for k in stats)


def test_resnet_reduced_gradient_equals_one_process_whole_batch(gang):
    """Rank r's step on its half of a batch of 8, with global BatchNorm
    statistics, from JAX's weights after the 5 steps (no block's last gamma
    is 0 there, so every layer's statistics reach the loss): the reduced
    gradient is one process's on the whole batch."""
    outdir = gang[0]
    got = [_npz(outdir / f"resnet_grads_{r}.npz") for r in (0, 1)]
    want = _grads_of(_port_resnet(_npz(outdir / "resnet_trained.npz")), _grad_batch())
    assert set(got[0]) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_allclose(got[0][k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=k)


def test_dlrm_at_two_ranks_matches_jax_local2(gang):
    """5 sparse steps with ids repeating across ranks: the logged losses,
    the table, the MLPs and ``row_accum`` are JAX's at local[2], whose
    unique and segment sum run over the global batch."""
    outdir, _, jd = gang
    by_proc = _step_losses(outdir / "dlrm")
    assert sorted(by_proc) == ["p0", "p1"] and by_proc["p0"] == by_proc["p1"]
    np.testing.assert_allclose(by_proc["p0"], jd["losses"], rtol=DLRM_RTOL)
    final = _npz(outdir / "dlrm_final_0.npz")
    assert set(final) == set(jd["final"])
    for k, want in jd["final"].items():
        np.testing.assert_allclose(final[k], want, rtol=DLRM_RTOL, atol=DLRM_RTOL,
                                   err_msg=k)


def test_dlrm_replicas_in_sync_and_rows_merged(gang):
    """Both ranks hold the same table and accumulators, and the rows
    either rank's ids touched moved on both: the update is the merged
    one."""
    outdir, _, jd = gang
    r0, r1 = (_npz(outdir / f"dlrm_final_{r}.npz") for r in (0, 1))
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    ids = np.stack([ex["sparse"] for ex in _dlrm_examples()])
    touched = np.unique(ids + np.array([0, 100, 200, 300]))
    accum = r0[f"embedding.{ROW_ACCUM}"]
    assert (accum[touched] > 0).all()
    assert not np.delete(accum, touched).any()
    table0 = jd["init"]["embedding.embedding_table"]
    assert (r0["embedding.embedding_table"][touched] != table0[touched]).any(1).all()


DRIVERS = {
    "resnet": ["--steps", "2", "--batch-size", "4", "--image-size", "32",
               "--num-classes", "10", "--log-every", "1"],
    "dlrm": ["--steps", "3", "--batch-size", "32", "--vocab-size", "100",
             "--eval-examples", "256", "--log-every", "1"],
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_trains_at_two_ranks(name, tmp_path):
    """The port's driver through its cli at local[2] on the CPU: rank 0's
    JSON line reports the gang, finite losses, and the collectives of the
    N-rank path (ResNet-50: 53 BatchNorm all-reduces forward and 53
    backward a step; DLRM: both ranks' ids and f32 vector gradients
    gathered), after the replica check passed."""
    script = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / f"train_{name}.py"
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(tmp_path), str(script), *DRIVERS[name]],
                   deadline_s=180)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith('{"train"')]
    assert len(lines) == 1, res.stdout[-2000:]
    got = lines[0]
    assert got["world_size"] == 2 and got["backend"] == "gloo" and got["device"] == "cpu"
    assert got["replicas_checked"] and np.isfinite(got["train"]["loss"])
    if name == "resnet":
        assert got["variant"] == "resnet50" and got["step"] == 2
        assert got["bn_allreduces_per_step"] == 2 * 53
    else:
        assert got["step"] == 3 and 0.0 <= got["eval_auc"] <= 1.0
        # 32 rows × 26 ids: int32 ids and 64 f32 gradients each
        assert got["merge_bytes_per_step"] == 32 * 26 * (4 + 64 * 4)
    losses_ = _step_losses(tmp_path)
    assert sorted(losses_) == ["p0", "p1"] and losses_["p0"] == losses_["p1"]


REFUSED = [("resnet", [flag] + (["x"] if flag != "--mfu" else []))
           for flag in train_resnet.NOT_PORTED]
REFUSED += [("resnet", ["--optimizer", "lars"]),
            ("dlrm", ["--expert-shards", "2"])]
REFUSED += [("dlrm", [flag]) for flag in train_dlrm.NOT_PORTED]


@pytest.mark.parametrize("name,argv", REFUSED, ids=[" ".join(a) for _, a in REFUSED])
def test_driver_refuses_what_it_cannot_honour(name, argv, capsys):
    """Each flag of the JAX driver that the port cannot honour fails at
    parse time, before any session, naming its ROADMAP item."""
    driver = {"resnet": train_resnet, "dlrm": train_dlrm}[name]
    with pytest.raises(SystemExit) as e:
        driver.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "is not ported yet" in err and "ROADMAP Queue 1 item" in err, err


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

"""LeNet-5 (config 1) and its data path in the port against the JAX package,
on the CPU: the model's forward from converted flax params, the MNIST
sources byte for byte, the sharded host feed at 1, 2 and 4 shards (aligned
and chained, with a padded tail), the mesh conf parsing, and one process's
``Trainer.fit`` against the JAX ``Trainer`` at ``local[2]``."""

import gzip
import itertools
import struct

import jax
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import feed as jfeed
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
from distributeddeeplearningspark_tpu.parallel import mesh as jmesh
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu.session import _parse_master
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import LeNet5, MeshSpec, Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.models.lenet_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from test_torch_deadline import per_test

# f32 on both sides; the residue is the order of the convolutions' sums
FWD_RTOL = FWD_ATOL = 1e-5
# 20 SGD steps compound that residue through the updates
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _flax_params(seed: int = 2) -> dict:
    batch = {"image": np.zeros((1, 28, 28, 1), np.float32)}
    params = JLeNet5().init(jax.random.PRNGKey(seed), batch, train=False)["params"]
    return jax.tree.map(np.asarray, params)


def _port_lenet(params) -> LeNet5:
    model = LeNet5(device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_lenet_forward_matches_jax():
    params = _flax_params()
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(0, 1, (3, 28, 28, 1)).astype(np.float32)}
    want = np.asarray(JLeNet5().apply({"params": params}, batch, train=False))
    with torch.no_grad():
        got = _port_lenet(params)({"image": torch.from_numpy(batch["image"])})
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_lenet_params_match_flax_names_and_shapes():
    """One tensor for each flax leaf, of the converted leaf's shape, and
    flax's init statistics: zero biases, kernels within ±2σ of lecun-normal."""
    params = _flax_params()
    model = LeNet5(device="cpu", seed=3)
    converted = params_from_flax(params)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in converted.items()}
    assert sum(p.numel() for p in model.parameters()) == 61_706
    for name, p in model.named_parameters():
        if p.ndim == 1:
            assert not p.any(), name
        else:
            std = (1.0 / np.prod(p.shape[1:])) ** 0.5 / 0.87962566103423978
            assert p.abs().max() <= 2 * std + 1e-6, name
    again = LeNet5(device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("n,parts,seed", [(64, 2, 0), (100, 4, 7), (30, 1, 99)])
def test_synthetic_mnist_is_byte_identical(n, parts, seed):
    got = tsources.synthetic_mnist(n, num_partitions=parts, seed=seed)
    want = jsources.synthetic_mnist(n, num_partitions=parts, seed=seed)
    assert got.num_partitions == want.num_partitions
    for i in range(parts):
        _batches_equal([tfeed.stack_examples(list(got.iter_partition(i)))],
                       [jfeed.stack_examples(list(want.iter_partition(i)))])


def _write_idx(path, arr: np.ndarray, code: int, gz: bool) -> None:
    head = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_idx_matches_jax(tmp_path, gz):
    rng = np.random.default_rng(1)
    for prefix, n in (("train", 10), ("t10k", 6)):
        _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), 8, gz)
        _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte",
                   rng.integers(0, 10, (n,), dtype=np.uint8), 8, gz)
    for split in ("train", "test"):
        got = tsources.load_mnist_idx(str(tmp_path), split, num_partitions=3)
        want = jsources.load_mnist_idx(str(tmp_path), split, num_partitions=3)
        _batches_equal([tfeed.stack_examples(got.collect())],
                       [jfeed.stack_examples(want.collect())])
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="IDX magic"):
        tsources._read_idx(str(tmp_path / "bad"))


def _rows(n: int):
    rng = np.random.default_rng(n)
    return [{"x": rng.normal(size=(3,)).astype(np.float32), "i": np.int32(i)}
            for i in range(n)]


# (examples, partitions, batch): aligned (partitions divide over the shards),
# chained (they do not), and tails that fill no shard evenly
FEED_CASES = [(70, 4, 16), (70, 3, 16), (37, 2, 8), (9, 4, 8), (64, 8, 16)]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("n,parts,batch", FEED_CASES)
@pytest.mark.parametrize("pad", [False, True])
def test_sharded_host_batches_are_jax_rows(shards, n, parts, batch, pad):
    """Rank r's rows are exactly JAX's ``host_batches(..., num_shards=N,
    shard_range=(r, r + 1))``: the same batches, the same padded tail."""
    rows = _rows(n)
    tds, jds = TDataset.parallelize(rows, parts), JDataset.parallelize(rows, parts)
    for r in range(shards):
        srange = (r, r + 1) if shards > 1 else None
        kw = dict(num_shards=shards, shard_range=srange, drop_remainder=False,
                  pad_remainder=pad)
        _batches_equal(tfeed.host_batches(tds, batch, **kw),
                       jfeed.host_batches(jds, batch, **kw))


@pytest.mark.parametrize("shards", [2, 4])
def test_infinite_feed_walks_only_local_shards(shards):
    """On a ``repeat()`` dataset each rank opens its own shards'
    partitions only, and still yields JAX's rows."""
    rows = _rows(40)
    parts = shards * 2
    chunks = [rows[i::parts] for i in range(parts)]
    jds = JDataset([lambda c=c: iter(c) for c in chunks]).repeat()
    for r in range(shards):
        opened = []
        tds = TDataset([lambda i=i: opened.append(i) or iter(chunks[i])
                        for i in range(parts)]).repeat()
        kw = dict(num_shards=shards, shard_range=(r, r + 1))
        _batches_equal(itertools.islice(tfeed.host_batches(tds, 4 * shards, **kw), 7),
                       itertools.islice(jfeed.host_batches(jds, 4 * shards, **kw), 7))
        assert opened and {i % shards for i in opened} == {r}


def test_process_shard_range():
    assert tfeed.process_shard_range(4) is None  # no group: one process
    assert tfeed.process_shard_range(4, rank=1, world_size=2) == (2, 4)
    assert tfeed.process_shard_range(2, rank=1, world_size=2) == (1, 2)
    assert tfeed.process_shard_range(2, rank=0, world_size=1) is None
    with pytest.raises(ValueError, match="divide evenly"):
        tfeed.process_shard_range(3, rank=0, world_size=2)
    with pytest.raises(ValueError, match="divisible"):
        list(tfeed.host_batches(TDataset.parallelize(_rows(8), 2), 5,
                                num_shards=2, shard_range=(0, 1)))


def test_mesh_axes_are_jax_axes():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert MeshSpec(data=4).shape(4) == {a: (4 if a == "data" else 1)
                                         for a in jmesh.MESH_AXES}
    assert tmesh.num_data_shards(MeshSpec().shape(3)) == 3


@pytest.mark.parametrize("master,conf", [
    ("local[2]", {}), ("local[4]", {"mesh.data": "2"}),
    ("local[2]", {"spark.executor.instances": "3"}), ("local[*]", {}),
    (None, {"mesh.data": "2"}), ("auto", {"spark.executor.instances": "2"}),
])
def test_spec_from_conf_parses_as_jax(master, conf):
    want = _parse_master(master, conf)[1]
    assert tmesh.spec_from_conf(master, conf) == MeshSpec(data=want.data)


@pytest.mark.parametrize("conf,refused", [
    ({"mesh.seq": "-1", "mesh.pipe": "2"}, True),
    ({"mesh.tensor": "2", "mesh.pipe": "-1"}, False),
    ({"mesh.seq": "4", "mesh.expert": "2", "mesh.pipe": "2"}, True),
    ({"mesh.pipe": "2"}, False),
    ({"mesh.expert": "-1", "mesh.pipe": "2"}, True),
    ({"mesh.fsdp": "2", "mesh.pipe": "2"}, False),
    ({"mesh.seq": "2", "mesh.pipe": "-1"}, True),
])
def test_axes_beyond_data_are_refused(conf, refused):
    """Every axis is ported, the pipeline beside data, fsdp and tensor
    only: a pipe axis is parsed as the JAX Session parses it, and beside a
    seq or an expert axis (``-1`` included) it names ROADMAP Queue 1 item
    10."""
    if refused:
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            tmesh.spec_from_conf("local[2]", conf)
        return
    want = _parse_master("local[2]", conf)[1]
    got = tmesh.spec_from_conf("local[2]", conf)
    assert got.sizes == tuple(getattr(want, a) for a in jmesh.MESH_AXES)


def test_unrecognized_master_is_refused():
    with pytest.raises(ValueError, match="unrecognized master"):
        tmesh.spec_from_conf("yarn", {})
    with pytest.raises(ValueError, match="data axis"):
        tmesh.spec_from_conf("local[0]", {})


def test_one_process_fit_matches_jax_local2(tmp_path, monkeypatch):
    """20 steps of ``sgd(0.1)`` at b=32: the port on one CPU process against
    the JAX ``Trainer`` on a two-device mesh, from the same converted
    params: every logged loss (the port's from its ``step_metrics``
    telemetry) and the final params."""
    ds_kw = dict(num_examples=512, num_partitions=2, seed=1)
    jspark = JSession.builder.master("local[2]").getOrCreate()
    jtrainer = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.1))
    jds = jsources.synthetic_mnist(**ds_kw)
    jtrainer.init(jtrainer._sample_batch(jds, 32))
    init = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    want_losses = []
    jtrainer.fit(jds.repeat(), batch_size=32, steps=20, log_every=1,
                 callbacks=[lambda s, m: want_losses.append(m["loss"])])
    jfinal = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    jspark.stop()

    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    model = _port_lenet(init)
    trainer = Trainer(spark, model, tlosses.softmax_xent,
                      toptim.sgd(0.1, momentum=None))
    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path))
    try:
        trainer.fit(tsources.synthetic_mnist(**ds_kw).repeat(), batch_size=32,
                    steps=20, log_every=1)
    finally:
        ttele.reset()
    spark.stop()
    got_losses = [e["metrics"]["loss"] for e in jtele.read_events(str(tmp_path))
                  if e["kind"] == "step_metrics"]
    np.testing.assert_allclose(got_losses, want_losses, rtol=FIT_RTOL, atol=FIT_ATOL)
    want = params_from_flax(jfinal)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)


def test_evaluate_counts_the_tail_batch_exactly():
    """80 rows in batches of 32 (a 16-row tail) equal one full batch and
    the JAX trainer's ``evaluate`` from the same params."""
    params = _flax_params(seed=0)
    rows = tsources.synthetic_mnist(80, num_partitions=2, seed=21)
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    trainer = Trainer(spark, _port_lenet(params), tlosses.softmax_xent,
                      toptim.sgd(0.1))
    got = trainer.evaluate(rows, batch_size=32)
    want = trainer.evaluate(rows, batch_size=80)
    spark.stop()
    jspark = JSession.builder.master("local[1]").getOrCreate()
    jtrainer = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.1))
    jds = jsources.synthetic_mnist(80, num_partitions=2, seed=21)
    jtrainer.init(jtrainer._sample_batch(jds, 4))
    jtrainer.state = jtrainer.state.replace(params=jax.tree.map(
        lambda a, b: jax.device_put(b, a.sharding), jtrainer.state.params, params))
    jwant = jtrainer.evaluate(jds, batch_size=32)
    jspark.stop()
    assert set(got) == set(want) == set(jwant) == {"loss", "accuracy", "top5_accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FWD_RTOL, atol=FWD_ATOL)
        np.testing.assert_allclose(got[k], jwant[k], rtol=FWD_RTOL, atol=FWD_ATOL)


def test_evaluate_raises_when_the_loss_ignores_eval_mask():
    def careless_loss(logits, batch):  # ignores eval_mask, reports no weight
        loss = torch.nn.functional.cross_entropy(logits, batch["label"].long())
        return loss, {"loss": loss}

    rows = tsources.synthetic_mnist(64, num_partitions=1, seed=7).collect()[:33]
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    trainer = Trainer(spark, LeNet5(device="cpu"), careless_loss, toptim.sgd(0.1))
    with pytest.raises(RuntimeError, match="eval_mask"):
        trainer.evaluate(TDataset.parallelize(rows, 2), batch_size=32)
    spark.stop()

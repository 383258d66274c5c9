"""Config 4 from DataFrame features, against the JAX package on the CPU.

- ``examples/dlrm_features.py``: the port's ``build_vocabs`` (the exchange's
  counts, then top-V on the device path — here the CPU — or in the heap)
  and ``featurize`` equal to the JAX example's on the same click log, at 0
  and 2 workers;
- ``examples/train_dlrm.py --sql-features``: the port's DataFrame chain
  gives the batches of the JAX driver's chain on the same TSVs, bitwise,
  for training and for ``--eval-data``; 3 steps of an f32 DLRM fed from it
  log the JAX ``Trainer``'s losses from the same weights (converted by
  ``models/dlrm_io.py``) at ``test_torch_embed.py``'s ``STEP_TOL``, with
  the row-sparse step and with ``--dense-tables``' dense step;
- the driver in process on the CPU with both flags, and its refusal of a
  DataFrame whose partitions do not split over the ranks.
"""

import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data.dataframe import col as jcol
from distributeddeeplearningspark_tpu.data.dataframe import hash_bucket as jhash_bucket
from distributeddeeplearningspark_tpu.data.feed import host_batches as jhost_batches
from distributeddeeplearningspark_tpu.models import dlrm as jdlrm
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data.dataframe import DataFrameReader
from distributeddeeplearningspark_tpu_torch.data.feed import host_batches
from distributeddeeplearningspark_tpu_torch.examples import dlrm_features as tfeat
from distributeddeeplearningspark_tpu_torch.examples import train_dlrm
from distributeddeeplearningspark_tpu_torch.models import dlrm as tdlrm
from distributeddeeplearningspark_tpu_torch.models.dlrm_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as T
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from test_torch_deadline import per_test
from test_torch_embed import STEP_TOL

ROOT = Path(__file__).resolve().parents[1]
VOCAB, NUM_SPARSE, DIM, BATCH, STEPS = 50, 26, 8, 32, 3


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for var in ("DLS_DATA_WORKERS", "DLS_AGG_MAX_GROUPS", "DLS_FAULT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DLS_SHUFFLE_SPILL_DIR", str(tmp_path / "spill"))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_dlrm_features", ROOT / "examples" / "dlrm_features.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_criteo(path: Path, rows: int, seed: int) -> None:
    """Criteo TSV lines: label, I1–I13 (some empty, some negative), C1–C26
    (8-hex tokens from a small pool, some empty)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        dense = [str(int(x)) if rng.random() > 0.1 else ""
                 for x in rng.integers(-2, 200, 13)]
        cats = [f"{int(t):08x}" if rng.random() > 0.05 else ""
                for t in rng.integers(0, 400, NUM_SPARSE) * 2654435761 % (1 << 32)]
        lines.append("\t".join([str(int(rng.random() < 0.3))] + dense + cats))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def criteo(tmp_path) -> tuple[Path, Path]:
    """Two ``day_*`` shards of 96 rows and a held-out file of 64."""
    d = tmp_path / "criteo"
    d.mkdir()
    for i in range(2):
        write_criteo(d / f"day_{i}", 96, seed=i)
    write_criteo(tmp_path / "eval.tsv", 64, seed=9)
    return d, tmp_path / "eval.tsv"


def jax_sql_features(jspark, path: Path):
    """The JAX driver's ``load_criteo`` under ``--sql-features``
    (``examples/train_dlrm.py``), on a JAX session."""
    dense = [f"I{i + 1}" for i in range(13)]
    cats = [f"C{i + 1}" for i in range(NUM_SPARSE)]
    glob_path = str(path / "day_*") if path.is_dir() else str(path)
    df = (jspark.read.option("sep", "\t")
          .schema(["label"] + dense + cats, {"label": np.int32, **{c: np.str_ for c in cats}})
          .csv(glob_path))
    df = df.withColumns({c: jcol(c).fillna(0.0) for c in dense})
    df = df.withColumns({c: jhash_bucket(jcol(c), VOCAB) for c in cats})
    return df.to_dataset(vector_columns={"dense": dense, "sparse": cats})


def driver_args(*extra: str) -> list[str]:
    return ["--vocab-size", str(VOCAB), "--num-sparse", str(NUM_SPARSE),
            "--embed-dim", str(DIM), "--batch-size", str(BATCH), "--steps", str(STEPS),
            "--log-every", "1", *extra]


@pytest.fixture
def sessions():
    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield jspark, spark
    spark.stop()
    jspark.stop()


@pytest.mark.parametrize("which", ["train", "eval"])
def test_sql_feature_batches_are_the_jax_drivers(criteo, sessions, which):
    jspark, spark = sessions
    path = criteo[0] if which == "train" else criteo[1]
    args = train_dlrm.parse_args(["--sql-features", *driver_args()])
    got_ds = train_dlrm.load_criteo(args, spark, str(path))
    want_ds = jax_sql_features(jspark, path)
    assert isinstance(got_ds, T) and got_ds.num_partitions == want_ds.num_partitions
    got = list(host_batches(got_ds, BATCH))
    want = list(jhost_batches(want_ds, BATCH))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"label", "dense", "sparse"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k
    assert got[0]["sparse"].shape == (BATCH, NUM_SPARSE)
    assert got[0]["sparse"].max() < VOCAB and got[0]["dense"].shape == (BATCH, 13)


def _losses(events) -> list[float]:
    return [e["metrics"]["loss"] for e in events if e["kind"] == "step_metrics"]


@pytest.mark.parametrize("tables", ["sparse", "dense"])
def test_sql_fed_steps_log_the_jax_losses(criteo, sessions, tmp_path, monkeypatch, tables):
    """An f32 DLRM (the driver's model at narrow widths) from the same
    weights, fed by each framework's DataFrame chain: the logged losses of
    3 steps at ``STEP_TOL``, with the row-sparse step or the dense one."""
    jspark, spark = sessions
    vocabs = (VOCAB,) * NUM_SPARSE
    jmodel = jdlrm.DLRM(vocab_sizes=vocabs, embed_dim=DIM, bottom_mlp=(16, DIM),
                        top_mlp=(16, 1), dtype=jnp.float32)
    jspecs = jdlrm.sparse_embed_specs(jmodel, lr=1e-3) if tables == "sparse" else ()
    jtrainer = JTrainer(jspark, jmodel, jlosses.binary_xent, optax.adamw(1e-3),
                        rules=jdlrm.dlrm_rules(), sparse_embed=jspecs)
    jds = jax_sql_features(jspark, criteo[0])
    jtrainer.init(jtrainer._sample_batch(jds, BATCH))
    params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    monkeypatch.setenv(jtele.WORKDIR_ENV, str(tmp_path / "jax"))
    jtrainer.fit(jds.repeat(), batch_size=BATCH, steps=STEPS, log_every=1)
    jtele.reset()

    args = train_dlrm.parse_args(["--sql-features", *driver_args()])
    model = tdlrm.DLRM(vocabs, DIM, (16, DIM), (16, 1), dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(params))
    specs = tdlrm.sparse_embed_specs(model, lr=1e-3) if tables == "sparse" else ()
    trainer = Trainer(spark, model, tlosses.binary_xent,
                      toptim.adamw(1e-3, weight_decay=1e-4), sparse_embed=specs)
    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path / "port"))
    trainer.fit(train_dlrm.load_criteo(args, spark, str(criteo[0])).repeat(),
                batch_size=BATCH, steps=STEPS, log_every=1)
    ttele.reset()
    want = _losses(jtele.read_events(str(tmp_path / "jax")))
    got = _losses(ttele.read_events(str(tmp_path / "port")))
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)


@pytest.mark.parametrize("extra", [[], ["--dense-tables"]], ids=["sparse", "dense_tables"])
def test_driver_runs_sql_features_in_process(criteo, capsys, extra):
    """The driver's main on a CPU session (its builder returns the active
    one): finite losses, the held-out AUC from the same chain, the flags in
    its JSON line; the dense step keeps no row accumulator."""
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    try:
        train_dlrm.main(["--sql-features", "--data-dir", str(criteo[0]),
                         "--eval-data", str(criteo[1]), "--eval-examples", "64",
                         *driver_args(*extra)])
    finally:
        spark.stop()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"train"')]
    assert len(lines) == 1
    res = lines[0]
    assert res["sql_features"] and res["dense_tables"] == bool(extra)
    assert res["step"] == STEPS and np.isfinite(res["train"]["loss"])
    assert 0.0 <= res["eval_auc"] <= 1.0
    assert res["k5_launches"] == 0 and res["peak_bytes"] is None  # the CPU: plain versions


def test_driver_refuses_partitions_that_do_not_split(criteo):
    """Two files at four ranks: two partitions cannot split over four."""
    spark = types.SimpleNamespace(world_size=4, default_parallelism=4,
                                  read=DataFrameReader(default_parallelism=4))
    args = train_dlrm.parse_args(["--sql-features", *driver_args()])
    with pytest.raises(ValueError, match="2 partition.*4 ranks"):
        train_dlrm.load_criteo(args, spark, str(criteo[0]))
    spark.world_size = 2
    assert train_dlrm.load_criteo(args, spark, str(criteo[0])).num_partitions == 2


def test_flags_parse_as_the_jax_drivers():
    args = train_dlrm.parse_args(["--sql-features", "--dense-tables"])
    assert args.sql_features and args.dense_tables
    args = train_dlrm.parse_args([])
    assert not args.sql_features and not args.dense_tables


@pytest.fixture(scope="module")
def clicklog():
    """The example's click log, 2,000 rows over 4 partitions, both sides."""
    jmod = _jax_example()
    kw = dict(num_slots=6, num_dense=4, num_partitions=4, seed=3)
    return jmod, jmod.synth_clicklog(2000, **kw), tfeat.synth_clicklog(2000, **kw)


@pytest.mark.parametrize("nw", [0, 2])
@pytest.mark.parametrize("topv", ["device", "heap"])
def test_build_vocabs_and_featurize_match_jax(clicklog, nw, topv):
    jmod, jlog, tlog = clicklog
    want_v, want_p, _ = jmod.build_vocabs(jlog, num_slots=6, top_v=40, num_workers=nw,
                                          topv="heap")
    got_v, got_p, used = tfeat.build_vocabs(tlog, num_slots=6, top_v=40, num_workers=nw,
                                            topv=topv, device="cpu")
    assert used == topv
    assert got_p == want_p and got_v == want_v
    assert [len(p) for p in got_p] == [40] * 6
    want = jmod.featurize(jlog, want_v, want_p, item_slot=0, neg_per_pos=2, seed=3)
    got = tfeat.featurize(tlog, got_v, got_p, item_slot=0, neg_per_pos=2, seed=3)
    for g, w in zip(got.take(300), want.take(300)):
        assert set(g) == set(w) == {"dense", "sparse", "label"}
        for k in g:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes()


def test_feature_example_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    """The example's main on a CPU session: its summary line with JAX's
    keys, the count stage on the exchange, the top-V on the device path."""
    monkeypatch.setenv("DLS_TELEMETRY_DIR", str(tmp_path / "tele"))
    out = tfeat.main(["--rows", "2000", "--slots", "4", "--vocab", "30", "--data-workers",
                      "2", "--batch-size", "64", "--steps", "2", "--feed-batches", "3",
                      "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out, default=str))
    assert set(line) == {"rows", "vocab_sizes", "vocab_build_s", "data_workers",
                         "transports", "examples_per_sec", "neg_per_pos", "shuffle",
                         "train_summary"}
    assert line["transports"] == {"vocab_counts": "tuple", "topv": "device"}
    assert line["shuffle"]["op"] == "reduce_by_key" and line["vocab_sizes"] == [30] * 4
    assert np.isfinite(line["train_summary"]["loss"])

"""The port's DataFrame plane (``data/dataframe.py``) against the JAX
package's on the same numpy-seeded inputs: each pipeline's chunks,
partition by partition, the same columns, dtypes and bytes; the readers
(``read_csv``, ``read_parquet``, ``DataFrameReader``, ``spark.read``);
``randomSplit``, ``to_dataset(vector_columns=)``; ``groupBy().agg()`` on
every route (serial, ``tuple``, ``columnar``, ``device`` on the CPU) equal
to JAX's serial and ``columnar`` output; and the refusals, with JAX's
messages."""

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.data import dataframe as jdf
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as J
from distributeddeeplearningspark_tpu_torch import Session
from distributeddeeplearningspark_tpu_torch.data import dataframe as tdf
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as T
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _serial(monkeypatch, tmp_path):
    for var in ("DLS_DATA_WORKERS", "DLS_AGG_MAX_GROUPS", "DLS_SHUFFLE_MEM_MB",
                "DLS_SHUFFLE_TRANSPORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DLS_SHUFFLE_SPILL_DIR", str(tmp_path / "spill"))


@pytest.fixture
def cpu_session():
    spark = Session.builder.config(DEVICE_CONF, "cpu").getOrCreate()
    yield spark
    spark.stop()


def toy(M, n=100, parts=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1000, n).astype(np.float64)
    xs[::9] = np.nan
    rows = [{"x": float(x), "y": float(i % 7), "name": f"u{i % 5}" if i % 11 else "",
             "k": int(i % 6)} for i, x in enumerate(xs)]
    return M.from_rows(rows, num_partitions=parts, chunk_rows=16)


def chunks_of(df) -> list:
    """Partition by partition, each chunk as {column: (dtype, bytes or
    list)}: the same value in the same dtype on both sides."""
    out = []
    for p in range(df.num_partitions):
        part = []
        for ch in df._chunks.iter_partition(p):
            part.append({c: (a.dtype.str, a.tolist() if a.dtype.kind in "UO"
                             else np.ascontiguousarray(a).tobytes())
                         for c, a in ch.items()})
        out.append(part)
    return out


def _csv(tmp_path, rows=40, files=1, seed=3) -> str:
    """Criteo-shaped TSV files (label, I1, I2, C1, C2) with empty fields."""
    rng = np.random.default_rng(seed)
    for f in range(files):
        lines = []
        for i in range(rows):
            dense = [str(rng.integers(0, 50)) if i % 5 else "", str(i - 3)]
            cats = [f"{rng.integers(0, 1 << 16):08x}" if i % 7 else "", "cafe0001"]
            lines.append("\t".join([str(i % 2)] + dense + cats))
        (tmp_path / f"day_{f}").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "day_*") if files > 1 else str(tmp_path / "day_0")


CSV_NAMES = ["label", "I1", "I2", "C1", "C2"]
CSV_DTYPES = {"label": np.int32, "C1": np.str_, "C2": np.str_}

#: name -> build(M, tmp_path) -> DataFrame
PIPELINES = {
    "select_exprs": lambda M, t: toy(M).select(
        "x", (M.col("x") * 2 + 1).alias("x2"), M.log1p(M.col("y")).alias("ly"),
        (1 - M.col("y") / 3).alias("r"), (M.col("k") % 4).alias("m")),
    "with_column_filter": lambda M, t: toy(M).withColumn(
        "even", M.col("y") % 2 == 0).filter(M.col("even") & (M.col("k") != 3)),
    "where_or_not": lambda M, t: toy(M).where((M.col("y") > 4) | ~(M.col("k") >= 2)),
    "fillna": lambda M, t: toy(M).fillna(0.0, subset=["x"]).fillna("?", subset=["name"]),
    "col_fillna_isnull": lambda M, t: toy(M).select(
        M.col("x").fillna(-1.0).alias("f"), M.col("x").isNull().alias("n"),
        M.col("name").isNotNull().alias("s")),
    "when_otherwise": lambda M, t: toy(M).select(
        M.when(M.col("y") < 3, -1).when(M.col("y") < 6, 0).otherwise(M.col("y")).alias("b")),
    "hash_bucket": lambda M, t: toy(M).select(
        M.hash_bucket(M.col("name"), 13).alias("hs"),
        M.hash_bucket(M.col("k"), 7).alias("hi"),
        M.hash_bucket(M.col("y"), 1000).alias("hf")),
    "clip_cast_lit": lambda M, t: toy(M).select(
        M.clip(M.col("y"), 1, 5).alias("c"), M.col("y").cast(np.int16).alias("i"),
        M.lit(3.5).alias("l")),
    "with_columns_swap": lambda M, t: toy(M).withColumns({"x": M.col("y"), "y": M.col("x")}),
    "drop_rename": lambda M, t: toy(M).drop("name").withColumnRenamed("y", "z"),
    "repartition_up": lambda M, t: toy(M, parts=2).repartition(6),
    "repartition_down": lambda M, t: toy(M, parts=6).repartition(2),
    "random_split_0": lambda M, t: toy(M, n=200).randomSplit([0.8, 0.2], seed=7)[0],
    "random_split_1": lambda M, t: toy(M, n=200).randomSplit([0.8, 0.2], seed=7)[1],
    "from_dataset": lambda M, t: M.from_dataset(toy(M, n=20, parts=2).rdd,
                                                ["x", "y", "name", "k"], chunk_rows=8),
    "read_csv_split": lambda M, t: M.read_csv(_csv(t), names=CSV_NAMES, sep="\t",
                                              dtypes=CSV_DTYPES, num_partitions=3),
    "read_csv_glob": lambda M, t: M.read_csv(_csv(t, files=3), names=CSV_NAMES, sep="\t",
                                             dtypes=CSV_DTYPES, num_partitions=8),
    "reader_surface": lambda M, t: M.DataFrameReader(default_parallelism=2).option(
        "sep", "\t").schema(CSV_NAMES, CSV_DTYPES).csv(_csv(t, files=2)),
    "criteo_features": lambda M, t: M.read_csv(
        _csv(t, rows=64), names=CSV_NAMES, sep="\t", dtypes=CSV_DTYPES,
        num_partitions=2).withColumns({
            "I1": M.log1p(M.col("I1").fillna(0.0)), "I2": M.col("I2").fillna(0.0),
            "C1": M.hash_bucket(M.col("C1"), 32), "C2": M.hash_bucket(M.col("C2"), 16)}),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_matches_jax(tmp_path, name):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = PIPELINES[name](jdf, tmp_path / "j")
    got = PIPELINES[name](tdf, tmp_path / "t")
    assert got.columns == want.columns
    assert got.num_partitions == want.num_partitions
    assert chunks_of(got) == chunks_of(want)
    assert got.count() == want.count()


def test_actions_match_jax(capsys):
    for M in (jdf, tdf):
        df = toy(M, n=30, parts=3)
        rows = df.take(5)
        assert [sorted(r) for r in rows] == [["k", "name", "x", "y"]] * 5
        df.show(4)
    j_out, t_out = capsys.readouterr().out.split("x | y | name | k\n")[1:]
    assert j_out == t_out
    jp, tp = toy(jdf).toPandas(), toy(tdf).toPandas()
    assert isinstance(tp, dict) and list(tp) == list(jp)
    for c in jp:
        np.testing.assert_array_equal(tp[c], jp[c])
    assert repr(toy(tdf)) == repr(toy(jdf))
    assert (tdf.col("x") * tdf.col("y")).name == "(x * y)"
    assert tdf.clip(tdf.col("x"), 0, 1).name == "clip(x)"


def test_to_dataset_vector_packing_matches_jax():
    rows = [{"I1": float(i), "I2": float(2 * i), "C1": i % 3, "label": i % 2}
            for i in range(10)]
    got = tdf.from_rows(rows, num_partitions=2).to_dataset(
        vector_columns={"dense": ["I1", "I2"], "sparse": ["C1"]})
    want = jdf.from_rows(rows, num_partitions=2).to_dataset(
        vector_columns={"dense": ["I1", "I2"], "sparse": ["C1"]})
    assert isinstance(got, T) and got.num_partitions == want.num_partitions == 2
    for g, w in zip(got.collect(), want.collect()):
        assert set(g) == set(w) == {"dense", "sparse", "label"}
        for k in g:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_session_read_and_create_dataframe(tmp_path, cpu_session):
    """``spark.read`` is a reader at the session's default parallelism;
    ``createDataFrame`` columnarizes rows over it, as JAX's."""
    path = _csv(tmp_path)
    got = cpu_session.read.option("sep", "\t").schema(CSV_NAMES, CSV_DTYPES).csv(path)
    want = jdf.DataFrameReader(default_parallelism=cpu_session.default_parallelism).option(
        "sep", "\t").schema(CSV_NAMES, CSV_DTYPES).csv(path)
    assert chunks_of(got) == chunks_of(want)
    rows = [{"a": i, "b": float(i) / 2} for i in range(9)]
    df = cpu_session.createDataFrame(rows)
    assert cpu_session.create_dataframe == cpu_session.createDataFrame
    assert chunks_of(df) == chunks_of(jdf.from_rows(
        rows, num_partitions=cpu_session.default_parallelism))
    with pytest.raises(ValueError, match="schema"):
        cpu_session.read.csv(path)


def test_readers_refuse_as_jax(tmp_path):
    for M in (jdf, tdf):
        with pytest.raises(FileNotFoundError):
            M.read_csv(str(tmp_path / "nope-*.csv"), names=["v"])
        with pytest.raises(ValueError):
            M.hash_bucket(M.col("x"), 0)
        with pytest.raises(ValueError, match="cannot infer schema"):
            M.from_rows([])
    p = tmp_path / "data[1].csv"
    p.write_text("5\n")
    assert tdf.read_csv(str(p), names=["v"], num_partitions=1).collect()[0]["v"] == 5.0


@pytest.mark.parametrize("case", ["single_row_groups", "multi_file", "directory",
                                  "schema_dtypes"])
def test_read_parquet_matches_jax(tmp_path, case):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    d = tmp_path / "pq"
    d.mkdir()
    if case == "single_row_groups":
        pq.write_table(pa.table({"x": np.arange(100, dtype=np.float32),
                                 "s": [f"u{i % 5}" for i in range(100)]}),
                       d / "t.parquet", row_group_size=25)
        build = lambda M: M.read_parquet(str(d / "t.parquet"), num_partitions=2)  # noqa: E731
    elif case in ("multi_file", "directory"):
        for i in range(3):
            pq.write_table(pa.table({"v": np.full(4, i, np.int64)}), d / f"part-{i}.parquet")
        path = str(d / "part-*.parquet") if case == "multi_file" else str(d)
        build = lambda M: M.DataFrameReader(default_parallelism=8).parquet(path)  # noqa: E731
    else:
        pq.write_table(pa.table({"x": np.array([1.7, 2.2])}), d / "d.parquet")
        build = lambda M: M.DataFrameReader(default_parallelism=1).schema(  # noqa: E731
            ["x"], {"x": np.int32}).parquet(str(d / "d.parquet"))
    got, want = build(tdf), build(jdf)
    assert got.columns == want.columns and got.num_partitions == want.num_partitions
    assert chunks_of(got) == chunks_of(want)


def agg_frame(M, C, n=3000, kmod=101, key_dtype=np.int64, seed=5):
    rng = np.random.default_rng(seed)
    k = ((np.arange(n) * 2654435761) % kmod).astype(key_dtype)
    v = rng.integers(-100, 100, n).astype(np.float64)
    w = rng.integers(0, 9, n).astype(np.int32)
    chunks = [{"k": k[i::3].copy(), "v": v[i::3].copy(), "w": w[i::3].copy()}
              for i in range(3)]
    return M.DataFrame(C.from_generators([(lambda c=c: iter([c])) for c in chunks]),
                       ["k", "v", "w"])


def agg_bytes(df) -> list:
    """The result's rows as (column, dtype, bytes) over the concatenated
    chunks (chunking is layout, not content)."""
    chunks = [ch for p in range(df.num_partitions) for ch in df._chunks.iter_partition(p)]
    return [(c, chunks[0][c].dtype.str,
             np.ascontiguousarray(np.concatenate([ch[c] for ch in chunks])).tobytes())
            for c in sorted(chunks[0])]


AGG_SPECS = {
    "count": {"v": "count"}, "sum": {"v": "sum"}, "mean": {"v": "mean"},
    "min": {"w": "min"}, "max": {"v": "max"},
    "all": {"k": "count", "v": "sum", "w": "mean"},
}


@pytest.mark.parametrize("route", ["serial", "tuple", "columnar", "device"])
@pytest.mark.parametrize("spec", sorted(AGG_SPECS))
def test_agg_route_matches_jax(cpu_session, spec, route):
    """Every route's rows equal JAX's serial output and its columnar
    exchange's, bytes and dtypes (the device route folds on the CPU here,
    the session's device)."""
    s = AGG_SPECS[spec]
    kw = {"serial": dict(num_workers=0), "tuple": dict(num_workers=2, transport="tuple"),
          "columnar": dict(num_workers=2, transport="columnar"),
          "device": dict(transport="device")}[route]
    got = agg_bytes(agg_frame(tdf, T).groupBy("k").agg(s, **kw))
    assert got == agg_bytes(agg_frame(jdf, J).groupBy("k").agg(s, num_workers=0))
    assert got == agg_bytes(agg_frame(jdf, J).groupBy("k").agg(s, num_workers=2,
                                                                transport="columnar"))


def test_agg_count_multikey_and_string_keys_match_jax():
    for M, C in ((tdf, T), (jdf, J)):
        df = toy(M, n=60, parts=3).fillna("none", subset=["name"])
        M._out = [chunks_of(df.groupBy("k").count()),
                  chunks_of(df.groupBy("name", "k").agg({"y": "sum"})),
                  chunks_of(df.groupBy("name").agg({"name": "count"}))]
    assert tdf._out == jdf._out
    del tdf._out, jdf._out


def test_agg_refusals_match_jax(monkeypatch):
    msgs = []
    for M, C in ((tdf, T), (jdf, J)):
        df = agg_frame(M, C)
        got = []
        for bad in (lambda: df.groupBy("nope"), lambda: df.groupBy(),
                    lambda: df.groupBy("k").agg({"v": "median"}),
                    lambda: df.groupBy("k").agg({"v": "sum"}, max_groups=0)):
            with pytest.raises(ValueError) as ei:
                bad()
            got.append(str(ei.value))
        nan = M.DataFrame(C.from_generators([lambda: iter(
            [{"k": np.asarray([1.0, np.nan]), "v": np.asarray([1.0, 2.0])}])]), ["k", "v"])
        with pytest.raises(ValueError, match="NaN") as ei:
            agg_bytes(nan.groupBy("k").agg({"v": "sum"}))
        got.append(str(ei.value))
        with pytest.raises(ValueError, match="max_groups=10") as ei:
            agg_bytes(agg_frame(M, C).groupBy("k").agg({"v": "sum"}, max_groups=10))
        got.append(str(ei.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_device_route_raises_without_cuda_and_refuses_string_keys():
    """No session, no CUDA: the device route raises (no host fallback);
    on the CPU session it refuses string keys as JAX's does."""
    df = agg_frame(tdf, T).groupBy("k").agg({"v": "sum"}, transport="device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        agg_bytes(df)
    spark = Session.builder.config(DEVICE_CONF, "cpu").getOrCreate()
    try:
        strs = tdf.DataFrame(T.from_generators([lambda: iter(
            [{"k": np.asarray(["a", "b", "a"]), "v": np.asarray([1.0, 2.0, 3.0])}])]),
            ["k", "v"])
        with pytest.raises(ValueError, match="numeric"):
            agg_bytes(strs.groupBy("k").agg({"v": "sum"}, transport="device"))
    finally:
        spark.stop()

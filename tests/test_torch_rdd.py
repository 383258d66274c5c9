"""The port's ``PartitionedDataset`` against the JAX package's, verb by
verb, on the same data: each verb's output partition by partition (or its
result, for an action) equal to JAX's; the wide verbs' serial paths bucket
by the same canonical key hash; and with shuffle workers (``num_workers=``
or ``DLS_DATA_WORKERS``) the wide verbs go through the port's exchange and
give the JAX exchange's partitions (``test_torch_exchange.py`` holds the
exchange itself)."""

import operator

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.data import exchange as jexchange
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as J
from distributeddeeplearningspark_tpu_torch.data import exchange as texchange
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as T
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    monkeypatch.delenv("DLS_DATA_WORKERS", raising=False)
    monkeypatch.delenv("DLS_AGG_MAX_GROUPS", raising=False)


def _data():
    rng = np.random.default_rng(0)
    return [int(x) for x in rng.integers(0, 23, size=97)]


def _pairs():
    rng = np.random.default_rng(1)
    keys = ["a", "b", "c", 1, 2, (3, "x"), 4.5]
    return [(keys[int(k)], int(v)) for k, v in
            zip(rng.integers(0, len(keys), 80), rng.integers(-50, 50, 80))]


def _parts(ds):
    return [list(ds.iter_partition(i)) for i in range(ds.num_partitions)]


# each: (name, build(cls, data, pairs) -> dataset or value). A dataset is
# compared partition by partition, anything else as a value.
VERBS = [
    ("map", lambda C, d, p: C.parallelize(d, 4).map(lambda x: x * 3)),
    ("filter", lambda C, d, p: C.parallelize(d, 4).filter(lambda x: x % 3 == 0)),
    ("flat_map", lambda C, d, p: C.parallelize(d, 3).flat_map(lambda x: [x] * (x % 3))),
    ("flatMap", lambda C, d, p: C.parallelize(d, 3).flatMap(lambda x: range(x % 4))),
    ("map_partitions", lambda C, d, p: C.parallelize(d, 4).mapPartitions(lambda it: [sum(it)])),
    ("map_partitions_with_index", lambda C, d, p: C.parallelize(d, 4)
     .mapPartitionsWithIndex(lambda i, it: [(i, len(list(it)))])),
    ("batch", lambda C, d, p: C.parallelize(d, 3).batch(7)),
    ("batch_remainder", lambda C, d, p: C.parallelize(d, 3).batch(7, drop_remainder=False)),
    ("shuffle", lambda C, d, p: C.parallelize(d, 3).shuffle(seed=5)),
    ("repeat", lambda C, d, p: C.parallelize(d, 2).repeat(3)),
    ("coalesce", lambda C, d, p: C.parallelize(d, 7).coalesce(3)),
    ("coalesce_noop", lambda C, d, p: C.parallelize(d, 2).coalesce(5)),
    ("union", lambda C, d, p: C.parallelize(d, 2).union(C.parallelize(d[:10], 3))),
    ("sample", lambda C, d, p: C.parallelize(d, 4).sample(0.3, seed=9)),
    ("distinct", lambda C, d, p: C.parallelize(d, 4).distinct()),
    ("cache", lambda C, d, p: C.parallelize(d, 3).map(lambda x: -x).cache()),
    ("reduce_by_key", lambda C, d, p: C.parallelize(p, 3).reduce_by_key(operator.add)),
    ("reduceByKey_5", lambda C, d, p: C.parallelize(p, 3).reduceByKey(max, 5)),
    ("reduce_by_key_combine", lambda C, d, p: C.parallelize(p, 2)
     .reduce_by_key(min, combine="min")),
    ("group_by_key", lambda C, d, p: C.parallelize(p, 3).group_by_key()),
    ("groupByKey_2", lambda C, d, p: C.parallelize(p, 4).groupByKey(2)),
    ("sort_by", lambda C, d, p: C.parallelize(d, 3).sort_by(lambda x: x)),
    ("sortBy_desc", lambda C, d, p: C.parallelize(p, 3)
     .sortBy(lambda kv: kv[1], ascending=False, num_partitions=4)),
    ("zip_with_index", lambda C, d, p: C.parallelize(d, 4).zipWithIndex()),
    ("collect", lambda C, d, p: C.parallelize(d, 4).collect()),
    ("count", lambda C, d, p: C.parallelize(d, 4).filter(lambda x: x > 10).count()),
    ("take", lambda C, d, p: C.parallelize(d, 4).take(30)),
    ("first", lambda C, d, p: C.parallelize(d, 4).first()),
    ("reduce", lambda C, d, p: C.parallelize(d, 4).reduce(operator.add)),
    ("tree_aggregate", lambda C, d, p: C.parallelize(d, 4).treeAggregate(
        [0, 0], lambda acc, x: [acc[0] + x, acc[1] + 1],
        lambda a, b: [a[0] + b[0], a[1] + b[1]])),
    ("getNumPartitions", lambda C, d, p: C.parallelize(d, 6).getNumPartitions()),
    ("numpy_parallelize", lambda C, d, p: C.parallelize(np.arange(10), 3).map(int)),
]


@pytest.mark.parametrize("name,build", VERBS, ids=[v[0] for v in VERBS])
def test_verb_matches_jax(name, build):
    want = build(J, _data(), _pairs())
    got = build(T, _data(), _pairs())
    if isinstance(want, J):
        assert isinstance(got, T)
        assert got.num_partitions == want.num_partitions
        assert _parts(got) == _parts(want)
        assert _parts(got) == _parts(want)  # a second pass (cache, memo) too
    else:
        assert got == want


def test_foreach_partition_visits_each_partition_in_order():
    seen = {"j": [], "t": []}
    J.parallelize(_data(), 3).foreach_partition(lambda it: seen["j"].append(list(it)))
    T.parallelize(_data(), 3).foreachPartition(lambda it: seen["t"].append(list(it)))
    assert seen["t"] == seen["j"] and len(seen["t"]) == 3


def test_cache_commits_only_a_whole_pass():
    calls = []
    ds = T.parallelize(list(range(6)), 1).map(lambda x: calls.append(x) or x).cache()
    assert ds.take(2) == [0, 1]
    assert ds.collect() == list(range(6))
    n = len(calls)
    assert ds.collect() == list(range(6)) and len(calls) == n


@pytest.mark.parametrize("verb", ["shuffle", "coalesce", "distinct", "cache",
                                  "reduce_by_key", "group_by_key", "sort_by",
                                  "zip_with_index", "collect", "count"])
def test_infinite_datasets_are_refused_as_jax(verb):
    args = {"reduce_by_key": (operator.add,), "sort_by": (lambda x: x,),
            "coalesce": (1,)}.get(verb, ())
    for C in (J, T):
        ds = C.parallelize([(1, 2)] * 4, 2).repeat()
        with pytest.raises(ValueError, match="infinite"):
            out = getattr(ds, verb)(*args)
            if isinstance(out, C):
                out.collect()
    with pytest.raises(ValueError, match="infinite"):
        T.parallelize([1], 1).union(T.parallelize([1], 1).repeat())


def test_bad_arguments_are_refused_as_jax():
    for C in (J, T):
        ds = C.parallelize(_pairs(), 2)
        with pytest.raises(ValueError, match="fraction"):
            ds.sample(1.5)
        with pytest.raises(ValueError, match="num_partitions"):
            ds.reduce_by_key(operator.add, 0)
        with pytest.raises(ValueError, match="combine"):
            ds.reduce_by_key(operator.add, combine="mean")
        with pytest.raises(ValueError, match="empty"):
            C.parallelize([], 1).first()


def test_serial_ceiling_refuses_loudly(monkeypatch):
    monkeypatch.setenv("DLS_AGG_MAX_GROUPS", "5")
    for C in (J, T):
        with pytest.raises(ValueError, match="max_groups=5"):
            C.parallelize(list(range(20)), 2).distinct().collect()
        with pytest.raises(ValueError, match="max_groups=5"):
            C.parallelize([(i, i) for i in range(20)], 2).reduce_by_key(
                operator.add).collect()


def test_key_hash_and_bucket_match_jax():
    for key in ["a", 1, (3, "x"), 4.5, None, b"raw"]:
        kb = texchange.key_bytes(key)
        assert kb == jexchange.key_bytes(key)
        for n in (1, 3, 7):
            assert texchange.bucket_of(kb, n) == jexchange.bucket_of(kb, n)
    assert texchange.NUMERIC_COMBINES == jexchange.NUMERIC_COMBINES
    assert texchange.max_groups_limit(7) == 7


@pytest.mark.parametrize("verb,call", [
    ("distinct", lambda ds, **kw: ds.distinct(**kw)),
    ("reduce_by_key", lambda ds, **kw: ds.reduce_by_key(operator.add, **kw)),
    ("group_by_key", lambda ds, **kw: ds.group_by_key(**kw)),
    ("sort_by", lambda ds, **kw: ds.sort_by(lambda kv: kv[1], **kw)),
])
@pytest.mark.parametrize("how", ["env", "argument"])
def test_shuffle_workers_raise_naming_the_exchange(monkeypatch, tmp_path, verb, call, how):
    """With workers (``DLS_DATA_WORKERS`` or ``num_workers=``) the wide
    verbs take the port's exchange: partition by partition what the JAX
    exchange gives at the same worker count; ``num_workers=0`` keeps the
    serial path under the env, also as JAX's."""
    monkeypatch.setenv("DLS_SHUFFLE_SPILL_DIR", str(tmp_path))
    kw = {}
    if how == "env":
        monkeypatch.setenv("DLS_DATA_WORKERS", "2")
    else:
        kw = {"num_workers": 2}
    got = _parts(call(T.parallelize(_pairs(), 3), **kw))
    assert got == _parts(call(J.parallelize(_pairs(), 3), **kw))
    assert sum(len(p) for p in got) > 0
    assert _parts(call(T.parallelize(_pairs(), 3), num_workers=0)) == _parts(
        call(J.parallelize(_pairs(), 3), num_workers=0))

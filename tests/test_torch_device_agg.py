"""The port's device aggregation (``data/device_agg.py``) on
``device="cpu"``, bitwise against the JAX package's host paths: its
exchange's ``combine_planes`` (the ``reduceat`` fold) for ``segment_reduce``
and ``segment_combine``, and the host heap for :class:`TopV` (ties
included). The JAX package's own device path is not the reference: on
JAX 0.9.0 its ``available()`` probe of ``jax.experimental.enable_x64`` fails
and ``tests/test_columnar.py`` skips its device tests, while the JAX
module's contract is that the device fold, the ``reduceat`` fold and the
heap give the same bytes.
"""

import heapq

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.data import exchange as jx
from distributeddeeplearningspark_tpu_torch import Session
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import device_agg
from distributeddeeplearningspark_tpu_torch.data import exchange as tx
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from test_torch_deadline import per_test

DTYPES = [np.int32, np.int64, np.float32, np.float64]


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(device_agg, "_folds", {})


def planes(n=20_000, nkeys=3000, dtype=np.int64, seed=0, collide=False):
    """Unsorted key-hash planes over ``nkeys`` int64 keys with integer-valued
    values in ``dtype`` (sums exact at every width)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nkeys, n).astype(np.int64) * 7919
    uniq, inv = np.unique(keys, return_inverse=True)
    h = jx.hash_rows([(int(k),) for k in uniq])[inv]
    if collide:
        h = h & np.uint64(0xFF)  # 8-bit hashes: distinct keys share runs
    vals = rng.integers(-1000, 1000, n).astype(dtype)
    return h, keys, vals


def same(got, want) -> bool:
    return (got.h.tobytes() == want.h.tobytes()
            and all(g.tobytes() == w.tobytes() for g, w in zip(got.keys, want.keys))
            and all(g.dtype == w.dtype and g.tobytes() == w.tobytes()
                    for g, w in zip(got.vals, want.vals)))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_segment_combine_equals_combine_planes(op, dtype):
    h, k, v = planes(dtype=dtype)
    want = jx.combine_planes(jx._Planes(h, (k,), (v,)), jx.reduce_pair_plan(op))
    got = device_agg.segment_combine(tx._Planes(h, (k,), (v,)), tx.reduce_pair_plan(op),
                                     device="cpu")
    assert same(got, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_combine_with_hash_collisions(op):
    """Colliding runs take the exchange's full-key path: the JAX bytes."""
    h, k, v = planes(n=3000, nkeys=700, collide=True)
    want = jx.combine_planes(jx._Planes(h, (k,), (v,)), jx.reduce_pair_plan(op))
    got = device_agg.segment_combine(tx._Planes(h, (k,), (v,)), tx.reduce_pair_plan(op),
                                     device="cpu")
    assert same(got, want)


def test_segment_combine_agg_planes_multi_value():
    """An agg's layout (int64 count, f64 sum and min planes) in one call."""
    h, k, v = planes(dtype=np.float64)
    cnt = np.ones(len(k), np.int64)
    plan_t = tx.ColumnarPlan(combines=("sum", "sum", "min"), pre_planes=None,
                             key_of_row=lambda r: r, vals_to_acc=None, row_emit=None)
    plan_j = jx.ColumnarPlan(combines=("sum", "sum", "min"), pre_planes=None,
                             key_of_row=lambda r: r, vals_to_acc=None, row_emit=None)
    want = jx.combine_planes(jx._Planes(h, (k,), (cnt, v, v)), plan_j)
    got = device_agg.segment_combine(tx._Planes(h, (k,), (cnt, v, v)), plan_t,
                                     device="cpu")
    assert same(got, want)


@pytest.mark.parametrize("case", ["empty", "all_distinct"])
def test_segment_combine_trivial_planes(case):
    n = 0 if case == "empty" else 50
    h, k, v = planes(n=n, nkeys=10**9)
    got = device_agg.segment_combine(tx._Planes(h, (k,), (v,)), tx.reduce_pair_plan("sum"),
                                     device="cpu")
    want = jx.combine_planes(jx._Planes(h, (k,), (v,)), jx.reduce_pair_plan("sum"))
    assert same(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_segment_reduce_exact(dtype):
    v = np.asarray([1, 2, -3, 7, 0], dtype)
    ids = np.asarray([0, 0, 1, 1, 2], np.int32)
    starts = np.asarray([0, 2, 4])
    for op, fold in (("sum", np.add), ("min", np.minimum), ("max", np.maximum)):
        got = device_agg.segment_reduce(op, v, ids, 3, device="cpu")
        want = fold.reduceat(v, starts)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="prod"):
        device_agg.segment_reduce("prod", v, ids, 3, device="cpu")


def test_segment_reduce_propagates_nan_as_reduceat():
    v = np.asarray([1.0, np.nan, 3.0, 4.0])
    ids = np.asarray([0, 0, 1, 1])
    for op, fold in (("min", np.minimum), ("max", np.maximum), ("sum", np.add)):
        got = device_agg.segment_reduce(op, v, ids, 2, device="cpu")
        np.testing.assert_array_equal(got, fold.reduceat(v, [0, 2]))


def heap_top(cnts, toks, v):
    heap: list = []
    for c, t in zip(cnts, toks):
        if len(heap) < v:
            heapq.heappush(heap, (c, t))
        elif (c, t) > heap[0]:
            heapq.heapreplace(heap, (c, t))
    return sorted(heap, reverse=True)


@pytest.mark.parametrize("v,block,step", [(50, 512, 700), (1, 64, 100), (3000, 1024, 5000),
                                          (200, 4096, 333)])
def test_top_v_equals_the_heap_with_ties(v, block, step):
    """Heavy ties (counts 1–39 over 5,000 tokens): the stable sort's
    lowest-index rule gives the heap's (count, token) order."""
    rng = np.random.default_rng(3)
    toks = np.asarray([f"t{i}" for i in range(5000)])
    cnts = rng.integers(1, 40, size=5000)
    tv = device_agg.TopV(v, block=block, device="cpu")
    for lo in range(0, 5000, step):
        tv.update(cnts[lo:lo + step], toks[lo:lo + step])
    assert tv.ranked() == heap_top(cnts.tolist(), toks.tolist(), v)


def test_top_v_int_payloads_and_empty():
    tv = device_agg.TopV(4, device="cpu")
    assert tv.ranked() == []
    tv.update([5, 5, 5, 1, 9], [10, 30, 20, 40, 0])
    assert tv.ranked() == [(9, 0), (5, 30), (5, 20), (5, 10)]
    with pytest.raises(ValueError):
        device_agg.TopV(0, device="cpu")


def test_device_resolution_has_no_host_fallback():
    """No session and no CUDA: every entry raises; the CPU is only where
    asked for, or where the active session lies."""
    v = np.ones(4)
    ids = np.zeros(4, np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_agg.available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_agg.segment_reduce("sum", v, ids, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_agg.TopV(3)
    assert device_agg.available("cpu") == torch.device("cpu")
    spark = Session.builder.config(DEVICE_CONF, "cpu").getOrCreate()
    try:
        assert device_agg.available() == torch.device("cpu")
        assert device_agg.segment_reduce("sum", v, ids, 1).tolist() == [4.0]
    finally:
        spark.stop()


def test_signature_ledger_one_signature_per_bucket(tmp_path):
    """Each fold is ledgered under the JAX names; a warm repeat at the same
    pow-2 bucket records nothing new, a larger bucket one more."""
    wd = tmp_path / "wd"
    ttele.configure(str(wd))
    try:
        h, k, v = planes(n=5000, dtype=np.float64)
        for _ in range(2):
            device_agg.segment_combine(tx._Planes(h, (k,), (v,)), tx.reduce_pair_plan("sum"),
                                       device="cpu")
        tv = device_agg.TopV(10, block=256, device="cpu")
        tv.update(np.arange(600), np.arange(600))
        events = ttele.read_events(str(wd))
        compiles = [e for e in events if e.get("kind") == "compile"]
        assert sorted(e["fn"] for e in compiles) == ["device_agg.segment_sum",
                                                     "device_agg.top_v"]
        assert not any(e["recompile"] for e in compiles)
        h2, k2, v2 = planes(n=50_000, nkeys=20_000, dtype=np.float64)
        device_agg.segment_combine(tx._Planes(h2, (k2,), (v2,)),
                                   tx.reduce_pair_plan("sum"), device="cpu")
        events = ttele.read_events(str(wd))
        assert len([e for e in events if e.get("kind") == "compile"]) == 3
    finally:
        ttele.reset()

"""The port's shuffle exchange (``data/exchange.py``) against the JAX
package's on the same numpy-seeded inputs.

- each of the five wide operations (``reduce_by_key``, ``group_by_key``,
  ``distinct``, ``sort_by``, ``groupBy().agg``) at 0, 1 and 4 workers in
  both transports: partition by partition equal to the JAX exchange's, and
  equal by a blake2b digest of the partitions;
- spilled reducers equal to in-memory ones;
- the columnar transport's edges, as ``tests/test_columnar.py`` holds the
  JAX package's: key dtypes, forced hash collisions, int sums past int32,
  signed-zero float keys, bool values, mixed-eligibility buckets;
- failures typed, serial ceilings naming the exchange, nothing left behind
  (no ``dlsx-`` child, ``/dev/shm`` segment or spill file);
- the ``shuffle`` events, read into the same shuffle block by the port's
  ``status`` and the JAX package's.
"""

import hashlib
import multiprocessing as mp
import operator
import os
import pickle
import signal
import time

import numpy as np
import pytest

from distributeddeeplearningspark_tpu import status as jstatus
from distributeddeeplearningspark_tpu.data import dataframe as jdf
from distributeddeeplearningspark_tpu.data import exchange as jx
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as J
from distributeddeeplearningspark_tpu_torch import status as tstatus
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import dataframe as tdf
from distributeddeeplearningspark_tpu_torch.data import exchange as tx
from distributeddeeplearningspark_tpu_torch.data.workers import WorkerCrashed
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as T
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _spill_here(tmp_path, monkeypatch):
    """Spill directories under tmp_path, so the leak check sees every one;
    no worker count, budget or transport from the environment."""
    spill_root = tmp_path / "spill"
    spill_root.mkdir()
    monkeypatch.setenv(tx.SPILL_DIR_ENV, str(spill_root))
    for var in ("DLS_DATA_WORKERS", tx.MEM_MB_ENV, tx.TRANSPORT_ENV,
                tx.MAX_GROUPS_ENV, "DLS_FAULT"):
        monkeypatch.delenv(var, raising=False)
    yield spill_root


def assert_no_leaks(spill_root) -> None:
    """No ``dlsx-`` child, ``/dev/shm`` segment of this process or spill
    directory outlives an exchange."""
    deadline = time.time() + 5.0
    while time.time() < deadline and [
            p for p in mp.active_children() if p.name.startswith("dlsx-")]:
        time.sleep(0.05)
    assert not [p for p in mp.active_children() if p.name.startswith("dlsx-")]
    if os.path.isdir("/dev/shm"):
        mine = [f for f in os.listdir("/dev/shm") if f.startswith(f"dlsx-{os.getpid()}-")]
        assert not mine, mine
    import gc

    gc.collect()  # ShuffleResult finalizers remove the spill directories
    left = [str(p) for d in spill_root.iterdir() for p in d.iterdir()]
    assert not left, left


def parts(ds) -> list[list]:
    return [list(ds.iter_partition(i)) for i in range(ds.num_partitions)]


def digest(partitions: list[list]) -> str:
    return hashlib.blake2b(pickle.dumps(partitions, protocol=4),
                           digest_size=16).hexdigest()


def pairs(C, n=3000, kmod=97, nparts=4, seed=0):
    """(int key, int value) pairs from a seeded generator, strided over
    ``nparts`` partitions."""
    rng = np.random.default_rng(seed)
    keys = ((np.arange(n) * 2654435761) % kmod).tolist()
    vals = rng.integers(-50, 50, n).tolist()
    data = list(zip(keys, vals))
    return C.from_generators([(lambda c=data[i::nparts]: iter(c)) for i in range(nparts)])


def frame(mod, C, n=6000, kmod=151, nparts=3, key_dtype=np.int64, seed=7):
    """A DataFrame of ``k`` keys and integer-valued f64 ``v`` values (their
    sums are exact, so they are the same bits at any worker count)."""
    rng = np.random.default_rng(seed)
    k = ((np.arange(n) * 2654435761) % kmod).astype(key_dtype)
    v = rng.integers(-1000, 1000, size=n).astype(np.float64)
    chunks = []
    for i in range(nparts):
        sl = slice(i * n // nparts, (i + 1) * n // nparts)
        chunks.append({"k": k[sl].copy(), "v": v[sl].copy()})
    return mod.DataFrame(C.from_generators([(lambda c=c: iter([c])) for c in chunks]),
                         ["k", "v"])


def frame_bytes(df) -> bytes:
    """A result's bytes, column by column over the concatenated rows (the
    chunking is layout, not content)."""
    chunks = [ch for p in range(df._chunks.num_partitions)
              for ch in df._chunks.iter_partition(p)]
    assert chunks, "empty result"
    return b"".join(np.ascontiguousarray(np.concatenate(
        [np.atleast_1d(ch[c]) for ch in chunks])).tobytes() for c in sorted(chunks[0]))


def frame_parts(df) -> list:
    """Partition by partition: each partition's columns concatenated."""
    out = []
    for p in range(df._chunks.num_partitions):
        chunks = list(df._chunks.iter_partition(p))
        out.append({c: np.concatenate([ch[c] for ch in chunks]).tobytes()
                    for c in (sorted(chunks[0]) if chunks else [])})
    return out


AGG_SPEC = {"v": "sum", "k": "count"}

#: op -> (build(C, mod, nw, transport) -> dataset or DataFrame)
OPS = {
    "reduce_by_key": lambda C, M, nw, tr: pairs(C).reduce_by_key(
        operator.add, num_workers=nw, combine="sum", transport=tr),
    "group_by_key": lambda C, M, nw, tr: pairs(C).group_by_key(num_workers=nw),
    "distinct": lambda C, M, nw, tr: pairs(C).map(lambda kv: kv[0] * 3 + kv[1] % 2)
    .distinct(num_workers=nw, transport=tr),
    "sort_by": lambda C, M, nw, tr: pairs(C).sort_by(lambda kv: (kv[1], kv[0]),
                                                     num_workers=nw),
    "groupBy_agg": lambda C, M, nw, tr: frame(M, C).groupBy("k").agg(
        AGG_SPEC, num_workers=nw, transport=tr),
}


def _outputs(op, nw, tr):
    want = OPS[op](J, jdf, nw, tr)
    got = OPS[op](T, tdf, nw, tr)
    if op == "groupBy_agg":
        return frame_parts(got), frame_parts(want), frame_bytes(got), frame_bytes(want)
    g, w = parts(got), parts(want)
    return g, w, digest(g), digest(w)


@pytest.mark.parametrize("transport", ["tuple", "columnar"])
@pytest.mark.parametrize("nw", [0, 1, 4])
@pytest.mark.parametrize("op", sorted(OPS))
def test_wide_op_matches_jax_exchange(_spill_here, op, nw, transport):
    """The port's output partition by partition and by digest equal to the
    JAX package's at the same worker count and transport."""
    got, want, got_digest, want_digest = _outputs(op, nw, transport)
    assert len(got) == len(want)
    assert got == want
    assert got_digest == want_digest
    assert_no_leaks(_spill_here)


@pytest.mark.parametrize("op", ["reduce_by_key", "group_by_key", "groupBy_agg"])
def test_output_is_the_same_at_any_worker_count(_spill_here, op):
    """The canonical layout: 0, 1 and 4 workers, both transports, one
    output (``distinct``'s serial path collapses to one partition by
    contract, ``sort_by``'s boundaries fall on sample quantiles)."""
    def port_digest(nw, tr):
        out = OPS[op](T, tdf, nw, tr)
        return frame_bytes(out) if op == "groupBy_agg" else digest(parts(out))

    outs = {(nw, tr): port_digest(nw, tr) for nw in (0, 1, 4)
            for tr in ("tuple", "columnar")}
    assert len(set(outs.values())) == 1, outs


@pytest.mark.parametrize("transport", ["tuple", "columnar"])
def test_spill_path_equals_in_memory(_spill_here, monkeypatch, transport):
    """The 4 MB floor budget forces reducer spills; the merged output
    equals the in-memory one and the JAX exchange's under the same budget."""
    def run(C, mem):
        if mem:
            monkeypatch.setenv(tx.MEM_MB_ENV, mem)
        else:
            monkeypatch.delenv(tx.MEM_MB_ENV, raising=False)
        # the columnar planes are compact: 200k keys overflow the floor
        n = 60_000 if transport == "tuple" else 200_000
        return parts(pairs(C, n=n, kmod=n - 1).reduce_by_key(
            operator.add, num_workers=2, combine="sum", transport=transport))

    big = run(T, None)
    seen: dict = {}
    orig = tx.run_exchange
    monkeypatch.setattr(tx, "run_exchange",
                        lambda *a, **k: (lambda r: (seen.update(r.stats), r)[1])(orig(*a, **k)))
    small = run(T, "4")
    assert seen["spills"] >= 1, seen
    assert small == big
    assert small == run(J, "4")
    assert_no_leaks(_spill_here)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_dtype_edge_keys_match_jax(_spill_here, dtype):
    got = frame_bytes(frame(tdf, T, key_dtype=dtype).groupBy("k").agg(
        AGG_SPEC, num_workers=2, transport="columnar"))
    assert got == frame_bytes(frame(jdf, J, key_dtype=dtype).groupBy("k").agg(
        AGG_SPEC, num_workers=2, transport="tuple"))
    assert got == frame_bytes(frame(tdf, T, key_dtype=dtype).groupBy("k").agg(
        AGG_SPEC, num_workers=2, transport="tuple"))


def _tiny_hash_key_bytes(key):
    """An 8-bit canonical hash: distinct keys collide on ``key_hash``."""
    kb = pickle.dumps(key, protocol=4)
    return b"\x00" * 7 + hashlib.blake2b(kb, digest_size=1).digest() + kb


def test_forced_hash_collisions_resolve_as_jax(_spill_here, monkeypatch):
    """With an 8-bit hash, 151 keys collide constantly: the columnar path
    compares full keys and still gives the tuple path's bytes, the serial
    path's and the JAX exchange's under the same hash."""
    monkeypatch.setattr(tx, "key_bytes", _tiny_hash_key_bytes)
    monkeypatch.setattr(jx, "key_bytes", _tiny_hash_key_bytes)
    got = frame_bytes(frame(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=2,
                                                     transport="columnar"))
    for other in (frame(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=2, transport="tuple"),
                  frame(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=0),
                  frame(jdf, J).groupBy("k").agg(AGG_SPEC, num_workers=2,
                                                 transport="columnar")):
        assert got == frame_bytes(other)


def test_combine_colliding_orders_by_full_key_bytes():
    keys = np.array([300, 5, 300, 1000000, 5], dtype=np.int64)
    vals = np.array([1, 2, 3, 4, 5], dtype=np.int64)
    h = np.zeros(5, dtype=np.uint64)
    got = tx.combine_planes(tx._Planes(h, (keys,), (vals,)), tx.reduce_pair_plan("sum"))
    want = jx.combine_planes(jx._Planes(h, (keys,), (vals,)), jx.reduce_pair_plan("sum"))
    assert got.keys[0].tolist() == want.keys[0].tolist() == [
        k for k in sorted({300, 5, 1000000}, key=tx.key_bytes)]
    assert got.vals[0].tolist() == want.vals[0].tolist()


def test_int_sums_past_int32_stay_exact(_spill_here):
    """Values past int32 leave the int64 planes (the tuple path's Python
    ints are arbitrary-precision): exact, not wrapped, as JAX's."""
    big = 2 ** 62
    for C in (T, J):
        got = [kv for p in parts(C.parallelize([(1, big), (1, big)], 2).reduce_by_key(
            operator.add, num_workers=2, combine="sum")) for kv in p]
        assert got == [(1, 2 ** 63)]
    data = [(i % 7, 2 ** 31 - 1) for i in range(100)]
    got = parts(T.parallelize(data, 4).reduce_by_key(operator.add, num_workers=2,
                                                      combine="sum"))
    assert got == parts(J.parallelize(data, 4).reduce_by_key(operator.add, num_workers=2,
                                                             combine="sum"))


def test_signed_zero_float_keys_match_jax(_spill_here):
    """-0.0 == 0.0 in a merge dict but they pickle apart: a batch holding a
    signed zero rides the tuple path, as in JAX, at 1 and 2 workers."""
    def mk(mod, C):
        chunks = [{"k": np.asarray([-0.0, 1.0, 2.0]), "v": np.asarray([1.0, 2.0, 3.0])},
                  {"k": np.asarray([0.0, 1.0, 2.0]), "v": np.asarray([4.0, 5.0, 6.0])}]
        return mod.DataFrame(C.from_generators([(lambda c=c: iter([c])) for c in chunks]),
                             ["k", "v"])

    for nw in (1, 2):
        got = frame_bytes(mk(tdf, T).groupBy("k").agg({"v": "sum"}, num_workers=nw))
        assert got == frame_bytes(mk(jdf, J).groupBy("k").agg({"v": "sum"}, num_workers=nw))
    data = [(-0.0, 1), (0.0, 2)]
    got = parts(T.parallelize(data, 2).reduce_by_key(operator.add, num_workers=2,
                                                      combine="sum"))
    assert got == parts(J.parallelize(data, 2).reduce_by_key(operator.add, num_workers=2,
                                                             combine="sum"))


def test_bool_values_keep_their_type(_spill_here):
    got = [kv for p in parts(T.parallelize([(1, True), (1, False)], 2).reduce_by_key(
        min, num_workers=2, combine="min")) for kv in p]
    assert got == [(1, False)] and type(got[0][1]) is bool


@pytest.mark.parametrize("cast", [int, float])
def test_scalar_keys_columnar_match_jax_tuple(_spill_here, cast):
    def mk(C):
        return C.parallelize([(cast(i % 37), i) for i in range(2000)], 4)

    got = parts(mk(T).reduce_by_key(operator.add, num_workers=2, combine="sum"))
    assert got == parts(mk(J).reduce_by_key(operator.add, num_workers=2, transport="tuple"))


def test_mixed_eligibility_buckets_match_jax(_spill_here, monkeypatch):
    """String keys that all hash into bucket 0 beside int keys: bucket 0
    merges as tuples, the others stay columnar, and the bytes equal the
    all-tuple run's and the JAX exchange's."""
    strs, i = [], 0
    while len(strs) < 40:
        if tx.bucket_of(tx.key_bytes((f"tok{i}",)), 3) == 0:
            strs.append(f"tok{i}")
        i += 1

    def mk(mod, C):
        chunks = [{"k": np.arange(j * 400, (j + 1) * 400, dtype=np.int64),
                   "v": np.full(400, float(j + 1))} for j in range(2)]
        chunks.append({"k": np.asarray(strs * 5),
                       "v": np.arange(len(strs) * 5, dtype=np.float64)})
        return mod.DataFrame(C.from_generators([(lambda c=c: iter([c])) for c in chunks]),
                             ["k", "v"])

    seen: dict = {}
    orig = tx.run_exchange
    monkeypatch.setattr(tx, "run_exchange",
                        lambda *a, **k: (lambda r: (seen.update(r.stats), r)[1])(orig(*a, **k)))
    got = frame_bytes(mk(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=2))
    assert seen["transport"] == "mixed" and seen["tuple_buckets"] >= 1
    assert seen["columnar_buckets"] >= 1
    assert got == frame_bytes(mk(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=2,
                                                          transport="tuple"))
    assert got == frame_bytes(mk(jdf, J).groupBy("k").agg(AGG_SPEC, num_workers=2))


def test_sort_by_is_range_partitioned(_spill_here):
    out = parts(pairs(T, n=4000).sort_by(lambda kv: kv[0], num_workers=2))
    assert out == parts(pairs(J, n=4000).sort_by(lambda kv: kv[0], num_workers=2))
    last = None
    for p in out:
        keys = [k for k, _ in p]
        assert keys == sorted(keys)
        if p and last is not None:
            assert last <= p[0][0]
        if p:
            last = p[-1][0]


def test_mapper_exception_is_typed_with_traceback(_spill_here, monkeypatch):
    monkeypatch.setenv(tx.MAX_RETRIES_ENV, "0")

    def boom(a, b):
        if a + b > 50:
            raise ValueError("poisoned combine")
        return a + b

    t0 = time.monotonic()
    with pytest.raises(WorkerCrashed, match="poisoned combine"):
        parts(pairs(T).reduce_by_key(boom, num_workers=2))
    assert time.monotonic() - t0 < 30.0
    assert_no_leaks(_spill_here)


def test_mapper_sigkill_surfaces_worker_crashed(_spill_here, monkeypatch):
    """A mapper SIGKILLed mid-exchange with no retry budget: a typed
    ``WorkerCrashed`` within a bounded wait, everything torn down."""
    monkeypatch.setenv(tx.MAX_RETRIES_ENV, "0")

    def die_at(kv):
        if kv[0] == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return ((kv[0], kv[1]),)

    out = tx._lazy_exchange_dataset(
        pairs(T, n=2000)._parts, num_workers=2, n_out=4,
        spec=tx._Spec(pre=die_at, combine=operator.add), label="sigkill-drill")
    with pytest.raises(WorkerCrashed) as ei:
        parts(out)
    assert "died" in str(ei.value) and ei.value.exitcode == -signal.SIGKILL
    assert_no_leaks(_spill_here)


@pytest.mark.parametrize("op", ["reduce_by_key", "group_by_key", "distinct", "sort_by"])
def test_serial_refusals_name_the_exchange(monkeypatch, op):
    monkeypatch.setenv(tx.MAX_GROUPS_ENV, "10")
    make = {"reduce_by_key": lambda ds: ds.reduce_by_key(operator.add, num_workers=0),
            "group_by_key": lambda ds: ds.group_by_key(num_workers=0),
            "distinct": lambda ds: ds.map(lambda kv: kv[0]).distinct(num_workers=0),
            "sort_by": lambda ds: ds.sort_by(lambda kv: kv[0], num_workers=0)}[op]
    for C in (T, J):
        with pytest.raises(ValueError, match="DLS_DATA_WORKERS") as ei:
            make(pairs(C, n=500)).collect()
        assert str(ei.value).index("DLS_DATA_WORKERS") < str(ei.value).index("hash_bucket")


def test_agg_serial_refusal_names_workers_first():
    msgs = []
    for mod, C in ((tdf, T), (jdf, J)):
        with pytest.raises(ValueError) as ei:
            frame_bytes(frame(mod, C, n=2000, kmod=500).groupBy("k").agg(
                {"v": "sum"}, max_groups=10))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].index("DLS_DATA_WORKERS") < msgs[0].index("hash_bucket")


def test_exchange_has_no_ceiling(_spill_here, monkeypatch):
    monkeypatch.setenv(tx.MAX_GROUPS_ENV, "10")
    out = parts(pairs(T, n=500).reduce_by_key(operator.add, num_workers=2))
    assert sum(len(p) for p in out) == 97


def test_lazy_exchange_runs_once(_spill_here, monkeypatch):
    calls = []
    orig = tx.run_exchange
    monkeypatch.setattr(tx, "run_exchange", lambda *a, **k: calls.append(1) or orig(*a, **k))
    out = pairs(T).reduce_by_key(operator.add, num_workers=2)
    assert calls == []
    parts(out)
    parts(out)
    assert len(calls) == 1


def test_knobs_resolve_as_jax(monkeypatch):
    for mod in (tx, jx):
        assert mod.resolve_shuffle_workers(3) == 3
        assert mod.resolve_shuffle_workers(0) == 0
        assert mod.resolve_transport(None) == "auto"
        assert mod.mem_budget_bytes(16) == 16 << 20
        assert mod.mem_budget_bytes(0.001) == 4 << 20
    monkeypatch.setenv("DLS_DATA_WORKERS", "2")
    monkeypatch.setenv(tx.TRANSPORT_ENV, "device")
    for mod in (tx, jx):
        assert mod.resolve_shuffle_workers(None) == 2
        assert mod.resolve_transport(None) == "auto"
        assert mod.resolve_transport(None, allow_device=True) == "device"
        with pytest.raises(ValueError, match="device"):
            mod.resolve_transport("device")
        with pytest.raises(ValueError, match="unknown"):
            mod.resolve_transport("arrow")
    assert (tx.TRANSPORTS, tx.NUMERIC_COMBINES, tx.MAX_GROUPS_ENV) == (
        jx.TRANSPORTS, jx.NUMERIC_COMBINES, jx.MAX_GROUPS_ENV)


def test_key_bytes_match_jax():
    for key in [7, "a", (2, "b"), 3.5, -0.0, None, (1, (2, 3))]:
        assert tx.key_bytes(key) == jx.key_bytes(key)
    keys = [(i,) for i in range(1000)]
    assert tx.hash_rows(keys).tobytes() == jx.hash_rows(keys).tobytes()


def test_shuffle_events_read_alike_by_both_statuses(_spill_here, tmp_path, monkeypatch):
    """A spilling columnar agg and a tuple one: the port's events carry the
    JAX package's fields, and the port's ``status`` and the JAX package's
    ``dlstatus`` read them into the same shuffle block."""
    wd = tmp_path / "tele"
    monkeypatch.setenv(tx.MEM_MB_ENV, "4")
    ttele.configure(str(wd))
    try:
        frame_bytes(frame(tdf, T, n=60_000, kmod=59_999).groupBy("k").agg(
            AGG_SPEC, num_workers=2))
        frame_bytes(frame(tdf, T).groupBy("k").agg(AGG_SPEC, num_workers=2,
                                                   transport="tuple"))
    finally:
        ttele.reset()
    events = ttele.read_events(str(wd))
    phases = {(e["name"], e.get("edge")) for e in events if e.get("kind") == "phase"}
    assert {("shuffle-map", "begin"), ("shuffle-map", "end"),
            ("shuffle-merge", "begin"), ("shuffle-merge", "end")} <= phases
    done = [e for e in events if e.get("kind") == "shuffle" and e.get("edge") == "done"]
    assert len(done) == 2 and done[0]["spills"] >= 1
    assert [e for e in events if e.get("kind") == "shuffle" and e.get("edge") == "spill"]
    got, want = tstatus.shuffle_from(events), jstatus.shuffle_from(events)
    assert got == want and got["ops"] == 2
    assert got["formats"]["columnar"]["pairs"] > 0 and got["formats"]["tuple"]["pairs"] > 0
    assert got["last"]["transport"] == "tuple"
    text = tstatus.render(tstatus.report(str(wd)))
    assert "shuffle: 2 op(s)" in text and "by format" in text

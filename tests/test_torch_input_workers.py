"""The port's worker pool (``data/workers.py``) against the JAX package's.

- Determinism: the port's ``WorkerMappedDataset`` over a seeded numpy toy
  dataset gives the JAX package's bytes and the plain map's at 0, 1 and 3
  workers; ``imagenet_train(num_workers=2)`` and ``mlm_dataset(num_workers=
  2)`` give the JAX package's batches with the same arguments.
- The byte arena: first-fit allocation, out-of-order free, coalescing.
- Crashes: a worker that raises gives ``WorkerCrashed``; a SIGKILLed one
  respawns with the same bytes and an ``input-worker-respawn`` recovery
  event in the port's telemetry; past the budget a kill is ``WorkerCrashed``.
  A worker alive but silent past the result deadline is killed and counts
  as dead the same way; a child never finalizes the parent's garbage.
- Backpressure: a slow consumer bounds what is in flight; examples the
  ring cannot take overflow to the queue in order, with no deadlock.

Every wait is bounded: the pool's own waits poll, and each test checks its
elapsed time; no worker process and no ``dlsw-<pid>-`` segment outlives a
test.
"""

import gc
import json
import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.data import feed as jfeed
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import text as jtext
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.data import workers as jworkers
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.data import workers as W
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from test_torch_deadline import per_test

#: bound on any one stream's wall time in these tests
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _live() -> dict:
    return dict(
        workers={p for p in mp.active_children() if p.name.startswith("dls-worker")},
        segments={f for f in os.listdir("/dev/shm")
                  if f.startswith(f"dlsw-{os.getpid()}-")})


@pytest.fixture(autouse=True)
def assert_no_leaks():
    """No ``dls-worker`` child and no ``dlsw-<pid>-`` segment started by the
    test outlives it (the JAX package's pools share these names: only
    what is new counts; children get a bounded moment to be reaped)."""
    before = _live()
    yield
    deadline = time.monotonic() + 5.0
    while True:
        left = {k: sorted(getattr(x, "name", x) for x in v - before[k])
                for k, v in _live().items()}
        if not any(left.values()) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not any(left.values()), left


def _toy(dataset_cls, n=60, parts=3):
    rng = np.random.default_rng(7)
    rows = [{"x": rng.normal(0, 1, (16, 16)).astype(np.float32), "label": np.int32(i)}
            for i in range(n)]
    return dataset_cls.parallelize(rows, parts)


def _tf(ex):
    return {"x": np.tanh(ex["x"] * 2.0 + 1.0), "label": ex["label"]}


def _bytes(stream) -> list:
    return [(ex["x"].tobytes(), int(ex["label"])) for ex in stream]


@pytest.mark.parametrize("num_workers", [0, 1, 3])
def test_worker_mapped_dataset_matches_jax_and_the_plain_map(num_workers):
    port = W.WorkerMappedDataset(_toy(TDataset), _tf, num_workers)
    jax_ds = jworkers.WorkerMappedDataset(_toy(JDataset), _tf, num_workers)
    plain = _toy(TDataset).map(_tf)
    assert port.num_partitions == plain.num_partitions == 3
    t0 = time.monotonic()
    got = [_bytes(port.iter_partition(i)) for i in range(3)]
    assert time.monotonic() - t0 < DEADLINE_S
    assert got == [_bytes(jax_ds.iter_partition(i)) for i in range(3)]
    assert got == [_bytes(plain.iter_partition(i)) for i in range(3)]


def test_budget_and_env_resolution_match_jax(monkeypatch):
    for total in range(0, 9):
        for parts in (1, 3, 4):
            assert ([W._split_budget(total, parts, i) for i in range(parts)]
                    == [jworkers._split_budget(total, parts, i) for i in range(parts)])
    monkeypatch.delenv(W.WORKERS_ENV, raising=False)
    assert W.resolve_num_workers(None) == 0 and W.resolve_num_workers(3) == 3
    monkeypatch.setenv(W.WORKERS_ENV, "4")
    assert W.resolve_num_workers(None) == 4 and W.resolve_num_workers(0) == 0
    monkeypatch.setenv(W.WORKERS_ENV, "lots")
    with pytest.warns(UserWarning):
        assert W.resolve_num_workers(None) == 0
    monkeypatch.setenv(W.INPUT_RETRIES_ENV, "")
    assert W.input_worker_retries() == 2 and W.input_worker_retries(5) == 5


def test_imagenet_train_with_workers_matches_jax():
    """224² float images over 2 partitions, repeat=True, 2 workers (one a
    partition): the JAX pipeline's batches with the same arguments, across
    two passes of the data, and the port's own at 0 workers."""
    src = dict(image_size=224, num_classes=1000, num_partitions=2, seed=1)
    kw = dict(size=224, seed=5, repeat=True)
    tds = tvision.imagenet_train(tsources.synthetic_images(8, **src), num_workers=2, **kw)
    jds = jvision.imagenet_train(jsources.synthetic_images(8, **src), num_workers=2, **kw)
    serial = tvision.imagenet_train(tsources.synthetic_images(8, **src), num_workers=0,
                                    **kw)
    assert isinstance(tds, W.WorkerMappedDataset) and not isinstance(
        serial, W.WorkerMappedDataset)
    got, want, ref = (tfeed.host_batches(tds, 4), jfeed.host_batches(jds, 4),
                      tfeed.host_batches(serial, 4))
    for _ in range(5):
        g, w, r = next(got), next(want), next(ref)
        assert g.keys() == w.keys() == r.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
            assert g[k].tobytes() == r[k].tobytes(), k
    for it in (got, want, ref):
        it.close()


@pytest.mark.parametrize("segment_ids", [False, True])
def test_mlm_dataset_with_workers_matches_jax(segment_ids):
    """Tokenize over 2 workers, packing and masking on the consumer: the
    JAX package's examples with the same arguments, byte for byte."""
    def corpus(text_mod):
        docs = text_mod.synthetic_wikipedia(24, num_partitions=2, seed=3)
        return docs, text_mod.WordPieceTokenizer.train(docs.collect(), vocab_size=64)

    kw = dict(seq_len=64, max_predictions=10, segment_ids=segment_ids, num_workers=2)
    tdocs, ttok = corpus(ttext)
    jdocs, jtok = corpus(jtext)
    got = tfeed.host_batches(ttext.mlm_dataset(tdocs, ttok, **kw), 4,
                             drop_remainder=False)
    want = jfeed.host_batches(jtext.mlm_dataset(jdocs, jtok, **kw), 4,
                              drop_remainder=False)
    got, want = list(got), list(want)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


def test_host_batches_knob_and_batches_of_one_are_copies():
    """``host_batches(num_workers=...)`` sets a pooled dataset's count with
    the same bytes; a batch of one is a copy, not a view into a ring."""
    ds = W.WorkerMappedDataset(_toy(TDataset, n=12, parts=1), _tf)
    want = [b["x"].tobytes() for b in tfeed.host_batches(ds, 1, num_workers=0)]
    got = list(tfeed.host_batches(ds, 1, num_workers=2))
    assert [b["x"].tobytes() for b in got] == want
    for b in got:
        assert not isinstance(b["x"], W._ShmArray) and b["x"].flags.owndata


class TestArena:
    def test_alloc_free_coalesce(self):
        a = W._Arena(100)
        assert a.try_alloc(0, 40) == 0
        assert a.try_alloc(1, 40) == 40
        assert a.try_alloc(2, 30) is None  # 20 left
        a.free(0)
        assert a.try_alloc(2, 30) == 0  # first fit reuses the hole
        assert a.used == 70 and a._free == [[30, 40], [80, 100]]

    def test_out_of_order_free_is_reusable(self):
        """The oldest allocation stays live while the ones after it churn
        far past the arena's size: the frees behind it are reused."""
        a = W._Arena(100)
        assert a.try_alloc(0, 20) == 0
        for i in range(1, 51):
            got = a.try_alloc(i, 40)
            assert got is not None and got >= 20
            a.free(i)
        a.free(0)
        assert a.used == 0 and a._free == [[0, 100]]

    def test_free_intervals_coalesce_both_sides(self):
        a = W._Arena(90)
        assert [a.try_alloc(i, 30) for i in range(3)] == [0, 30, 60]
        a.free(0)
        a.free(2)
        assert a._free == [[0, 30], [60, 90]]
        a.free(1)  # joins both neighbours
        assert a._free == [[0, 90]]
        assert a.try_alloc(3, 90) == 0

    def test_oversized_and_empty_are_refused(self):
        a = W._Arena(64)
        assert a.try_alloc(0, 65) is None and a.try_alloc(1, 0) is None


def test_worker_that_raises_gives_worker_crashed():
    def boom(x):
        if x == 11:
            raise ValueError("poisoned example")
        return {"v": np.full(300, x, np.float32)}

    pool = W.WorkerPool(lambda: iter(range(40)), boom, 2)
    t0 = time.monotonic()
    with pytest.raises(W.WorkerCrashed) as e:
        list(pool.stream())
    assert time.monotonic() - t0 < DEADLINE_S
    assert "poisoned example" in str(e.value) and e.value.worker == 11 % 2


def _slow(x):
    time.sleep(0.002)
    return {"v": np.full(300, x, np.float32)}


def test_sigkilled_worker_respawns_byte_identical(tmp_path):
    """The replacement takes over worker 0's residue class past what was
    delivered: the stream is the unfaulted one, and the port's telemetry
    holds one ``input-worker-respawn`` recovery event in the JAX schema."""
    n = 300
    want = [_slow(x)["v"].tobytes() for x in range(n)]
    ttele.configure(tmp_path)
    try:
        pool = W.WorkerPool(lambda: iter(range(n)), _slow, 2, label="drill")
        s = pool.stream()
        got = [next(s)["v"].tobytes()]
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        t0 = time.monotonic()
        got += [ex["v"].tobytes() for ex in s]
        assert time.monotonic() - t0 < DEADLINE_S
    finally:
        ttele.reset()
    assert got == want
    events = [json.loads(line) for line in
              (tmp_path / "telemetry" / "events-p0.jsonl").read_text().splitlines()]
    rec = [e for e in events if e["kind"] == "recovery"]
    assert len(rec) == 1 and "step" not in rec[0]
    assert rec[0]["event"] == "input-worker-respawn" and rec[0]["worker"] == 0
    assert rec[0]["exitcode"] == -signal.SIGKILL and rec[0]["label"] == "drill"
    assert rec[0]["respawns_left"] == 1 and rec[0]["skipped"] >= 1


def test_kill_past_the_budget_gives_worker_crashed(monkeypatch):
    monkeypatch.setenv(W.INPUT_RETRIES_ENV, "0")
    pool = W.WorkerPool(lambda: iter(range(10_000)), _slow, 2)
    s = pool.stream()
    next(s)
    os.kill(pool._procs[0].pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(W.WorkerCrashed) as e:
        for _ in s:
            pass
    assert time.monotonic() - t0 < DEADLINE_S
    assert e.value.exitcode == -signal.SIGKILL and "died" in str(e.value)


def _hangs_once(flag: str):
    """A map whose first call, in whichever worker makes it, never returns
    (the worker stays alive and silent); every later call maps."""
    def fn(x):
        if x == 3 and not os.path.exists(flag):
            open(flag, "w").close()
            threading.Event().wait()
        return _slow(x)
    return fn


def test_silent_worker_is_killed_and_respawned_byte_identical(tmp_path, monkeypatch):
    """A worker that is alive but sends nothing for the result deadline
    counts as dead: it is killed, a replacement takes over its residue
    class, and the stream is the unfaulted one; the recovery event says
    it was silent."""
    n = 40
    want = [_slow(x)["v"].tobytes() for x in range(n)]
    monkeypatch.setattr(W, "_RESULT_TIMEOUT_S", 1.0)
    ttele.configure(tmp_path)
    t0 = time.monotonic()
    try:
        pool = W.WorkerPool(lambda: iter(range(n)), _hangs_once(str(tmp_path / "hung")), 2)
        got = [ex["v"].tobytes() for ex in pool.stream()]
    finally:
        ttele.reset()
    assert time.monotonic() - t0 < DEADLINE_S
    assert got == want
    events = [json.loads(line) for line in
              (tmp_path / "telemetry" / "events-p0.jsonl").read_text().splitlines()]
    rec = [e for e in events if e["kind"] == "recovery"]
    assert len(rec) == 1 and rec[0]["event"] == "input-worker-respawn"
    assert rec[0]["worker"] == 1 and rec[0]["silent"] is True
    assert rec[0]["exitcode"] == -signal.SIGKILL


def test_silent_worker_past_the_budget_gives_worker_crashed(monkeypatch, tmp_path):
    monkeypatch.setenv(W.INPUT_RETRIES_ENV, "0")
    monkeypatch.setattr(W, "_RESULT_TIMEOUT_S", 1.0)
    pool = W.WorkerPool(lambda: iter(range(40)), _hangs_once(str(tmp_path / "hung")), 2)
    t0 = time.monotonic()
    with pytest.raises(W.WorkerCrashed) as e:
        list(pool.stream())
    assert time.monotonic() - t0 < DEADLINE_S
    assert e.value.worker == 1 and "sent nothing for 1 s" in str(e.value)


class _Finalized:
    """Writes the pid of the process that finalizes it into ``path``."""

    def __init__(self, path: str):
        self.path = path
        self.cycle = self

    def __del__(self):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()}\n")


def test_children_never_finalize_the_parents_garbage(tmp_path):
    """A cycle the parent has not collected when the pool forks (its
    finalizer could take a lock of a parent thread, held for good in the
    child) is finalized by the parent alone, though the children collect."""
    path = str(tmp_path / "finalized")
    gc.disable()
    try:
        _Finalized(path)  # unreachable at once, but only gc can free a cycle
        pool = W.WorkerPool(lambda: iter(range(8)),
                            lambda x: {"v": np.full(300, gc.collect() * 0 + x, np.float32)},
                            2)
        got = [int(ex["v"][0]) for ex in pool.stream()]
    finally:
        gc.enable()
    gc.collect()
    assert got == list(range(8))
    assert open(path).read().split() == [str(os.getpid())]


def test_slow_consumer_bounds_what_is_in_flight():
    pool = W.WorkerPool(lambda: iter(range(500)),
                        lambda x: {"v": np.full(300, x, np.float32)}, 1, max_ahead=4)
    s = pool.stream()
    consumed = 0
    for _ in range(6):
        next(s)
        consumed += 1
        time.sleep(0.05)
        g = pool.gauges()["per_worker"][0]
        assert g["items"] <= consumed + 4 + 1, g  # the queue's bound + a handoff
    time.sleep(0.3)  # the worker is parked at the bound, not running on
    g = pool.gauges()["per_worker"][0]
    assert g["items"] <= consumed + 4 + 1 and g["overflow"] == 0, g
    s.close()
    assert W.pool_gauges() == {}  # a closed pool leaves the rollup


def test_ring_overflow_keeps_order_without_deadlock():
    """A consumer that holds every view of 196 KB examples (the ring's
    floor is 1 MB), then examples larger than the whole ring: the worker
    falls back to queue transport where it must, in order, within the
    deadline."""
    held_pool = W.WorkerPool(lambda: iter(range(12)),
                             lambda x: {"v": np.full((128, 128, 3), x, np.float32)},
                             1, ring_bytes=1 << 19, max_ahead=4)
    big_pool = W.WorkerPool(lambda: iter(range(5)),
                            lambda x: {"v": np.full((512, 256, 3), x, np.float32)},
                            1, ring_bytes=1 << 20, max_ahead=2)
    t0 = time.monotonic()
    held = list(held_pool.stream())
    big = list(big_pool.stream())
    assert time.monotonic() - t0 < DEADLINE_S
    assert [int(h["v"][0, 0, 0]) for h in held] == list(range(12))
    assert [int(h["v"][-1, -1, -1]) for h in big] == list(range(5))
    assert big_pool.gauges()["per_worker"][0]["overflow"] == 5

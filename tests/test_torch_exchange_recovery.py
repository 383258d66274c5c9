"""The port's shuffle exchange under task failure, held to the fault-free
run and to the JAX package's exchange on the same numpy-seeded input.

The JAX package's ``tests/test_exchange_recovery.py`` cases: a mapper that
raises once, raises on every attempt, or is SIGKILLed, in both transports
at 1 and 4 workers; a reducer killed after spilling runs; a mapper and a
reducer killed in one run; speculation's first finish winning; a worker
slot blacklisted; the retry budget exhausted; ``DLS_SHUFFLE_MAX_RETRIES=0``
failing fast; ``group_by_key``/``sort_by`` replays; the recovery line of
the port's ``status``; and an interpreter exit mid-recovery. Every
recovered output equals the fault-free run's and the JAX exchange's, and
nothing of an exchange (child, ``/dev/shm`` segment, spill file) is left.
"""

import functools
import operator
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as J
from distributeddeeplearningspark_tpu_torch import status as tstatus
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import exchange as tx
from distributeddeeplearningspark_tpu_torch.data.workers import WorkerCrashed
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as T
from test_torch_deadline import per_test
from test_torch_exchange import assert_no_leaks, parts

ROOT = Path(__file__).resolve().parents[1]
FAULT_VARS = ("DLS_FAULT", "DLS_FAULT_SHUFFLE_ROLE", "DLS_FAULT_SHUFFLE_ID",
              "DLS_FAULT_ALL_ATTEMPTS", tx.MAX_RETRIES_ENV, tx.BLACKLIST_ENV,
              tx.SPECULATE_ENV)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _spill_here(tmp_path, monkeypatch):
    spill_root = tmp_path / "spill"
    spill_root.mkdir()
    monkeypatch.setenv(tx.SPILL_DIR_ENV, str(spill_root))
    for var in ("DLS_DATA_WORKERS", tx.MEM_MB_ENV, tx.TRANSPORT_ENV) + FAULT_VARS:
        monkeypatch.delenv(var, raising=False)
    yield spill_root


def pairs(C, n=20_000, kmod=997, nparts=4, seed=1):
    rng = np.random.default_rng(seed)
    keys = ((np.arange(n) * 2654435761) % kmod).tolist()
    vals = rng.integers(0, 13, n).tolist()
    data = list(zip(keys, vals))
    return C.from_generators([(lambda c=data[i::nparts]: iter(c)) for i in range(nparts)])


def _kw(transport: str) -> dict:
    return dict(combine="sum" if transport == "columnar" else None, transport=transport)


@functools.lru_cache(maxsize=None)
def jax_reference(transport: str, n: int = 20_000, kmod: int = 997) -> str:
    """The JAX exchange's fault-free output (2 workers), as a repr."""
    env = {v: os.environ.pop(v) for v in FAULT_VARS if v in os.environ}
    try:
        return repr(parts(pairs(J, n=n, kmod=kmod).reduce_by_key(
            operator.add, num_workers=2, **_kw(transport))))
    finally:
        os.environ.update(env)


def events_spy(monkeypatch) -> list:
    events: list = []
    orig = ttele.emit
    monkeypatch.setattr(ttele, "emit",
                        lambda kind, **f: (events.append({"kind": kind, **f}), orig(kind, **f))[1])
    return events


def shuffle_edges(events, edge) -> list:
    return [e for e in events if e["kind"] == "shuffle" and e.get("edge") == edge]


def _fault(monkeypatch, at: int, role: str = "mapper", **extra: str) -> None:
    monkeypatch.setenv("DLS_FAULT", f"die_shuffle_worker@{at}")
    monkeypatch.setenv("DLS_FAULT_SHUFFLE_ROLE", role)
    monkeypatch.setenv("DLS_FAULT_SHUFFLE_ID", "0")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def flaky_pairs(C, marker: Path | None):
    """:func:`pairs` whose partition 0 raises at its 100th element: once
    (``marker`` records it, across processes) or, with ``marker`` None, on
    every attempt. The raise is in the mapper's read of its slice, so both
    transports meet it."""
    ds = pairs(C)

    def gen(it):
        for j, kv in enumerate(it):
            if j == 100 and (marker is None or not marker.exists()):
                if marker is not None:
                    marker.write_text("x")
                raise ValueError("poisoned partition")
            yield kv

    return C.from_generators([
        (lambda p=p: gen(p())) if i == 0 else p for i, p in enumerate(ds._parts)])


@pytest.mark.parametrize("nw", [1, 4])
@pytest.mark.parametrize("transport", ["tuple", "columnar"])
@pytest.mark.parametrize("mode", ["raise_once", "raise_always", "sigkill"])
def test_mapper_failure_recovers_or_escalates(_spill_here, tmp_path, monkeypatch,
                                              mode, transport, nw):
    """A mapper that raises once or is SIGKILLed is retried and the output
    is the fault-free run's and the JAX exchange's; one that raises every
    time escalates to a typed ``WorkerCrashed`` carrying its traceback."""
    want = jax_reference(transport)
    clean = parts(pairs(T).reduce_by_key(operator.add, num_workers=nw, **_kw(transport)))
    assert repr(clean) == want
    events = events_spy(monkeypatch)
    if mode == "sigkill":
        _fault(monkeypatch, 2000)
        ds = pairs(T)
    else:
        ds = flaky_pairs(T, tmp_path / "raised-once" if mode == "raise_once" else None)
    out = ds.reduce_by_key(operator.add, num_workers=nw, **_kw(transport))
    if mode == "raise_always":
        t0 = time.monotonic()
        with pytest.raises(WorkerCrashed, match="poisoned partition"):
            parts(out)
        assert time.monotonic() - t0 < 60.0
    else:
        assert repr(parts(out)) == want
        retries = shuffle_edges(events, "retry")
        assert retries and retries[0]["role"] == "mapper"
        if mode == "sigkill":
            assert retries[0]["reason"] == "died"
            assert retries[0]["exitcode"] == -signal.SIGKILL
            done = shuffle_edges(events, "done")[-1]
            assert done["mapper_retries"] >= 1 and done["pairs_in"] == 20_000
        else:
            assert retries[0]["reason"] == "raised"
    del out  # its spill directory goes with it
    assert_no_leaks(_spill_here)


@pytest.mark.parametrize("transport", ["tuple", "columnar"])
def test_reducer_sigkill_with_spills_recovers(_spill_here, monkeypatch, transport):
    """A reducer killed after spilling runs rebuilds its buckets from the
    retained frames: the output is the JAX exchange's."""
    want = jax_reference(transport, n=200_000, kmod=199_999)
    events = events_spy(monkeypatch)
    monkeypatch.setenv(tx.MEM_MB_ENV, "4")
    _fault(monkeypatch, 3, role="reducer")
    got = parts(pairs(T, n=200_000, kmod=199_999).reduce_by_key(
        operator.add, num_workers=2, **_kw(transport)))
    assert repr(got) == want
    assert any(r["role"] == "reducer" and r["reason"] == "died"
               for r in shuffle_edges(events, "retry"))
    assert shuffle_edges(events, "spill")
    assert_no_leaks(_spill_here)


def test_mapper_and_reducer_killed_same_run(_spill_here, monkeypatch):
    want = jax_reference("tuple")
    events = events_spy(monkeypatch)
    _fault(monkeypatch, 6, role="both")
    assert repr(parts(pairs(T).reduce_by_key(operator.add, num_workers=2))) == want
    done = shuffle_edges(events, "done")[-1]
    assert done["mapper_retries"] >= 1 and done["reducer_retries"] >= 1
    assert_no_leaks(_spill_here)


def _straggler(C):
    def chunk(i):
        def gen():
            for j in range(40):
                if i == 0:
                    time.sleep(0.05)  # the straggling partition
                yield ((i * 40 + j) % 13, 1)
        return gen
    return C.from_generators([chunk(i) for i in range(4)])


def test_speculation_first_finish_wins(_spill_here, monkeypatch):
    want = parts(_straggler(J).reduce_by_key(operator.add, num_workers=0))
    events = events_spy(monkeypatch)
    monkeypatch.setattr(tx, "_SPECULATE_FLOOR_S", 0.3)
    monkeypatch.setenv(tx.SPECULATE_ENV, "2.0")
    assert parts(_straggler(T).reduce_by_key(operator.add, num_workers=2)) == want
    spec = shuffle_edges(events, "speculate")
    assert spec and spec[0]["part"] == 0
    done = shuffle_edges(events, "done")[-1]
    assert done["speculations"] >= 1 and done["pairs_in"] == 160
    assert_no_leaks(_spill_here)


def test_blacklist_after_k_strikes_redistributes(_spill_here, monkeypatch):
    want = jax_reference("tuple")
    events = events_spy(monkeypatch)
    _fault(monkeypatch, 500, DLS_FAULT_ALL_ATTEMPTS="1", **{tx.BLACKLIST_ENV: "1"})
    assert repr(parts(pairs(T).reduce_by_key(operator.add, num_workers=2))) == want
    bl = shuffle_edges(events, "blacklist")
    assert len(bl) == 1 and bl[0]["role"] == "mapper" and bl[0]["worker"] == 0
    assert shuffle_edges(events, "done")[-1]["blacklists"] == 1
    assert_no_leaks(_spill_here)


def test_retry_budget_exhaustion_escalates_typed(_spill_here, monkeypatch):
    _fault(monkeypatch, 500, DLS_FAULT_ALL_ATTEMPTS="1",
           **{tx.MAX_RETRIES_ENV: "2", tx.BLACKLIST_ENV: "99"})
    with pytest.raises(WorkerCrashed, match="exhausted") as ei:
        parts(pairs(T).reduce_by_key(operator.add, num_workers=1))
    assert ei.value.exitcode == -signal.SIGKILL
    assert_no_leaks(_spill_here)


@pytest.mark.parametrize("transport", ["tuple", "columnar"])
def test_zero_retries_is_fail_fast(_spill_here, monkeypatch, transport):
    _fault(monkeypatch, 2000, **{tx.MAX_RETRIES_ENV: "0"})
    t0 = time.monotonic()
    with pytest.raises(WorkerCrashed, match="died") as ei:
        parts(pairs(T).reduce_by_key(operator.add, num_workers=2, **_kw(transport)))
    assert time.monotonic() - t0 < 30.0
    assert ei.value.exitcode == -signal.SIGKILL
    assert_no_leaks(_spill_here)


def test_group_and_sort_recover_byte_identical(_spill_here, monkeypatch):
    want_g = parts(pairs(J, n=8000).group_by_key(num_workers=0))
    want_s = pairs(J, n=8000).sort_by(lambda kv: kv[0], num_workers=0).collect()
    _fault(monkeypatch, 1500)
    assert parts(pairs(T, n=8000).group_by_key(num_workers=2)) == want_g
    assert pairs(T, n=8000).sort_by(lambda kv: kv[0], num_workers=2).collect() == want_s
    assert_no_leaks(_spill_here)


def test_malformed_fault_env_raises_before_any_child(_spill_here, monkeypatch):
    """A typo'd drill fails loudly in the driver, before a child spawns."""
    for var, bad in (("DLS_FAULT_SHUFFLE_ROLE", "mappr"), ("DLS_FAULT_SHUFFLE_ID", "x")):
        _fault(monkeypatch, 5)
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var):
            parts(pairs(T, n=100).reduce_by_key(operator.add, num_workers=2))
    assert_no_leaks(_spill_here)


def test_status_renders_recovery_line(_spill_here, tmp_path, monkeypatch):
    wd = tmp_path / "tele"
    _fault(monkeypatch, 6, role="both")
    ttele.configure(str(wd))
    try:
        parts(pairs(T).reduce_by_key(operator.add, num_workers=2))
    finally:
        ttele.reset()
    rep = tstatus.report(str(wd))
    rec = rep["shuffle"]["recovery"]
    assert rec["retries"] >= 2 and rec["mapper_retries"] >= 1 and rec["reducer_retries"] >= 1
    text = tstatus.render(rep)
    assert "recovery:" in text and "self-healed" in text
    assert_no_leaks(_spill_here)


def test_exit_mid_recovery_leaks_nothing(tmp_path):
    """An exchange abandoned while a respawned mapper runs, then the
    interpreter exits: the live finalizer lists reap the respawned child
    too, and no segment is left."""
    script = r"""
import os, sys, threading, time
os.environ["DLS_SHUFFLE_SPILL_DIR"] = sys.argv[1]
os.environ["DLS_FAULT"] = "die_shuffle_worker@30"
os.environ["DLS_FAULT_SHUFFLE_ROLE"] = "mapper"
os.environ["DLS_FAULT_SHUFFLE_ID"] = "0"
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

def chunk(i):
    def gen():
        for j in range(400):
            time.sleep(0.02)
            yield ((i * 400 + j) % 97, 1)
    return gen

out = PartitionedDataset.from_generators([chunk(i) for i in range(4)]).reduce_by_key(
    lambda a, b: a + b, num_workers=2)
threading.Thread(target=lambda: list(out.iter_partition(0)), daemon=True).start()
time.sleep(4.0)
print("pid", os.getpid())
sys.exit(0)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "leaked shared_memory" not in out.stderr, out.stderr[-2000:]
    pid = int(out.stdout.split()[-1])
    if os.path.isdir("/dev/shm"):
        assert not [f for f in os.listdir("/dev/shm") if f.startswith(f"dlsx-{pid}-")]


SHUFFLE_FAULT_ENVS = [
    {},
    {"DLS_FAULT": "crash@3"},
    {"DLS_FAULT": "die_shuffle_worker@7"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_SHUFFLE_ROLE": "reducer"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_SHUFFLE_ROLE": "both",
     "DLS_FAULT_SHUFFLE_ID": "1"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_SHUFFLE_ROLE": "mapper, reducer"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_ALL_ATTEMPTS": "1"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_SHUFFLE_ROLE": "mappr"},
    {"DLS_FAULT": "die_shuffle_worker@7", "DLS_FAULT_SHUFFLE_ID": "x"},
    {"DLS_FAULT": "die_shuffle_worker@0"},
]


@pytest.mark.parametrize("env", SHUFFLE_FAULT_ENVS, ids=lambda e: ",".join(
    f"{k.removeprefix('DLS_FAULT_')}={v}" for k, v in e.items()) or "none")
def test_shuffle_fault_matches_jax(monkeypatch, env):
    """``faults.shuffle_fault`` for each role, slot and attempt: the JAX
    package's answer, or its error for a malformed spec."""
    from distributeddeeplearningspark_tpu import faults as jfaults
    from distributeddeeplearningspark_tpu_torch import faults as tfaults

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for role in ("mapper", "reducer"):
        for wid in (0, 1):
            for attempt in (0, 1):
                try:
                    want = jfaults.shuffle_fault(role, wid, attempt)
                except ValueError as e:
                    with pytest.raises(ValueError) as ei:
                        tfaults.shuffle_fault(role, wid, attempt)
                    assert str(ei.value) == str(e)
                    continue
                assert tfaults.shuffle_fault(role, wid, attempt) == want
    if "die_shuffle_worker@7" in env.values():
        assert tfaults.get() is None  # scoped: only the exchange reads it


class _CancelOnGet:
    """A task queue whose ``get`` hands out its task and, in the same
    moment, cancels the attempt that took it: the blacklisting race."""

    def __init__(self, task, cancel):
        import queue

        self.q = queue.Queue()
        self.q.put(task)
        self.cancel = cancel

    def get(self, timeout=None):
        task = self.q.get(timeout=timeout)
        self.cancel.set()
        return task

    def put(self, item):
        self.q.put(item)


def test_a_cancelled_mapper_hands_its_popped_task_back(tmp_path):
    """A mapper blacklisted between popping a slice and announcing it must
    put the slice back: no runner would ever hold it, and the exchange
    would wait ``_RESEED_S`` (60 s) for its custody net. The JAX package's
    mapper loses it; this held the raise-every-time drill at 4 workers
    past 60 s under load."""
    import queue
    import threading

    cancel, stop, done = threading.Event(), threading.Event(), threading.Event()
    task = (0, 0, 0, 1)
    task_q = _CancelOnGet(task, cancel)
    ctl_q = queue.Queue()
    ds = pairs(T, n=100)
    tx._mapper_loop(0, 0, list(ds._parts), tx._Spec(pre=None, combine=operator.add), 4, 2,
                    None, 1 << 20, [], None, ctl_q, task_q, stop, cancel, done, [0],
                    1 << 20, True, str(tmp_path), None, None)
    assert task_q.q.get_nowait() == task
    assert ctl_q.empty()  # nothing announced: the attempt was cancelled

"""The port's serving fleet layer on the CPU: the paged KV arena and the
prefix cache against the JAX package's on the same operation sequences,
the router (placement, tenant budget, failover, drain), an in-process
rolling reload with zero dropped requests, peer warm-up through
``export_params``, and one two-process ``tinyllama`` fleet end to end
(each replica a ``subprocess.Popen``'d process on the CPU), read back by
the port's and the JAX package's ``dlstatus --fleet-serve``."""

import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import status as jstatus
from distributeddeeplearningspark_tpu.serve import kv as jkv
from distributeddeeplearningspark_tpu_torch import status as tstatus
from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.serve import (
    InferenceEngine,
    LocalReplica,
    NoReplicaError,
    OverloadedError,
    PagedKVArena,
    PrefixCache,
    ReplicaDiedError,
    Router,
    ServingFleet,
)
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _unbind_telemetry():
    yield
    telemetry.reset()


# -- the arena and the prefix cache against JAX's -----------------------------


def _script(seed: int, steps: int = 120):
    """A random sequence of arena/cache operations, valid by construction:
    what is released or retained is held."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 50, (16,)).astype(np.int32)
    ops = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.3:
            ops.append(("alloc", int(rng.integers(0, 5))))
        elif r < 0.45:
            ops.append(("release", int(rng.integers(0, 1 << 30))))
        elif r < 0.5:
            ops.append(("retain", int(rng.integers(0, 1 << 30))))
        elif r < 0.68:
            n = int(rng.integers(4, 24))
            tail = rng.integers(0, 50, (n,)).astype(np.int32)
            prompt = np.concatenate([system[:int(rng.integers(0, 17))], tail])
            ops.append(("register", prompt, int(rng.integers(0, 2))))
        elif r < 0.86:
            n = int(rng.integers(4, 24))
            tail = rng.integers(0, 50, (n,)).astype(np.int32)
            prompt = np.concatenate([system[:int(rng.integers(0, 17))], tail])
            ops.append(("lookup", prompt, int(rng.integers(0, 2))))
        elif r < 0.94:
            ops.append(("evict_until", int(rng.integers(0, 12))))
        else:
            ops.append(("flush",))
    return ops


def _run_script(kv, ops, num_pages=24, page=4, max_entries=6):
    """Run ``ops`` on ``kv``'s classes; every return value and stats."""
    arena = kv.PagedKVArena(num_pages, page)
    cache = kv.PrefixCache(arena, max_entries=max_entries)
    held: list[list[int]] = []
    trail = []
    for op in ops:
        name = op[0]
        if name == "alloc":
            got = arena.alloc(op[1])
            if got:
                held.append(got)
            out = got
        elif name in ("release", "retain"):
            if not held:
                out = None
            else:
                pages = held[op[1] % len(held)]
                if name == "release":
                    held.remove(pages)
                    out = arena.release(pages)
                else:
                    arena.retain(pages)
                    held.append(list(pages))
                    out = "ok"
        elif name == "register":
            pages = arena.alloc(len(op[1]) // page)
            if pages is None:
                out = None
            else:
                out = cache.register(op[1], pages, version=op[2])
                arena.release(pages)          # the cache holds its refs
        elif name == "lookup":
            n, pages = cache.lookup(op[1], version=op[2])
            cache.record(n * page)
            if pages:
                held.append(pages)
            out = (n, pages)
        elif name == "evict_until":
            out = cache.evict_until(op[1])
        else:
            out = cache.flush()
        trail.append((name, out, arena.stats(), cache.stats(), len(cache)))
    return trail


@pytest.mark.parametrize("seed", range(6))
def test_arena_and_prefix_cache_equal_jax_on_random_sequences(seed):
    from distributeddeeplearningspark_tpu_torch.serve import kv as tkv

    ops = _script(seed)
    assert _run_script(tkv, ops) == _run_script(jkv, ops)


@pytest.mark.parametrize("case", ["first_fit", "refcounts", "exhaustion",
                                  "divergence", "version", "lru"])
def test_arena_and_prefix_cache_cases_equal_jax(case):
    """JAX's own scripted cases (``tests/test_serve_fleet.py``), run on both
    packages' classes with the same results."""
    from distributeddeeplearningspark_tpu_torch.serve import kv as tkv

    def run(kv):
        rec = []
        a = kv.PagedKVArena(num_pages=16, page_size=4)
        c = kv.PrefixCache(a)
        rng = np.random.default_rng(1)
        p1 = rng.integers(0, 100, (12,)).astype(np.int32)
        if case == "first_fit":
            rec += [a.alloc(3), a.alloc(2), a.release([2]), a.alloc(2), a.pages_used]
        elif case == "refcounts":
            pages = a.alloc(2)
            a.retain(pages)
            rec += [a.release(pages), a.pages_used, a.release(pages), a.pages_used]
        elif case == "exhaustion":
            rec += [a.alloc(15), a.alloc(1), a.alloc_failures, a.stats()]
        elif case == "divergence":
            pages = a.alloc(3)
            rec.append(c.register(p1, pages, version=0))
            p2 = np.concatenate([p1[:8], rng.integers(0, 100, (6,)).astype(np.int32)])
            n, shared = c.lookup(p2, version=0)
            c.record(n * 4)
            rec += [n, shared, c.hits, c.tokens_saved, c.lookup(p1, version=0)[0]]
        elif case == "version":
            c.register(p1, a.alloc(2), version=0)
            rec.append(c.lookup(np.concatenate([p1, p1]), version=1))
        else:
            q1, q2 = p1[:8], rng.integers(0, 100, (8,)).astype(np.int32)
            g1, g2 = a.alloc(2), a.alloc(2)
            c.register(q1, g1, version=0)
            c.register(q2, g2, version=0)
            a.release(g1)
            a.release(g2)
            n, got = c.lookup(np.concatenate([q2, q2]), version=0)
            rec += [n, a.pages_used, c.evict_until(a.pages_free + 2), a.pages_used]
            a.release(got)
            rec += [c.flush(), a.pages_used]
        return rec

    assert run(tkv) == run(jkv)
    with pytest.raises(ValueError):
        PagedKVArena(num_pages=1, page_size=4)
    with pytest.raises(ValueError):
        PagedKVArena(num_pages=4, page_size=4).release([1])


# -- the router ---------------------------------------------------------------


class _FakeReplica:
    """Handle double with a controllable future queue."""

    def __init__(self, name):
        self.name = name
        self.alive = True
        self.submitted = []

    def submit(self, payload, op="infer"):
        fut = Future()
        self.submitted.append((payload, op, fut))
        return fut


def test_router_places_by_queue_depth_and_p99():
    """Dispatch minimises (outstanding + 1) × p99: a slow replica gets less."""
    fast, slow = _FakeReplica("fast"), _FakeReplica("slow")
    r = Router([fast, slow], p99_window=8)
    r._lat["fast"].extend([0.001] * 8)
    r._lat["slow"].extend([0.100] * 8)
    for _ in range(10):
        r.submit({"x": 1})
    assert len(fast.submitted) > len(slow.submitted)
    st = r.stats()
    assert st["dispatched"] == 10
    assert st["replicas"]["fast"]["recent_p99_ms"] == 1.0


def test_router_tenant_budget_sheds_typed_with_telemetry(tmp_path):
    rep = _FakeReplica("r0")
    r = Router([rep], default_tenant_budget=2, workdir=str(tmp_path))
    r.submit({"x": 1}, tenant="greedy")
    r.submit({"x": 2}, tenant="greedy")
    with pytest.raises(OverloadedError):
        r.submit({"x": 3}, tenant="greedy")
    r.submit({"x": 4}, tenant="polite")
    assert r.stats()["shed_tenant"] == 1
    for _, _, fut in rep.submitted:
        fut.set_result({"ok": True})
    r._tele.close()
    evs = telemetry.read_events(tmp_path)
    sheds = [e for e in evs if e.get("kind") == "request"]
    assert len(sheds) == 1 and sheds[0]["tenant"] == "greedy"
    assert sheds[0]["process"] == "router" and sheds[0]["outcome"] == "shed"
    # the root spans of the three dispatched requests, each with its place
    spans = [e for e in evs if e.get("kind") == "span"]
    assert sum(s["name"] == "request" for s in spans) == 3
    assert sum(s["name"] == "place" for s in spans) == 3
    r.submit({"x": 5}, tenant="greedy")      # the budget came back


def test_router_fails_over_on_replica_death():
    a, b = _FakeReplica("a"), _FakeReplica("b")
    r = Router([a, b])
    futs = [r.submit({"x": i}) for i in range(4)]
    victim, survivor = (a, b) if a.submitted else (b, a)
    victim.alive = False
    for _, _, fut in list(victim.submitted):
        fut.set_exception(ReplicaDiedError("gone"))
    for _, _, fut in list(survivor.submitted):
        if not fut.done():
            fut.set_result({"y": 0})
    assert [f.result(10) for f in futs] == [{"y": 0}] * 4
    assert r.stats()["failovers"] >= 1
    assert len(survivor.submitted) == 4


def test_router_drain_guard_and_no_replica_error():
    a, b = _FakeReplica("a"), _FakeReplica("b")
    r = Router([a, b])
    r.drain("a")
    with pytest.raises(RuntimeError, match="zero serving"):
        r.drain("b")
    r.undrain("a")
    a.alive = b.alive = False
    with pytest.raises(NoReplicaError):
        r.submit({"x": 1})


# -- rolling reload and peer warm-up (in process) ------------------------------


def _fwd(params, batch):
    return {"y": batch["x"] * params["w"]}


def _engine(w, name):
    return InferenceEngine(_fwd, {"w": torch.tensor(w)}, device="cpu", max_batch=4,
                           max_wait_ms=1.0, max_queue=4096, name=name)


def test_rolling_reload_zero_dropped_in_process():
    engines = [_engine(1.0, f"e{i}").start() for i in range(2)]
    reps = [LocalReplica(f"r{i}", e, reload_fn=lambda n: {"w": torch.tensor(100.0 + n)})
            for i, e in enumerate(engines)]
    router = Router(reps)
    stop = threading.Event()
    futs, lock = [], threading.Lock()

    def client():
        while not stop.is_set():
            try:
                f = router.submit({"example": {"x": np.float32(1.0)}})
            except OverloadedError:
                continue
            with lock:
                futs.append(f)
            time.sleep(0.001)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 10
        while router.stats()["dispatched"] < 8 and time.monotonic() < deadline:
            time.sleep(0.002)
        for rep in reps:
            router.drain(rep.name)
            while router.inflight(rep.name) > 0:
                time.sleep(0.001)
            rep.call("reload")
            router.undrain(rep.name)
    finally:
        stop.set()
        for t in threads:
            t.join()
    res = [float(f.result(30)["y"]) for f in futs]
    assert len(res) == len(futs)                      # zero dropped
    assert set(res) <= {1.0, 101.0}                   # old or new, never torn
    assert 101.0 in res
    for e in engines:
        assert e.params_version == 1
        e.stop()


def test_peer_warmup_by_export_params():
    """A relaunched replica takes its weights from a serving peer: export
    (numpy + digest), import (re-hash, check, swap), then serves the
    donor's params at the donor's version; a torn transfer is refused."""
    donor_e, target_e = _engine(7.0, "donor").start(), _engine(1.0, "target").start()
    try:
        donor_e.swap_params({"w": torch.tensor(7.0)}, version=3)
        donor, target = LocalReplica("donor", donor_e), LocalReplica("target", target_e)
        exported = donor.call("export_params")
        assert exported["version"] == 3 and exported["digest"]
        assert isinstance(exported["params"]["w"], np.ndarray)
        rec = target.call("import_params", params=exported["params"],
                          version=exported["version"], digest=exported["digest"])
        assert rec["digest"] == exported["digest"] and rec["params_version"] == 3
        out = target.call("infer", example={"x": np.float32(2.0)}, timeout=60.0)
        assert float(out["y"]) == 14.0
        assert target_e._params["w"].dtype == torch.float32
        with pytest.raises(ValueError, match="digest mismatch"):
            target.call("import_params", params={"w": np.float32(9.0)}, digest="0" * 32)
        assert target_e.params_version == 3
    finally:
        donor_e.stop()
        target_e.stop()


# -- the fleet: replica processes ----------------------------------------------


def _children() -> set[int]:
    """This process's live child pids."""
    me = os.getpid()
    out = set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(pid))
    return out


def test_tinyllama_fleet_end_to_end(tmp_path, monkeypatch):
    """Two ``tinyllama`` replica processes on the CPU behind the router:
    generate through it, a rolling reload with zero dropped requests, a
    killed replica routed around and restarted warm from its peer, no
    process left after, and both ``dlstatus --fleet-serve`` read the run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = _children()
    rng = np.random.default_rng(0)
    system = rng.integers(1, 256, (32,)).astype(np.int32)

    def payload(i):
        return {"prompt": np.concatenate([system, rng.integers(1, 256, (8,)).astype(
            np.int32)]), "max_new_tokens": 4}

    spec = {"model": "tinyllama", "seed": 0, "device": "cpu", "slots": 2,
            "max_cache_len": 64, "page_size": 16, "gauge_interval_s": 0.2}
    with ServingFleet(spec, replicas=2, workdir=str(tmp_path),
                      startup_timeout_s=180.0) as fleet:
        assert {h.call("ping")["device"] for h in fleet.handles} == {"cpu"}
        router = fleet.router()
        futs = [router.submit(payload(i), op="generate") for i in range(8)]
        assert all(f.result(120).shape == (4,) for f in futs)
        futs = [router.submit(payload(i), op="generate") for i in range(8)]
        recs = fleet.rolling_reload(router)
        assert [r["replica"] for r in recs] == ["r0", "r1"]
        assert all(r["params_version"] == 1 for r in recs)
        for f in futs:
            assert f.result(120).shape == (4,)   # zero dropped across it
        fleet.handles[0].proc.kill()
        fleet.handles[0].proc.wait()
        deadline = time.monotonic() + 10
        while fleet.handles[0].alive and time.monotonic() < deadline:
            time.sleep(0.05)
        futs = [router.submit(payload(i), op="generate") for i in range(4)]
        for f in futs:
            f.result(120)                        # the survivor absorbed them
        assert fleet.restart_dead(router) == ["r0"]
        assert fleet.handles[0].call("stats")["params_version"] == 1
        router.submit(payload(0), op="generate").result(120)
    assert _children() <= before, "a replica process outlived the fleet"
    for status in (tstatus, jstatus):
        fs = status.report(str(tmp_path), fleet_serve=True)["fleet_serve"]
        assert {"p0", "p1"} <= {r["process"] for r in fs["replicas"]}
        assert fs["totals"]["ok"] >= 21 and fs["totals"]["prefix_hits"] >= 1
    events = telemetry.read_events(tmp_path)
    kinds = {e.get("event") for e in events if e.get("kind") == "recovery"}
    assert {"rolling-reload", "replica-restart", "replica-warmup"} <= kinds

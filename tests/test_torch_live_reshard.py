"""The port's live-reshard engine (``parallel/live_reshard.py``) held to
the contract of the JAX package's ``tests/test_live_reshard.py``.

- The schedule: ``chunk_rows`` returns the JAX function's row ranges on
  the same shapes, itemsizes and budgets (compared directly);
  ``DLS_RESHARD_MEM_MB`` is honoured and a budget ≤ 0 raises.
- A gloo gang at ``local[4]`` (this file is its script) moves ``DTensor``
  leaves — FSDP2's uneven ``Shard(0)`` (3, 3, 3, 1 rows and 3, 3, 3, 0),
  a ``Shard(1)`` leaf, a 2-D ``fsdp × tensor`` layout and an HSDP one —
  to replicated and back: each replicated leaf is the whole tensor and the
  way back is the source bitwise; the rounds bound the bytes in flight (a
  row wider than the budget moves whole and the peak says so); a leaf on
  its target passes through untouched; a None target leaves a leaf alone;
  a corrupted copy, or one broadcast corrupted in flight (in a move and in
  the handoff's save), raises ``ReshardVerifyError`` on every rank and a
  torn save leaves nothing behind; a sharded state's handoff saved by the
  gang, under the budget, loads bitwise into a whole state.
- The handoff on one process: the round trip (bf16, ints, the generator's
  state) is bitwise; a corrupt, missing or extra leaf and a wrong shape
  raise ``HandoffError``. ``tree_digest`` tells order and content apart;
  ``emit_reshard_event`` writes JAX's field names for the same stats.
"""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch

from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.parallel import live_reshard as jlive
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.parallel import live_reshard as live
from distributeddeeplearningspark_tpu_torch.parallel import reshard
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

#: the gang's budget: 96 bytes, so every leaf moves in several rounds
GANG_MEM_MB = 96 / 2**20


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- the schedule ---------------------------------------------------------------


@pytest.mark.parametrize("shape,itemsize,budget", [
    ((), 4, 1024), ((0, 8), 4, 1024), ((10, 100), 4, 1200), ((4, 1000), 4, 100),
    ((32000, 4096), 2, 256 * 2**20), ((4096, 11008), 2, 256 * 2**20),
    ((7,), 8, 16), ((5, 3, 2), 2, 13), ((1,), 4, 1)])
def test_chunk_rows_are_jax(shape, itemsize, budget):
    assert live.chunk_rows(shape, itemsize, budget) == jlive.chunk_rows(
        shape, itemsize, budget)


def test_memory_budget_env_var(monkeypatch):
    monkeypatch.setenv(live.RESHARD_MEM_ENV, "3")
    assert live.memory_budget_bytes() == 3 * 1024 * 1024
    _, stats = live.redistribute({}, {})
    assert stats.mem_budget_bytes == 3 * 1024 * 1024
    assert live.memory_budget_bytes(1.0) == 1024 * 1024  # the argument wins
    monkeypatch.delenv(live.RESHARD_MEM_ENV)
    assert live.memory_budget_bytes() == int(live.DEFAULT_MEM_MB * 1024 * 1024)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            live.memory_budget_bytes(bad)
    monkeypatch.setenv(live.RESHARD_MEM_ENV, "0")
    with pytest.raises(ValueError, match=live.RESHARD_MEM_ENV):
        live.redistribute({}, {})


def test_spans_follow_torch_chunk():
    """Each rank's rows of an uneven dim are ``torch.chunk``'s pieces, the
    split ``DTensor`` and FSDP2 use."""
    from torch.distributed.tensor import Replicate, Shard

    for n, k in ((10, 4), (9, 4), (4096, 3), (3, 4), (0, 2)):
        pieces = torch.arange(n).chunk(k) if n else ()
        got = [reshard.chunk_range(n, k, i) for i in range(k)]
        want = [(int(p[0]), int(p[-1]) + 1) for p in pieces]
        assert [g for g in got if g[1] > g[0]] == want
    span = reshard.shard_span((10, 7), (Shard(0), Shard(1)), (2, 4), (1, 3))
    assert span == [(5, 10), (6, 7)]
    assert reshard.shard_span((10, 7), (Replicate(),), (4,), (2,)) == [(0, 10), (0, 7)]


# -- the handoff on one process -------------------------------------------------------


def _state(seed: int = 0) -> TrainState:
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.nn.Parameter(torch.randn(6, 5, generator=g)),
              "b": torch.nn.Parameter(torch.randn(5, generator=g).to(torch.bfloat16))}
    opt = [3, torch.randn(6, 5, generator=g), torch.randn(5, generator=g)]
    return TrainState(step=7, params=params, opt_state=opt,
                      generator=torch.Generator().manual_seed(seed + 1),
                      mutable={"mean": torch.randn(5, generator=g)})


def _zeros_like(state: TrainState) -> TrainState:
    z = _state(seed=99)
    with torch.no_grad():
        for t in [*z.params.values(), *z.mutable.values(), *z.opt_state[1:]]:
            t.zero_()
    z.step, z.opt_state[0] = 0, 0
    return z


def _bitwise(a: TrainState, b: TrainState) -> bool:
    fa, fb = live.flatten(a.state_dict()), live.flatten(b.state_dict())
    if list(fa) != list(fb):
        return False
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.view(torch.uint8) if x.dim() else x, y.view(torch.uint8) if y.dim() else y):
                return False
        elif x != y:
            return False
    return True


def test_handoff_round_trip_bitwise(tmp_path):
    src = _state()
    assert not live.has_handoff(tmp_path)
    leaves = live.flatten(src.state_dict())
    live.save_handoff(tmp_path, 7, leaves, data_state={"examples_seen": 112,
                                                      "batch_size": 16})
    assert live.has_handoff(tmp_path)
    peek = live.peek_handoff(tmp_path)
    assert set(peek) == {"format", "step", "data_state", "geometry", "leaves", "stats"}
    assert peek["step"] == 7 and peek["data_state"]["examples_seen"] == 112
    assert {r["dtype"] for r in peek["leaves"]} >= {"float32", "bfloat16", "int", "uint8"}
    dst = _zeros_like(src)
    loaded, manifest = live.load_handoff(tmp_path, dst)
    assert loaded is dst and manifest["step"] == 7 and _bitwise(src, dst)
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    live.clear_handoff(tmp_path)
    assert not live.has_handoff(tmp_path)
    live.clear_handoff(tmp_path)  # idempotent


def _rewrite_manifest(tmp_path, edit) -> None:
    path = Path(live.handoff_dir(tmp_path)) / live.HANDOFF_MANIFEST
    manifest = json.loads(path.read_text())
    edit(manifest)
    path.write_text(json.dumps(manifest))


@pytest.mark.parametrize("how", ["corrupt", "truncated", "missing", "extra", "shape",
                                 "dtype", "format"])
def test_handoff_refuses_what_it_cannot_ingest(tmp_path, how):
    src = _state()
    live.save_handoff(tmp_path, 3, live.flatten(src.state_dict()))
    d = Path(live.handoff_dir(tmp_path))
    rec = live.peek_handoff(tmp_path)["leaves"][0]
    if how == "corrupt":
        raw = bytearray((d / rec["file"]).read_bytes())
        raw[0] ^= 1
        (d / rec["file"]).write_bytes(bytes(raw))
    elif how == "truncated":
        (d / rec["file"]).write_bytes((d / rec["file"]).read_bytes()[:-4])
    elif how == "missing":
        _rewrite_manifest(tmp_path, lambda m: m["leaves"].pop())
    elif how == "extra":
        _rewrite_manifest(tmp_path, lambda m: m["leaves"].append(
            {**m["leaves"][0], "path": "params/ghost"}))
    elif how == "shape":
        _rewrite_manifest(tmp_path, lambda m: m["leaves"][0].update(shape=[5, 6]))
    elif how == "dtype":
        _rewrite_manifest(tmp_path, lambda m: m["leaves"][0].update(dtype="float64"))
    else:
        _rewrite_manifest(tmp_path, lambda m: m.update(format=2))
    dst = _zeros_like(src)
    with pytest.raises(live.HandoffError, match="checkpoint"):
        live.load_handoff(tmp_path, dst)
    assert _bitwise(dst, _zeros_like(src))  # nothing was written into it


def test_tree_digest_orders_and_discriminates():
    a = {"w": torch.ones(4, 4), "b": torch.zeros(3)}
    b = {"w": torch.ones(4, 4), "b": torch.zeros(3)}
    assert live.tree_digest(a) == live.tree_digest(b)
    b["w"] = b["w"] + 1
    assert live.tree_digest(a) != live.tree_digest(b)
    swapped = {"b": torch.zeros(3), "w": torch.ones(4, 4)}
    assert live.tree_digest(a) != live.tree_digest(swapped)
    assert live.tree_digest([torch.zeros(2), torch.ones(2)]) != live.tree_digest(
        [torch.ones(2), torch.zeros(2)])


def test_emit_reshard_event_fields_are_jax(tmp_path):
    """The same stats through both packages' ``emit_reshard_event``: the
    same record, field for field."""
    fields = dict(leaves=9, leaves_moved=4, bytes_total=4096, bytes_moved=1024,
                  rounds=3, peak_inflight_bytes=512, mem_budget_bytes=768,
                  wall_s=0.0123456, verified=True)
    assert set(fields) == set(jlive.TransferStats().to_record())
    assert live.TransferStats(**fields).to_record() == jlive.TransferStats(**fields).to_record()
    records = {}
    for name, mod, tele in (("jax", jlive, jtele), ("port", live, ttele)):
        tele.configure(tmp_path / name)
        try:
            mod.emit_reshard_event(mod.TransferStats(**fields), step=12,
                                   reason="preemption-drain", dead_host=1)
            tele.get().close()
        finally:
            tele.reset()
        (rec,) = [e for e in tele.read_events(tmp_path / name)
                  if e["kind"] == "recovery" and e["event"] == "reshard"]
        records[name] = {k: v for k, v in rec.items() if k not in ("ts", "process")}
    assert records["port"] == records["jax"]


# -- the gang ----------------------------------------------------------------------


def _fsdp_module(mesh):
    """Three params under FSDP2 over 4 ranks: 10 rows (3, 3, 3, 1 a rank),
    9 rows (rank 3 holds none) and one split on dim 1 (FSDP2 splits a dim
    other than 0 evenly only)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    g = torch.Generator().manual_seed(0)
    m = torch.nn.Module()
    m.a = torch.nn.Parameter(torch.randn(10, 6, generator=g))
    m.b = torch.nn.Parameter(torch.randn(9, 5, generator=g).to(torch.bfloat16))
    m.c = torch.nn.Parameter(torch.randn(4, 8, generator=g))
    dims = {id(m.a): 0, id(m.b): 0, id(m.c): 1}
    fully_shard(m, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]))
    return m


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _round_trip(leaves: dict, wholes: dict, mem_mb: float) -> dict:
    """Sharded → replicated → sharded; what each way gave, bitwise."""
    moved, s1 = live.redistribute(leaves, {k: live.replicated_on(v) for k, v in leaves.items()},
                                  mem_mb=mem_mb)
    back, s2 = live.redistribute(moved, {k: tuple(v.placements) for k, v in leaves.items()},
                                 mem_mb=mem_mb)
    return {
        "replicated_whole": all(_bytes(moved[k].to_local()) == _bytes(wholes[k])
                                for k in leaves),
        "replicated_placements": all(all(p.is_replicate() for p in moved[k].placements)
                                     for k in leaves),
        "back_bitwise": all(_bytes(back[k].to_local()) == _bytes(leaves[k].to_local())
                            and back[k].placements == leaves[k].placements
                            for k in leaves),
        "local_rows": {k: list(leaves[k].to_local().shape) for k in leaves},
        "stats": [s1.to_record(), s2.to_record()],
    }


@contextlib.contextmanager
def _corrupt_first_broadcast_into(receiver: int):
    """The first broadcast that rank ``receiver`` takes from another rank
    arrives with one byte flipped (the senders' bytes are intact)."""
    import torch.distributed as dist

    real, hits = live.dist.broadcast, []

    def broadcast(tensor, src, group=None, **kw):
        work = real(tensor, src=src, group=group, **kw)
        if dist.get_rank() == receiver != src and not hits and tensor.numel():
            hits.append(src)
            tensor.view(-1).view(torch.uint8)[0] ^= 1
        return work

    live.dist.broadcast = broadcast
    try:
        yield hits
    finally:
        live.dist.broadcast = real


def _worker(outdir: Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from distributeddeeplearningspark_tpu_torch import Session

    spark = Session.builder.appName("live").config("mesh.data", 1).config(
        "mesh.fsdp", -1).getOrCreate()
    rank = spark.rank
    assert spark.world_size == 4 and spark.backend == "gloo"
    out: dict = {}
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("fsdp",))
    m = _fsdp_module(mesh)
    leaves = {n: p.detach() for n, p in m.named_parameters()}
    wholes = {n: t.full_tensor() for n, t in leaves.items()}
    out["fsdp"] = _round_trip(leaves, wholes, GANG_MEM_MB)

    g = torch.Generator().manual_seed(1)
    whole = torch.randn(10, 6, generator=g)
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("fsdp", "tensor"))
    two_d = {"st": distribute_tensor(whole, mesh2, [Shard(0), Shard(1)]),
             "hsdp": distribute_tensor(whole, mesh2, [Replicate(), Shard(0)])}
    out["two_d"] = _round_trip(two_d, {k: whole for k in two_d}, GANG_MEM_MB)

    # a row wider than the budget moves whole, and the peak says so
    _, wide = live.redistribute({"a": leaves["a"]}, {"a": (Replicate(),)}, mem_mb=8 / 2**20)
    out["wide"] = wide.to_record()

    # on its target: untouched; None (and a non-tensor): left alone
    same, s = live.redistribute({"a": leaves["a"], "count": 5, "c": leaves["c"]},
                                {"a": tuple(leaves["a"].placements), "count": None})
    out["noop"] = dict(same=same["a"] is leaves["a"] and same["c"] is leaves["c"],
                       count=same["count"], stats=s.to_record())

    # a corrupted copy into the target is caught on every rank
    real = live._write_block

    def corrupt(dst, dst_span, block, block_span):
        real(dst, dst_span, block, block_span)
        if dst.numel():
            dst.view(-1)[0] += 1

    live._write_block = corrupt
    try:
        live.redistribute(leaves, {k: live.replicated_on(v) for k, v in leaves.items()})
        out["corrupt"] = None
    except live.ReshardVerifyError as e:
        out["corrupt"] = str(e)
    finally:
        live._write_block = real

    state = TrainState(step=5, params={n: p for n, p in m.named_parameters()},
                       opt_state=[2, leaves["a"] * 2], generator=torch.Generator().manual_seed(3))
    # one broadcast corrupted in flight: the move, and the handoff's save,
    # check what arrived against each sender's own digests on every rank
    out["corrupt_broadcast"] = {}
    for name, move in (
            ("redistribute", lambda: live.redistribute(
                leaves, {k: live.replicated_on(v) for k, v in leaves.items()})),
            ("save_handoff", lambda: live.save_handoff(
                outdir / "torn", 5, live.flatten(state.state_dict())))):
        with _corrupt_first_broadcast_into(0):
            try:
                move()
                out["corrupt_broadcast"][name] = None
            except live.ReshardVerifyError as e:
                out["corrupt_broadcast"][name] = str(e)
    torch.distributed.barrier()  # rank 0 has cleaned up
    torn = outdir / "torn"
    out["torn_left"] = sorted(p.name for p in torn.iterdir()) if torn.exists() else []

    # the sharded state's handoff, saved by the gang, loads whole at one rank
    out["handoff"] = live.save_handoff(
        outdir, 5, live.flatten(state.state_dict()), mem_mb=GANG_MEM_MB,
        data_state={"examples_seen": 40, "batch_size": 8}).to_record()
    opt_whole = state.opt_state[1].full_tensor()  # a collective: every rank
    if rank == 0:
        torch.save({"whole": wholes, "opt": opt_whole}, outdir / "wholes.pt")
    (outdir / f"rank{rank}.json").write_text(json.dumps(out))
    spark.stop()


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("gang_live")
    res = run_gang(["--master", "local[4]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return outdir, [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("layout", ["fsdp", "two_d"])
def test_sharded_to_replicated_to_sharded_is_bitwise(gang, layout):
    _, ranks = gang
    for r, rec in enumerate(ranks):
        got = rec[layout]
        assert got["replicated_whole"] and got["replicated_placements"], r
        assert got["back_bitwise"], r
    if layout == "fsdp":  # the uneven shards FSDP2 made
        assert [rec["fsdp"]["local_rows"]["b"][0] for rec in ranks] == [3, 3, 3, 0]
        assert [rec["fsdp"]["local_rows"]["a"][0] for rec in ranks] == [3, 3, 3, 1]
        assert [rec["fsdp"]["local_rows"]["c"][1] for rec in ranks] == [2, 2, 2, 2]


@pytest.mark.parametrize("layout", ["fsdp", "two_d"])
def test_rounds_bound_the_bytes_in_flight(gang, layout):
    _, ranks = gang
    for rec in ranks:
        for s in rec[layout]["stats"]:
            assert s["rounds"] > 1 and s["leaves_moved"] == len(rec[layout]["local_rows"])
            assert 0 < s["peak_inflight_bytes"] <= s["mem_budget_bytes"] == 96
            assert s["bytes_moved"] == s["bytes_total"] and s["verified"]


def test_a_row_wider_than_the_budget_moves_whole(gang):
    _, ranks = gang
    for rec in ranks:
        s = rec["wide"]
        assert s["mem_budget_bytes"] == 8 and s["rounds"] == 10  # a row a round
        assert s["peak_inflight_bytes"] == 6 * 4 > s["mem_budget_bytes"]


def test_a_leaf_on_its_target_passes_and_none_leaves_it_alone(gang):
    _, ranks = gang
    for rec in ranks:
        noop = rec["noop"]
        assert noop["same"] and noop["count"] == 5
        s = noop["stats"]
        assert s["leaves"] == 3 and s["leaves_moved"] == 0 and s["bytes_moved"] == 0
        assert s["bytes_total"] == 10 * 6 * 4  # accounted, not moved
        assert s["rounds"] == 0


def test_a_corrupted_move_raises_on_every_rank(gang):
    _, ranks = gang
    for rec in ranks:
        assert rec["corrupt"] and "blake2b mismatch" in rec["corrupt"]
        assert "last verified checkpoint" in rec["corrupt"]


@pytest.mark.parametrize("move", ["redistribute", "save_handoff"])
def test_a_corrupted_broadcast_raises_on_every_rank(gang, move):
    """The check covers the transfer: rank 0 receives one byte flipped, and
    every rank raises; a torn save leaves no handoff and no temp dir."""
    _, ranks = gang
    for rec in ranks:
        err = rec["corrupt_broadcast"][move]
        assert err and "blake2b mismatch" in err and "rank 0:" in err, err
        assert "last verified checkpoint" in err
        assert rec["torn_left"] == []


def test_the_handoffs_save_bounds_the_bytes_in_flight(gang):
    """The save pulls the four sharded leaves straight from their shards,
    one chunk under the budget at a time."""
    _, ranks = gang
    for rec in ranks:
        s = rec["handoff"]
        assert s["leaves_moved"] == 4 and s["rounds"] > 4 and s["verified"]
        assert 0 < s["peak_inflight_bytes"] <= s["mem_budget_bytes"] == 96
        assert s["bytes_moved"] == (10 * 6 * 4 * 2 + 9 * 5 * 2 + 4 * 8 * 4)


def test_the_gangs_handoff_loads_whole_at_one_rank(gang):
    outdir, _ = gang
    wholes = torch.load(outdir / "wholes.pt", weights_only=True)
    manifest = live.peek_handoff(outdir)
    assert manifest["geometry"]["mesh"] == {"fsdp": 4}
    assert manifest["geometry"]["num_processes"] == 4
    assert manifest["geometry"]["specs"]["params/c"] == [None, "fsdp"]
    g = torch.Generator().manual_seed(0)
    dst = TrainState(step=0, params={"a": torch.nn.Parameter(torch.zeros(10, 6)),
                                     "b": torch.nn.Parameter(torch.zeros(9, 5, dtype=torch.bfloat16)),
                                     "c": torch.nn.Parameter(torch.zeros(4, 8))},
                     opt_state=[0, torch.zeros(10, 6)], generator=g)
    live.load_handoff(outdir, dst)
    assert dst.step == 5 and dst.opt_state[0] == 2
    for k, want in wholes["whole"].items():
        assert _bytes(dst.params[k]) == _bytes(want), k
    assert _bytes(dst.opt_state[1]) == _bytes(wholes["opt"])
    assert torch.equal(dst.generator.get_state(),
                       torch.Generator().manual_seed(3).get_state())


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

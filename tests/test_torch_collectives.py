"""The Horovod verbs and the comms probes of ``parallel/collectives.py``, on
the CPU.

A gloo gang of four ranks (this file is its script) on a ``data=2 ×
expert=2`` mesh: each verb over the whole gang and over each axis's group
against numpy (``all_reduce_sum`` and ``all_reduce_mean`` with their
gradients, tiled and stacked ``all_gather``, ``reduce_scatter`` on dim 1,
``all_to_all``, ``broadcast_from``, ``ppermute_shift`` both ways); with the
probes on, one eager ``all_reduce_sum`` emits one ``collective`` event, an
``all_reduce_mean`` one more (not two) and a ``barrier_probe`` another; and the JAX package's probe contract
(``tests/test_fleet.py``'s ``test_probed_collectives_transparent_under_
tracing``) under ``torch.compile(backend="aot_eager")``: a probed
``all_reduce_sum`` inside the compiled region returns the exact sum and
emits no event from inside it.

In one process: ``tree_aggregate`` against the JAX package's; and
``Trainer.fit`` with ``DLS_COMMS_PROBE=1`` emits one ``barrier``
``collective`` event a log lap, which the JAX package's
``fleet.host_table`` folds into its ``collectives`` column."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.parallel import collectives as jcollectives
from distributeddeeplearningspark_tpu.telemetry import fleet as jfleet
from distributeddeeplearningspark_tpu_torch import Session, Trainer, telemetry
from distributeddeeplearningspark_tpu_torch.models import lenet
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.data import sources
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

N = 4
#: the gang's mesh: data=2 × expert=2 (rank = 2·data + expert)
CONF = {"mesh.data": 2, "mesh.expert": 2}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _value(rank: int) -> np.ndarray:
    """Rank ``rank``'s input: ``[4, 8]``, distinct on every rank."""
    return (np.arange(32, dtype=np.float32).reshape(4, 8) + 100 * rank)


# -- the gang's side ---------------------------------------------------------------------


def _verbs(rank: int) -> dict:
    x = torch.from_numpy(_value(rank))
    out = {}
    for axis in (None, "data", "expert"):
        key = axis or "all"
        t = x.clone().requires_grad_(True)
        y = collectives.all_reduce_sum(t, axis)
        (y * (rank + 1)).sum().backward()
        out[f"sum_{key}"] = y.tolist()
        out[f"sum_grad_{key}"] = t.grad.tolist()
        t = x.clone().requires_grad_(True)
        y = collectives.all_reduce_mean(t, axis)
        (y * (rank + 1)).sum().backward()
        out[f"mean_{key}"] = y.tolist()
        out[f"mean_grad_{key}"] = t.grad.tolist()
        out[f"gather_{key}"] = collectives.all_gather(x, axis).tolist()
        out[f"stack_{key}"] = collectives.all_gather({"x": x}, axis, tiled=False)["x"].tolist()
        out[f"scatter_{key}"] = collectives.reduce_scatter(x, axis, scatter_dim=1).tolist()
        out[f"bcast_{key}"] = collectives.broadcast_from(x, axis, root=1).tolist()
    out["all_to_all_expert"] = collectives.all_to_all(x, "expert", split_dim=1,
                                                      concat_dim=0).tolist()
    out["all_to_all_all"] = collectives.all_to_all(x, None, split_dim=0,
                                                   concat_dim=1).tolist()
    out["shift_all"] = collectives.ppermute_shift(x, None).tolist()
    out["shift_data_back"] = collectives.ppermute_shift(x, "data", shift=-1).tolist()
    return out


def _probes(outdir: Path, rank: int) -> dict:
    wd = outdir / "probes"
    telemetry.configure(wd, process=f"p{rank}")
    collectives.enable_collective_probes(True)
    try:
        x = torch.ones(8)
        eager = collectives.all_reduce_sum(x, "data")
        mean = collectives.all_reduce_mean(x * (rank + 1), "expert")
        collectives.barrier_probe()
        compiled = torch.compile(lambda t: collectives.all_reduce_sum(t, ("data",)),
                                 backend="aot_eager", fullgraph=False)
        inside = compiled(x)
        collectives.barrier()
    finally:
        collectives.enable_collective_probes(False)
    events = [e for e in telemetry.read_events(wd)
              if e["kind"] == "collective" and e.get("process") == f"p{rank}"]
    telemetry.reset()
    return dict(eager=eager.tolist(), mean=mean.tolist(), compiled=inside.tolist(),
                events=events)


def _worker(outdir: Path) -> None:
    builder = Session.builder.appName("verbs")
    for k, v in CONF.items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == N
    out = dict(verbs=_verbs(spark.rank), probes=_probes(outdir, spark.rank))
    (outdir / f"rank{spark.rank}.json").write_text(json.dumps(out))
    spark.stop()


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("gang_verbs")
    res = run_gang(["--master", f"local[{N}]", "--conf", f"{DEVICE_CONF}=cpu",
                    *(a for k, v in CONF.items() for a in ("--conf", f"{k}={v}")),
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(N)]


# -- numpy's side ---------------------------------------------------------------------------


def _group(rank: int, axis) -> list[int]:
    """The ranks of ``rank``'s group over ``axis`` (rank = 2·data + expert)."""
    if axis is None:
        return list(range(N))
    d, e = divmod(rank, 2)
    return [2 * i + e for i in range(2)] if axis == "data" else [2 * d + i for i in range(2)]


@pytest.mark.parametrize("axis", [None, "data", "expert"], ids=["all", "data", "expert"])
def test_reducing_verbs_match_numpy(gang, axis):
    """The sums and means and their gradients (each rank's cotangent its
    rank + 1: the gradient is the group's sum, or mean, of them)."""
    key = axis or "all"
    for r, rec in enumerate(gang):
        members = _group(r, axis)
        total = sum(_value(q) for q in members)
        weights = sum(q + 1 for q in members)
        v = rec["verbs"]
        np.testing.assert_array_equal(v[f"sum_{key}"], total)
        np.testing.assert_array_equal(v[f"sum_grad_{key}"], np.full((4, 8), weights))
        np.testing.assert_allclose(v[f"mean_{key}"], total / len(members), rtol=1e-6)
        np.testing.assert_allclose(v[f"mean_grad_{key}"],
                                   np.full((4, 8), weights / len(members)), rtol=1e-6)
        i = members.index(r)
        np.testing.assert_array_equal(v[f"scatter_{key}"],
                                      np.split(total, len(members), axis=1)[i])


@pytest.mark.parametrize("axis", [None, "data", "expert"], ids=["all", "data", "expert"])
def test_moving_verbs_match_numpy(gang, axis):
    key = axis or "all"
    for r, rec in enumerate(gang):
        members = _group(r, axis)
        v = rec["verbs"]
        np.testing.assert_array_equal(v[f"gather_{key}"],
                                      np.concatenate([_value(q) for q in members]))
        np.testing.assert_array_equal(v[f"stack_{key}"],
                                      np.stack([_value(q) for q in members]))
        np.testing.assert_array_equal(v[f"bcast_{key}"], _value(members[1]))


def test_all_to_all_and_ring_shift_match_numpy(gang):
    for r, rec in enumerate(gang):
        v = rec["verbs"]
        members = _group(r, "expert")
        i = members.index(r)
        # chunk i of each member's columns, stacked along rows in member order
        np.testing.assert_array_equal(v["all_to_all_expert"], np.concatenate(
            [np.split(_value(q), 2, axis=1)[i] for q in members], axis=0))
        np.testing.assert_array_equal(v["all_to_all_all"], np.concatenate(
            [np.split(_value(q), N, axis=0)[r] for q in range(N)], axis=1))
        np.testing.assert_array_equal(v["shift_all"], _value((r - 1) % N))
        data = _group(r, "data")
        j = data.index(r)
        np.testing.assert_array_equal(v["shift_data_back"], _value(data[(j + 1) % 2]))


def test_probes_time_eager_calls_and_stay_out_of_compiled_regions(gang):
    """One event for the eager ``all_reduce_sum`` (over ``data``) and one for
    the barrier; none from the compiled call, whose sum is exact."""
    for rec in gang:
        p = rec["probes"]
        assert p["eager"] == [2.0] * 8 and p["compiled"] == [2.0] * 8
        ops = [(e["op"], e["axis"]) for e in p["events"]]
        assert ops == [("all_reduce_sum", "data"), ("all_reduce_mean", "expert"),
                       ("barrier", "data,fsdp,pipe,expert,seq,tensor")], ops
        assert all(e["wait_s"] >= 0.0 for e in p["events"])


def test_an_eager_mean_is_one_event(gang):
    """``all_reduce_mean`` sums through the unprobed sum: one ``collective``
    event a call (as JAX's single ``pmean``), not one for the mean and one
    for the sum inside it; the mean over each ``expert`` pair of ranks'
    ``rank + 1``."""
    for r, rec in enumerate(gang):
        p = rec["probes"]
        means = [e for e in p["events"] if e["op"].startswith("all_reduce")]
        assert [e["op"] for e in means] == ["all_reduce_sum", "all_reduce_mean"]
        pair = [q for q in range(N) if q // 2 == r // 2]
        assert p["mean"] == [float(np.mean([q + 1 for q in pair]))] * 8, (r, p["mean"])


def test_probes_are_off_by_default_and_follow_the_env(monkeypatch):
    monkeypatch.delenv(collectives.COMMS_PROBE_ENV, raising=False)
    assert not collectives.collective_probes_enabled()
    monkeypatch.setenv(collectives.COMMS_PROBE_ENV, "1")
    assert collectives.collective_probes_enabled()
    collectives.enable_collective_probes(False)
    try:
        assert not collectives.collective_probes_enabled()
    finally:
        collectives._probe_override = None


def test_tree_aggregate_matches_jax():
    parts = [[1, 2, 3], [4], [], [5, 6]]
    args = ([0, 0], lambda acc, x: [acc[0] + x, acc[1] + 1],
            lambda a, b: [a[0] + b[0], a[1] + b[1]])
    assert collectives.tree_aggregate(parts, *args) == \
        jcollectives.tree_aggregate(parts, *args) == [21, 6]
    assert collectives.tree_aggregate([], *args) == [0, 0]


def test_fit_with_probes_emits_a_barrier_a_lap(tmp_path, monkeypatch):
    """LeNet's ``fit`` with ``DLS_COMMS_PROBE=1``: one ``barrier`` event each
    log lap, folded by the JAX package's ``fleet.host_table``."""
    monkeypatch.setenv(collectives.COMMS_PROBE_ENV, "1")
    monkeypatch.setenv(telemetry.WORKDIR_ENV, str(tmp_path))
    spark = Session.builder.master("local[1]").appName("probe").config(
        DEVICE_CONF, "cpu").getOrCreate()
    try:
        model = lenet.LeNet5(device="cpu")
        trainer = Trainer(spark, model, losses.softmax_xent, optim.sgd(0.1))
        ds = sources.synthetic_mnist(256, num_partitions=1)
        trainer.fit(ds.repeat(), batch_size=32, steps=6, log_every=2)
    finally:
        spark.stop()
        telemetry.reset()
    events = telemetry.read_events(tmp_path)
    probes = [e for e in events if e["kind"] == "collective"]
    assert [e["op"] for e in probes] == ["barrier"] * 3
    rows = jfleet.host_table(events)
    assert sum(r["collectives"] for r in rows) == 3


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

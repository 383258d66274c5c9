"""ZeRO weight-update sharding in the port (``parallel/plan.py``'s
``zero_axes``/``zero_plan``, ``parallel/zero.py``) against the JAX package
and against the replicated optimizer, on the CPU:

- **plan records**: ``zero_plan``'s and ``stage_plan("zero")``'s record,
  ``signature()`` and logical axes are JAX's; ``validate`` refuses zero
  axes that are not batch axes, as JAX's does;
- **gloo gangs of 4 and 2 ranks** (this file is their script): the tiny
  Llama (f32, every param trained) under ``with_grad_clip(adamw)``
  through ``Trainer.fit`` with ``plan=zero_plan(DP)`` against
  ``plan=DP`` on the same batches: the losses and the final params
  **bitwise** equal, each rank's optimizer-state bytes the replicated
  ones over the rank count for every sliced leaf (the leaves below
  ``zero_min_size`` whole); the 4-rank ZeRO checkpoint restored on the
  2-rank gang (ZeRO and DP alike, from their own 4-rank checkpoints):
  the restored params the 4-rank run's, and the next step's loss and
  params bitwise equal between the two;
- **the MPMD ``zero`` stage**: two stages under ``PipelineSupervisor``,
  stage 0 a 2-rank gang at ``data=2`` under ``zero`` against the
  ``replicated`` stage plan (``mode="sharded"``): losses and final params
  bitwise equal.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.parallel import plan as jplan
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.parallel import plan as tplan
from distributeddeeplearningspark_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.supervisor import PipelineSupervisor, StagePlan

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

B, S, STEPS, PARTS = 8, 32, 3, 4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- plan records ---------------------------------------------------------------------


def _pairs():
    """(port plan, JAX plan) built the same way."""
    from distributeddeeplearningspark_tpu.parallel import sharding as jsharding

    return {
        "zero_dp": (tplan.zero_plan(tplan.DP), jplan.zero_plan(jplan.DP)),
        "zero_fsdp": (tplan.zero_plan(tplan.FSDP_PLAN), jplan.zero_plan(jplan.FSDP_PLAN)),
        "zero_data_only": (tplan.zero_plan(tplan.DP, axes=("data",), name="z"),
                           jplan.zero_plan(jplan.DP, axes=("data",), name="z")),
        "stage_zero": (tplan.stage_plan("zero"), jplan.stage_plan("zero")),
        "zero_min": (tplan.Plan(name="m", rules=tsharding.ShardingRules(fsdp=True),
                                zero_axes=("fsdp",), zero_min_size=64),
                     jplan.Plan(name="m", rules=jsharding.ShardingRules(fsdp=True),
                                zero_axes=("fsdp",), zero_min_size=64)),
    }


@pytest.mark.parametrize("name", ["zero_dp", "zero_fsdp", "zero_data_only", "stage_zero",
                                  "zero_min"])
def test_zero_plan_records_are_jax(name, tmp_path):
    port, jax_plan = _pairs()[name]
    assert port.to_record() == jax_plan.to_record()
    assert port.signature() == jax_plan.signature()
    assert port.logical_axes() == jax_plan.logical_axes()
    assert port.logical_axes()["weight_update"] == port.zero_axes
    port.save(str(tmp_path / "p.json"))
    loaded = tplan.Plan.load(str(tmp_path / "p.json"))
    assert loaded.signature() == jax_plan.signature() and loaded.zero_axes == port.zero_axes
    port.validate(tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1)))


@pytest.mark.parametrize("zero_axes", [("tensor",), ("data", "seq")])
def test_validate_refuses_zero_axes_outside_the_batch_axes(zero_axes):
    """As JAX's: ZeRO shards the optimizer state over the axes that
    replicate it, a subset of the batch axes."""
    import jax

    from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec as JMeshSpec

    plan = tplan.Plan(name="x", zero_axes=zero_axes)
    with pytest.raises(tplan.PlanValidationError, match="not replica"):
        plan.validate(tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1)))
    with pytest.raises(jplan.PlanValidationError, match="not replica"):
        jplan.Plan(name="x", zero_axes=zero_axes).validate(
            JMeshSpec(data=1).build(jax.devices()[:1]))


def test_zero_on_one_device_is_the_replicated_update():
    """On one device the zero degree is 1: nothing is sliced, and the
    Trainer's ZeRO step is the plain one, bit for bit."""
    from distributeddeeplearningspark_tpu_torch import Session, Trainer
    from distributeddeeplearningspark_tpu_torch.models import llama as tllama
    from distributeddeeplearningspark_tpu_torch.train import losses, optim

    rows = _rows()
    out = {}
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        for name, plan in (("dp", tplan.DP), ("zero", tplan.zero_plan(tplan.DP))):
            trainer = Trainer(spark, tllama.llama_tiny(device="cpu", seed=0),
                              losses.causal_lm, _tx(optim), plan=plan)
            state = trainer.init()
            batch = {k: torch.from_numpy(np.stack([r[k] for r in rows[:B]])) for k in rows[0]}
            losses_ = []
            for _ in range(2):
                state, m = trainer._train_step(state, batch)
                losses_.append(float(m["loss"]))
            out[name] = (losses_, _digests(state.params))
            if name == "zero":
                assert trainer.zero is not None and not any(trainer.zero.placements)
    assert out["zero"] == out["dp"]


# -- the gangs --------------------------------------------------------------------------


def _rows() -> list[dict]:
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, 512, S).astype(np.int64)}
            for _ in range(B * (STEPS + 2))]


def _tx(optim):
    return optim.with_grad_clip(optim.adamw(1e-2), 1.0)


def _digests(params: dict) -> dict:
    return {n: hashlib.blake2b(p.detach().contiguous().numpy().tobytes(),
                               digest_size=8).hexdigest() for n, p in params.items()}


def _opt_bytes(opt_state) -> tuple[int, int]:
    """(this rank's optimizer-state bytes, the whole state's)."""
    from distributeddeeplearningspark_tpu_torch.train.state import leaves

    ts = [t for t in leaves(opt_state) if isinstance(t, torch.Tensor)]
    return (sum(tsharding.local(t).numel() * t.element_size() for t in ts),
            sum(t.numel() * t.element_size() for t in ts))


def _worker(outdir: Path, mode: str) -> None:
    """One rank of a data-parallel gang: DP and ZeRO runs of STEPS steps,
    each checkpointed at its end; with ``mode == "restore"`` also the 4-rank
    runs' checkpoints restored here and one more step taken."""
    from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
    from distributeddeeplearningspark_tpu_torch.models import llama as tllama
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.train import losses, optim

    spark = Session.builder.appName("zero").getOrCreate()
    n = spark.world_size
    ds = PartitionedDataset.parallelize(_rows(), PARTS)
    rec = {}
    for name, plan in (("dp", tplan.DP), ("zero", tplan.zero_plan(tplan.DP))):
        logged: list = []
        ckpt = Checkpointer(outdir / f"ckpt_{name}_{n}", async_save=False)
        trainer = Trainer(spark, tllama.llama_tiny(device="cpu", seed=0), losses.causal_lm,
                          _tx(optim), plan=plan, checkpointer=ckpt)
        state, _ = trainer.fit(ds, batch_size=B, steps=STEPS, log_every=1,
                               checkpoint_every=STEPS,
                               callbacks=[lambda step, m: logged.append(m["loss"])])
        ckpt.close()
        mine, whole = _opt_bytes(state.opt_state)
        sliced = [pl is not None for pl in trainer.zero.placements] if trainer.zero else []
        rec[name] = dict(losses=logged, params=_digests(state.params), opt_bytes=mine,
                         opt_bytes_whole=whole, sliced=sum(sliced))
        if mode == "restore":
            ckpt4 = Checkpointer(outdir / f"ckpt_{name}_4", async_save=False)
            again = Trainer(spark, tllama.llama_tiny(device="cpu", seed=1), losses.causal_lm,
                            _tx(optim), plan=plan, checkpointer=ckpt4)
            restored, data_state = again.restore()
            rec[name]["restored_params"] = _digests(restored.params)
            nxt: list = []
            state, _ = again.fit(ds, batch_size=B, steps=STEPS + 1, log_every=1,
                                 data_state=data_state,
                                 callbacks=[lambda step, m: nxt.append(m["loss"])])
            rec[name].update(next_losses=nxt, next_params=_digests(state.params))
            ckpt4.close()
    (outdir / f"{mode}{n}_rank{spark.rank}.json").write_text(json.dumps(rec))
    spark.stop()


@pytest.fixture(scope="module")
@bounded()
def gangs(tmp_path_factory):
    """The 4-rank gang, then the 2-rank gang that also restores the 4-rank
    checkpoints."""
    outdir = tmp_path_factory.mktemp("zero")
    for n, mode in ((4, "train"), (2, "restore")):
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        str(Path(__file__).resolve()), str(outdir), mode],
                       env={"OMP_NUM_THREADS": "1"})
        assert res.returncode == 0, res.stderr[-4000:]
    return outdir


def _ranks(outdir: Path, mode: str, n: int) -> list[dict]:
    return [json.loads((outdir / f"{mode}{n}_rank{r}.json").read_text()) for r in range(n)]


@pytest.mark.parametrize("n,mode", [(4, "train"), (2, "restore")])
def test_zero_gang_is_the_replicated_optimizer_bitwise(gangs, n, mode):
    for rec in _ranks(gangs, mode, n):
        dp, zero = rec["dp"], rec["zero"]
        assert len(dp["losses"]) == STEPS and np.all(np.isfinite(dp["losses"]))
        assert [np.float32(x).tobytes() for x in zero["losses"]] == \
            [np.float32(x).tobytes() for x in dp["losses"]]
        assert zero["params"] == dp["params"]


@pytest.mark.parametrize("n,mode", [(4, "train"), (2, "restore")])
def test_zero_state_bytes_a_rank_fall_by_the_rank_count(gangs, n, mode):
    """Each sliced leaf (the tiny model's projections, embedding and head:
    every leaf of at least zero_min_size elements, and each of Adam's two
    moments) holds 1/n of its elements on each rank; the norm scales and
    the counts stay whole."""
    from distributeddeeplearningspark_tpu_torch.models import llama as tllama
    from distributeddeeplearningspark_tpu_torch.train import optim

    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="meta")
    min_size = tplan.zero_plan(tplan.DP).zero_min_size
    big = sum(p.numel() * 4 for p in model.parameters() if p.numel() >= min_size)
    small = sum(p.numel() * 4 for p in model.parameters() if p.numel() < min_size)
    counts = 8 * 2  # Adam's and the schedule's 0-d int64 counts
    del optim
    for rec in _ranks(gangs, mode, n):
        dp, zero = rec["dp"], rec["zero"]
        assert dp["opt_bytes"] == dp["opt_bytes_whole"] == 2 * (big + small) + counts
        assert zero["opt_bytes_whole"] == dp["opt_bytes"]
        assert zero["opt_bytes"] == 2 * (big // n + small) + counts
        assert zero["sliced"] == sum(1 for p in model.parameters() if p.numel() >= min_size)


def test_zero_checkpoint_restores_at_another_rank_count(gangs):
    """The 4-rank runs' checkpoints (ZeRO's optimizer state saved whole,
    gathered from its slices) restore on 2 ranks: the params are the
    4-rank run's, and the next step under ZeRO is DP's, bitwise."""
    four = _ranks(gangs, "train", 4)[0]
    for rec in _ranks(gangs, "restore", 2):
        for name in ("dp", "zero"):
            assert rec[name]["restored_params"] == four[name]["params"], name
        assert len(rec["zero"]["next_losses"]) == 1
        assert np.float32(rec["zero"]["next_losses"][0]).tobytes() == \
            np.float32(rec["dp"]["next_losses"][0]).tobytes()
        assert rec["zero"]["next_params"] == rec["dp"]["next_params"]
        assert rec["zero"]["next_params"] != rec["zero"]["restored_params"]


# -- the MPMD zero stage ----------------------------------------------------------------


def _stage_run(wd: Path, plan: str) -> tuple[dict, dict]:
    spec = {"steps": STEPS, "batch_size": B, "seq": S, "microbatches": 2, "seed": 3,
            "mode": "sharded", "device": "cpu", "checkpoint_every": STEPS,
            "stage_meshes": {"0": {"data": 2}, "1": {"data": 1}},
            "stage_plans": {"0": plan, "1": "replicated"},
            "optimizer": {"name": "adamw", "lr": 1e-3}}
    sup = PipelineSupervisor([StagePlan(), StagePlan()],
                             env={"OMP_NUM_THREADS": "1", "DLS_PIPE_SPEC": json.dumps(spec)},
                             telemetry_dir=str(wd), wall_timeout_s=150,
                             restart_backoff_s=0.1, max_restarts=0)
    res = sup.run()
    assert res.ok, {k: [(a.returncodes, a.classification) for a in v]
                    for k, v in res.attempts.items()}
    done = json.loads((wd / "DONE").read_text())
    params = {}
    for k in range(2):
        sd = torch.load(wd / f"stage{k}" / "ckpt" / str(STEPS) / "state.pt",
                        map_location="cpu", weights_only=True)
        params.update(_digests(sd["params"]))
    summary = json.loads(sorted((wd / "stage0").glob("summary-*.json"))[-1].read_text())
    return done, dict(params=params, plan=summary.get("plan"),
                      opt_bytes=[r["opt_state_bytes"] for r in summary["ranks"]])


def test_mpmd_zero_stage_is_the_replicated_stage_bitwise(tmp_path):
    """Stage 0 a 2-rank gang at data=2: under ``zero`` (its optimizer
    state sliced over data) its losses and the final params are those of
    the ``replicated`` stage plan, bitwise."""
    rep_done, rep = _stage_run(tmp_path / "replicated", "replicated")
    zero_done, zero = _stage_run(tmp_path / "zero", "zero")
    assert zero["plan"] == "stage-zero" and rep["plan"] == "stage-replicated"
    assert rep_done["step"] == zero_done["step"] == STEPS
    assert [np.float32(x).tobytes() for x in zero_done["losses"]] == \
        [np.float32(x).tobytes() for x in rep_done["losses"]]
    assert zero["params"] == rep["params"]
    # each rank of the zero stage holds about half the replicated state
    assert all(b < 0.6 * rep["opt_bytes"][0] for b in zero["opt_bytes"]), (zero, rep)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])

"""Multi-card MPMD stages on the CPU: each stage a gloo gang of two
processes under the port's ``PipelineSupervisor`` (the built-in stage
worker, the spec's ``"device": "cpu"``), 2 stages of the tiny Llama (4
layers, f32), the weights of JAX's init converted by
``llama_io.params_from_flax`` (the spec's ``init_params``), b = 8, S = 32,
M = 4, AdamW 1e-3.

- **exact at data=2** (the JAX driver's default layout): per-step losses
  and every updated param **bitwise** the port's one-program GPipe
  ``Trainer`` at ``data=2 × pipe=2`` (a 4-rank gloo gang; this file is its
  script): each rank accumulates its rows' gradients in reverse microbatch
  order, one all-reduce at the step, the last stage's loss the
  data-parallel ``Trainer``'s.
- **heterogeneous stages** (JAX's ``test_mpmd_heterogeneous_stage_meshes``):
  stage 0 at ``fsdp=2`` (FSDP2), stage 1 at ``tensor=2`` (``DTensor``
  Megatron splits), ``sharded`` 1F1B, against the JAX one-device train
  step (ROADMAP Queue 3 item 3: the one-device run is the oracle for
  multi-axis meshes): losses at :data:`LOSS_RTOL`, each param's change at
  :data:`JAX_CHANGE_RTOL`, and the layouts really FSDP2 and ``DTensor``.
- **a stage's geometry change on restore** (JAX's
  ``test_mpmd_stage_geometry_change_on_restore``): the exact run's step-2
  checkpoints, stage 1 restarted at ``tensor=2`` (``sharded``, the
  full-batch loss): the 4 losses the uninterrupted run's at
  :data:`LOSS_RTOL`.
- **the kill drill on a gang**: ``die_host@5`` on rank 1 of stage 1; only
  stage 1's two processes are relaunched (stage 0's pids do not change),
  and the losses and final params are bitwise the clean run's.
- **the supervisor's per-stage gang env**: ranks and world sizes, a
  rendezvous of its own a stage, the stage's ``CUDA_VISIBLE_DEVICES`` on a
  fake card list, ``num_processes`` in the ``attempt`` events.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.parallel import mpmd
from distributeddeeplearningspark_tpu_torch.supervisor import PipelineSupervisor, StagePlan
from distributeddeeplearningspark_tpu_torch.train import optim
from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as tpt

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

#: the losses against the JAX one-device step's, and a changed geometry's
#: against the uninterrupted run's (JAX's test_mpmd tolerance)
LOSS_RTOL = 1e-5
#: each param's change over the AdamW steps, |Δ_mpmd − Δ_jax| / |Δ_jax|
#: per tensor (test_torch_mpmd_e2e.py's criterion and bound: a first
#: gradient below Adam's eps steps by a rounding of it)
JAX_CHANGE_RTOL = 3e-3
B, T, M, STEPS, SEED, LR = 8, 32, 4, 6, 7, 1e-3
#: the heterogeneous run's steps
HETERO_STEPS = 3
#: one intra-op thread a process: the GPipe ranks and the stage ranks then
#: sum in the same order, and four processes do not oversubscribe the CPU
BASE_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _spec(init: Path, **kw) -> dict:
    return {"steps": STEPS, "batch_size": B, "seq": T, "microbatches": M,
            "seed": SEED, "mode": "exact", "device": "cpu",
            "mesh": {"data": 2}, "init_params": str(init),
            "optimizer": {"name": "adamw", "lr": LR}, **kw}


def _supervised(wd: Path, spec: dict, env: dict | None = None,
                stages: list[StagePlan] | None = None, **kw):
    sup = PipelineSupervisor(stages or [StagePlan(), StagePlan()],
                             env={**BASE_ENV, "DLS_PIPE_SPEC": json.dumps(spec),
                                  **(env or {})},
                             telemetry_dir=str(wd), wall_timeout_s=150,
                             restart_backoff_s=0.1, **kw)
    res = sup.run()
    assert res.ok, {k: [(a.returncodes, a.classification) for a in v]
                    for k, v in res.attempts.items()}
    done = json.loads((wd / "DONE").read_text())
    summaries = {k: [json.loads(p.read_text())
                     for p in sorted((wd / f"stage{k}").glob("summary-*.json"))]
                 for k in range(2)}
    return res, done, summaries


def _final_params(wd: Path, step: int) -> dict:
    """The whole model's params at ``step``, from the two stages'
    checkpoints (each holds its stage's params whole)."""
    out = {}
    for k in range(2):
        sd = torch.load(wd / f"stage{k}" / "ckpt" / str(step) / "state.pt",
                        map_location="cpu", weights_only=True)
        out.update({n: p.numpy() for n, p in sd["params"].items()})
    return out


def _bits(losses) -> list[bytes]:
    return [np.float32(x).tobytes() for x in losses]


@pytest.fixture(scope="module")
@bounded()
def jax_init(tmp_path_factory):
    """JAX's init of the tiny Llama (seed SEED), converted, saved for the
    stages' ``init_params``; and the JAX one-device train step's losses and
    final params over HETERO_STEPS AdamW steps of the spec's batches."""
    import jax
    import optax

    from distributeddeeplearningspark_tpu.data.feed import put_global
    from distributeddeeplearningspark_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec
    from distributeddeeplearningspark_tpu.parallel.sharding import ShardingRules
    from distributeddeeplearningspark_tpu.train import losses, step as step_lib

    root = tmp_path_factory.mktemp("mpmd_stages")
    batch_fn = tpt.synthetic_batch_fn({"batch_size": B, "seq": T})
    tx = optax.adamw(LR)
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    model = LlamaForCausalLM(LlamaConfig.tiny())
    state, sh = step_lib.init_state(model, tx, batch_fn(0), mesh, ShardingRules(),
                                    seed=SEED)
    tcfg = tllama.LlamaConfig.tiny()

    def port_names(params):
        return {k: v.numpy().copy() for k, v in tllama_io.params_from_flax(
            jax.tree.map(lambda a: np.array(a), params), tcfg).items()}

    init = port_names(jax.device_get(state.params))
    path = root / "init.pt"
    torch.save({k: torch.from_numpy(v) for k, v in init.items()}, path)
    ts = step_lib.jit_train_step(
        step_lib.make_train_step(model.apply, tx, losses.causal_lm), mesh, sh)
    ref = []
    for s in range(HETERO_STEPS):
        state, met = ts(state, put_global(batch_fn(s), mesh))
        ref.append(float(jax.device_get(met["loss"])))
    return dict(root=root, path=path, init=init, losses=ref,
                final=port_names(jax.device_get(state.params)))


@pytest.fixture(scope="module")
@bounded()
def exact_run(jax_init):
    """The clean exact run: two stages at data=2, STEPS steps, a checkpoint
    every 2."""
    wd = jax_init["root"] / "exact"
    res, done, summaries = _supervised(wd, _spec(jax_init["path"], checkpoint_every=2))
    return dict(wd=wd, res=res, done=done, summaries=summaries)


# -- exact at data=2 is the GPipe Trainer at data=2 × pipe=2, bitwise ------------------


def _gpipe_worker(outdir: Path) -> None:
    """One rank of the data=2 × pipe=2 gang: the port's GPipe ``Trainer``
    from the converted JAX init on the spec's batches; rank (data 0) of each
    stage writes its stage's params, rank 0 the logged losses."""
    from distributeddeeplearningspark_tpu_torch import Session, Trainer
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.train import losses

    spark = (Session.builder.appName("mpmd-gpipe").config("mesh.data", 2)
             .config("mesh.pipe", 2).getOrCreate())
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(outdir / "init.pt", weights_only=True))
    trainer = Trainer(spark, model, losses.causal_lm, optim.adamw(LR, weight_decay=1e-4),
                      rules=tllama.llama_rules(cfg, pipeline=True),
                      pipeline_microbatches=M)
    batch_fn = tpt.synthetic_batch_fn({"batch_size": B, "seq": T})
    rows = [{k: v[i] for k, v in batch_fn(s).items()} for s in range(STEPS) for i in range(B)]
    logged: list = []
    trainer.fit(PartitionedDataset.parallelize(rows, 1), batch_size=B, steps=STEPS,
                log_every=1, callbacks=[lambda step, m: logged.append(m["loss"])])
    stage = spark.mesh.pipe_index
    half = cfg.num_layers // 2
    if spark.mesh.batch_index(spark.rank) == 0:
        np.savez(outdir / f"params_stage{stage}.npz",
                 **{n: p.detach().numpy() for n, p in trainer.model.named_parameters()
                    if not n.startswith("layers.") or int(n.split(".")[1]) // half == stage})
    if spark.rank == 0:
        (outdir / "losses.json").write_text(json.dumps(logged))
    spark.stop()


def test_exact_data2_stages_are_the_gpipe_trainer_bitwise(jax_init, exact_run):
    from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF

    out = jax_init["root"] / "gpipe"
    out.mkdir(exist_ok=True)
    shutil.copy(jax_init["path"], out / "init.pt")
    res = run_gang(["--master", "local[4]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(out)], env=BASE_ENV)
    assert res.returncode == 0, res.stderr[-4000:]
    gpipe = json.loads((out / "losses.json").read_text())
    assert len(gpipe) == STEPS and _bits(exact_run["done"]["losses"]) == _bits(gpipe)
    got = _final_params(exact_run["wd"], STEPS)
    for k in (0, 1):
        want = dict(np.load(out / f"params_stage{k}.npz"))
        for n, w in want.items():
            if n in got:  # the GPipe stages also hold the replicated head and embedding
                assert got[n].tobytes() == w.tobytes(), n
    assert set(got) <= {n for k in (0, 1) for n in np.load(out / f"params_stage{k}.npz")}
    # each rank took one row of each 2-row microbatch: the lead scattered
    # the gradients (stage 0) and activations (stage 1) it received, and
    # gathered what it sent; M of each a step
    mb_bytes = B // M * T * 128 * 4
    for k in (0, 1):
        gang = exact_run["summaries"][k][-1]["stats"]["gang"]
        for kind in ("scatter", "gather"):
            assert gang[kind] == [STEPS * M, STEPS * M * mb_bytes], (k, gang)
        assert gang["broadcast"] == [0, 0]
        assert [r["rank"] for r in exact_run["summaries"][k][-1]["ranks"]] == [0, 1]


# -- heterogeneous stage meshes against the JAX one-device step -------------------------


def test_heterogeneous_fsdp_and_tensor_stages_match_jax(jax_init):
    wd = jax_init["root"] / "hetero"
    spec = _spec(jax_init["path"], steps=HETERO_STEPS, checkpoint_every=HETERO_STEPS,
                 mode="sharded", loss_mode="per_microbatch", fsdp_min_size=2**10,
                 stage_meshes={"0": {"data": 1, "fsdp": 2}, "1": {"data": 1, "tensor": 2}},
                 stage_plans={"0": "fsdp", "1": "tensor"})
    _, done, summaries = _supervised(wd, spec)
    np.testing.assert_allclose(done["losses"], jax_init["losses"], rtol=LOSS_RTOL)
    got = _final_params(wd, HETERO_STEPS)
    assert set(got) == set(jax_init["final"])
    for n, want in jax_init["final"].items():
        change = np.linalg.norm(want - jax_init["init"][n])
        assert change > 0, n
        assert np.linalg.norm(got[n] - want) <= JAX_CHANGE_RTOL * change, n
    # the layouts really differ: FSDP2 shards over fsdp on stage 0, DTensor
    # Shard placements over tensor on stage 1 (no FSDP there)
    lay0 = summaries[0][-1]["layout"]
    lay1 = summaries[1][-1]["layout"]
    assert lay0["fsdp_modules"] > 0 and lay1["fsdp_modules"] == 0
    assert lay0["sharded"]["layers.0.mlp.gate.weight"] == [["fsdp"], ["Shard(0)"]]
    assert lay1["sharded"]["layers.2.attention.wq.weight"] == [["tensor"], ["Shard(0)"]]
    assert lay1["sharded"]["layers.2.mlp.down.weight"] == [["tensor"], ["Shard(1)"]]
    assert lay1["sharded"]["lm_head.weight"] == [["tensor"], ["Shard(0)"]]
    assert all(m == ["fsdp"] for m, _ in lay0["sharded"].values())
    # stage 0 scattered the gradients' rows and gathered its activations;
    # stage 1's tensor peers took every row, broadcast
    g0, g1 = (summaries[k][-1]["stats"]["gang"] for k in (0, 1))
    assert g0["scatter"][0] == g0["gather"][0] == HETERO_STEPS * M and g0["broadcast"][0] == 0
    assert g1["broadcast"][0] == HETERO_STEPS * M and g1["scatter"][0] == g1["gather"][0] == 0


# -- a stage's geometry change on restore ---------------------------------------------------


def test_stage_geometry_change_on_restore(jax_init, exact_run):
    """Stage 1 comes back at tensor=2 (sharded, the full-batch loss) from the
    exact data=2 run's step-2 checkpoint (whole tensors: each rank takes its
    shard of the params and of AdamW's moments); the 4 losses continue the
    uninterrupted run's."""
    wd = jax_init["root"] / "geometry"
    for k in (0, 1):
        shutil.copytree(exact_run["wd"] / f"stage{k}" / "ckpt" / "2",
                        wd / f"stage{k}" / "ckpt" / "2")
    spec = _spec(jax_init["path"], steps=4, checkpoint_every=2, mode="sharded",
                 loss_mode="full_batch",
                 stage_meshes={"0": {"data": 2}, "1": {"data": 1, "tensor": 2}},
                 stage_plans={"0": "replicated", "1": "tensor"})
    _, done, summaries = _supervised(wd, spec)
    assert done["step"] == 4 and len(done["losses"]) == 4
    np.testing.assert_allclose(done["losses"], exact_run["done"]["losses"][:4],
                               rtol=LOSS_RTOL)
    assert summaries[1][-1]["layout"]["sharded"]["lm_head.weight"] == [["tensor"],
                                                                       ["Shard(0)"]]
    assert summaries[1][-1]["mesh"]["tensor"] == 2


# -- the kill drill on a gang ---------------------------------------------------------------


def test_gang_kill_drill_restarts_only_the_dead_stage(jax_init, exact_run):
    wd = jax_init["root"] / "drill"
    res, done, summaries = _supervised(
        wd, _spec(jax_init["path"], checkpoint_every=2),
        {"DLS_FAULT": "die_host@5", "DLS_FAULT_HOST": "1", "DLS_FAULT_RANK": "1",
         "DLS_FAULT_ONCE": "1"})
    assert res.restarts_of(1) == 1 and res.restarts_of(0) == 0
    dead = res.attempts[1][0]
    assert dead.classification == "stage-crash" and dead.num_processes == 2
    assert dead.returncodes[1] == -9, dead.returncodes  # rank 1 died; rank 0 was killed
    events = telemetry.read_events(str(wd))
    begins = [e for e in events if e.get("kind") == "attempt" and e.get("edge") == "begin"]
    pids = {k: [e["pids"] for e in begins if e["stage"] == k] for k in (0, 1)}
    assert len(pids[0]) == 1 and len(pids[1]) == 2 and not set(pids[1][0]) & set(pids[1][1])
    assert all(e["num_processes"] == 2 for e in begins)
    # stage 0's ranks ran to the end in the processes first launched
    assert [r["pid"] for r in summaries[0][-1]["ranks"]] == pids[0][0]
    assert [r["pid"] for r in summaries[1][-1]["ranks"]] == pids[1][1]
    assert _bits(done["losses"]) == _bits(exact_run["done"]["losses"])
    for k in (0, 1):
        assert summaries[k][-1]["param_digests"] == \
            exact_run["summaries"][k][-1]["param_digests"], k
    rec = [(e.get("event"), e.get("stage")) for e in events if e.get("kind") == "recovery"]
    assert ("stage-restart", 1) in rec and ("pipeline-resync", 0) in rec, rec


# -- the supervisor's per-stage gang env ---------------------------------------------------


def test_supervisor_gang_env_contract(tmp_path):
    spec = {"steps": 1, "stage_meshes": {"0": {"data": 2}, "1": {"data": 1, "tensor": 2}}}
    stages = [StagePlan(env={"CUDA_VISIBLE_DEVICES": "4,5"}),
              StagePlan(env={"CUDA_VISIBLE_DEVICES": "6,7"})]
    dump = ("import json, os, sys\n"
            "keys = ['DLS_STAGE_ID', 'DLS_PROCESS_ID', 'DLS_NUM_PROCESSES', "
            "'DLS_COORDINATOR', 'DLS_HOST_ID', 'DLS_RESTART', 'CUDA_VISIBLE_DEVICES', "
            "'DLS_HEARTBEAT_FILE']\n"
            "env = {k: os.environ.get(k) for k in keys}\n"
            f"path = os.path.join({str(tmp_path)!r}, "
            "'env-%s-%s.json' % (env['DLS_STAGE_ID'], env['DLS_PROCESS_ID']))\n"
            "open(path, 'w').write(json.dumps(env))\n")
    argv = [sys.executable, "-c", dump]
    sup = PipelineSupervisor([StagePlan(argv=argv, env=s.env) for s in stages],
                             env={mpmd.ENV_SPEC: json.dumps(spec)},
                             telemetry_dir=str(tmp_path), hang_timeout_s=60)
    assert sup.sizes == [2, 2]
    res = sup.run()
    assert res.ok and all(len(v) == 1 for v in res.attempts.values())
    seen = {(k, r): json.loads((tmp_path / f"env-{k}-{r}.json").read_text())
            for k in (0, 1) for r in (0, 1)}
    for (k, r), env in seen.items():
        assert env["DLS_PROCESS_ID"] == str(r) and env["DLS_NUM_PROCESSES"] == "2"
        assert env["DLS_HOST_ID"] == str(k) and env["DLS_RESTART"] == "0"
        assert env["CUDA_VISIBLE_DEVICES"] == ("4,5", "6,7")[k]
        assert env["DLS_HEARTBEAT_FILE"].endswith(f"hb_{k}_{r}")
    # a rendezvous of its own a stage, shared by its ranks
    assert seen[0, 0]["DLS_COORDINATOR"] == seen[0, 1]["DLS_COORDINATOR"]
    assert seen[1, 0]["DLS_COORDINATOR"] == seen[1, 1]["DLS_COORDINATOR"]
    assert seen[0, 0]["DLS_COORDINATOR"] != seen[1, 0]["DLS_COORDINATOR"]
    events = telemetry.read_events(str(tmp_path))
    attempts = [e for e in events if e.get("kind") == "attempt"]
    assert sorted((e["edge"], e["stage"], e["num_processes"]) for e in attempts) == [
        ("begin", 0, 2), ("begin", 1, 2), ("end", 0, 2), ("end", 1, 2)]
    assert all(len(e["pids"]) == 2 for e in attempts if e["edge"] == "begin")
    # a gang of two on one card is refused before anything launches
    with pytest.raises(ValueError, match="share a card"):
        PipelineSupervisor([StagePlan(env={"CUDA_VISIBLE_DEVICES": "0"}), stages[1]],
                           env={mpmd.ENV_SPEC: json.dumps(spec)})


if __name__ == "__main__":
    _gpipe_worker(Path(sys.argv[1]))

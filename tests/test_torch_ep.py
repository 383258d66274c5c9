"""Expert parallelism (the mesh's ``expert`` axis) against the JAX package,
on the CPU.

Four gloo gangs of four ranks (this file is their script), each against
the JAX ``Trainer``'s **one-device** run from the same converted weights
and batches (the reference miscomputes ``data × expert`` meshes on this
jax, ROADMAP Queue 3 item 3): ``expert=4``, ``fsdp=2 × expert=2``,
``tensor=2 × expert=2`` and ``data=2 × expert=2``. In each, a full
fine-tune of the 2-layer MoE Llama (4 experts, top-2; every param
trainable, the bank and the router included, ``llama_rules`` at
``fsdp_min_size=1`` through ``plan=``) takes 5 AdamW steps: every rank's
logged loss, ``moe_aux``, ``moe_dropped_frac`` and grad norm are JAX's,
the final params are JAX's, and each rank holds its own experts (its
local shard of each bank the coordinates' chunk of JAX's final bank, at
the rule engine's resident bytes).

The planted faults, each of which must break one of those limits:
``ep-output-unsummed`` (no ``g`` after the local experts: each rank's
output lacks its peers' slots), ``ep-dx-unsummed`` (no ``f`` before them:
x's gradient holds only the local experts' part), ``ep-router-summed``
(the router's input through ``f``: its gradient counted once per expert
peer, which the grad norm catches), ``ep-gates-unsummed`` (no ``f`` on
the combine's gates: the router's gradient through them holds only the
local slots' part) at ``expert=4``, and
``aux-local-means`` (the load balance from each rank's own means, not the
global batch's) at ``fsdp=2 × expert=2``. The ``pipe`` axis still
refuses.

f32 throughout: each tolerance is summation order, and says so."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.models import moe as tmoe
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.parallel import plan as tplan
from distributeddeeplearningspark_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

B, S, STEPS, PARTS, EXPERTS = 4, 32, 5, 4, 4
# logged losses, aux and grad norms over 5 f32 AdamW steps against JAX's
# one device: the ranks' sums (over the batch shards, the expert and
# tensor peers' slot outputs and gradients) in another order than XLA's
RTOL = 1e-4
# each param's change over those steps, |Δ_port − Δ_jax| / |Δ_jax| per
# tensor (test_torch_tp.py's: Adam's ±lr steps where a gradient is ~0)
PARAM_RTOL = 1e-3
#: the gangs: the session's mesh conf (four ranks each)
GANGS = {
    "expert4": {"mesh.data": 1, "mesh.fsdp": -1, "mesh.expert": 4},
    "fsdp_expert": {"mesh.data": 1, "mesh.fsdp": -1, "mesh.expert": 2},
    "tensor_expert": {"mesh.data": 1, "mesh.fsdp": -1, "mesh.expert": 2,
                      "mesh.tensor": 2},
    "data_expert": {"mesh.data": 2, "mesh.fsdp": 1, "mesh.expert": 2},
}
#: the planted faults, by the gang they run in
FAULTS = {"ep-output-unsummed": "expert4", "ep-dx-unsummed": "expert4",
          "ep-router-summed": "expert4", "ep-gates-unsummed": "expert4",
          "aux-local-means": "fsdp_expert"}
METRICS = ("loss", "moe_aux", "moe_dropped_frac", "grad_norm")
BANKS = ("w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _examples(n: int = 16, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, S).astype(np.int32),
             "loss_mask": np.ones(S, np.float32)} for _ in range(n)]


def _tcfg():
    return tllama.LlamaConfig.tiny(num_layers=2, intermediate_size=64,
                                   moe_experts=EXPERTS)


def _tx(mod):
    return mod.with_grad_clip(mod.adamw(mod.warmup_cosine(1e-2, 1, STEPS)), 1.0)


# -- the faults -------------------------------------------------------------------------


def plant(fault: str):
    """Plant one of FAULTS into this process's port; returns what undoes
    it."""
    saved = [(tmoe, "_leave", tmoe._leave), (tmoe, "_enter", tmoe._enter),
             (tmoe, "_gates", tmoe._gates),
             (tmoe.MoEMLP, "_route", tmoe.MoEMLP._route),
             (tllama.LlamaForCausalLM, "forward", tllama.LlamaForCausalLM.forward)]
    if fault == "ep-output-unsummed":
        tmoe._leave = lambda y, splits: y
    elif fault == "ep-dx-unsummed":
        tmoe._enter = lambda x, splits: x
    elif fault == "ep-gates-unsummed":
        tmoe._gates = lambda w, splits: w
    elif fault == "ep-router-summed":
        route = tmoe.MoEMLP._route
        tmoe.MoEMLP._route = lambda self, x: route(self, tmoe._enter(x, self.splits()))
    elif fault == "aux-local-means":
        forward = tllama.LlamaForCausalLM.forward

        def local_means(self, *a, **kw):
            self.batch_sum = None
            return forward(self, *a, **kw)
        tllama.LlamaForCausalLM.forward = local_means
    else:
        assert fault == "none", fault

    def undo():
        for owner, name, value in saved:
            setattr(owner, name, value)
    return undo


# -- the gangs' side ----------------------------------------------------------------------


def _run(spark, outdir: Path, gang: str, fault: str) -> dict:
    """5 steps of the full fine-tune from the JAX init, ``fault`` planted:
    every step's metrics, the local shard of each bank against the
    coordinates' chunk of JAX's final bank, the resident bytes and the rule
    engine's reckoning; rank 0 writes the final params whole."""
    model = tllama.LlamaForCausalLM(_tcfg(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in np.load(outdir / "init.npz").items()})
    plan = tplan.Plan(name="full", rules=tllama.llama_rules(model.cfg, fsdp_min_size=1))
    trainer = Trainer(spark, model, losses.causal_lm, _tx(optim), plan=plan)
    logged: list = []
    trainer.fit(PartitionedDataset.parallelize(_examples(), PARTS).repeat(),
                batch_size=B, steps=STEPS, log_every=1,
                callbacks=[lambda s, m: logged.append({k: m[k] for k in METRICS})])
    final = {n: tsharding.full(p.detach()).numpy()
             for n, p in trainer.model.named_parameters()}
    if spark.rank == 0 and fault == "none":
        np.savez(outdir / f"{gang}_final.npz", **final)
    jfinal = dict(np.load(outdir / "jax_final.npz"))
    named = dict(trainer.model.named_parameters())
    banks = {}
    for n in named:
        if n.rsplit(".", 1)[-1] in BANKS:
            mine = tsharding.local(named[n])
            want = tsharding.shard_of(named[n], torch.from_numpy(jfinal[n]))
            banks[n] = dict(shape=list(mine.shape),
                            err=float((mine - want).abs().max() / want.abs().max()))
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    return dict(metrics=logged, banks=banks,
                resident=tsharding.resident_param_bytes(trainer.model),
                reckoned=tsharding.bytes_per_card(
                    shapes, {n: p.element_size() for n, p in named.items()},
                    plan.rules, spark.mesh),
                expert_dims=trainer.expert_dims)


def _worker(outdir: Path, gang: str) -> None:
    """One rank of a gang: the sound run, then each of its FAULTS'."""
    builder = Session.builder.appName(f"ep-{gang}")
    for k, v in GANGS[gang].items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == 4
    for fault in ["none", *(f for f, g in FAULTS.items() if g == gang)]:
        undo = plant(fault)
        try:
            out = dict(mesh=spark.mesh.shape, rank=spark.rank,
                       **_run(spark, outdir, gang, fault))
        finally:
            undo()
        (outdir / f"{gang}_{fault}_rank{spark.rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the JAX side ---------------------------------------------------------------------------


def _jax_run(outdir: Path) -> list[dict]:
    """The JAX Trainer's full fine-tune on one device: its init and final
    params as port state dicts (written for the gangs), each step's
    metrics."""
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim

    def port(trainer) -> dict:
        tree = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
        return {k: v.numpy() for k, v in tllama_io.params_from_flax(tree, _tcfg()).items()}

    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    jcfg = jllama.LlamaConfig.tiny(num_layers=2, intermediate_size=64,
                                   moe_experts=EXPERTS)
    jt = JTrainer(jspark, jllama.LlamaForCausalLM(jcfg), jlosses.causal_lm, _tx(joptim))
    jds = JDataset.parallelize(_examples(), num_slices=PARTS)
    jt.init(jt._sample_batch(jds, B))
    np.savez(outdir / "init.npz", **port(jt))
    logged: list = []
    jt.fit(jds.repeat(), batch_size=B, steps=STEPS, log_every=1,
           callbacks=[lambda s, m: logged.append({k: float(m[k]) for k in METRICS})])
    np.savez(outdir / "jax_final.npz", **port(jt))
    jspark.stop()
    return logged


@pytest.fixture(scope="module")
@bounded()
def gangs(tmp_path_factory):
    """The JAX one-device run (its init seeds the gangs), then the gangs,
    each sound and with its faults: (outdir, JAX's metrics)."""
    outdir = tmp_path_factory.mktemp("gang_ep")
    want = _jax_run(outdir)
    for gang in GANGS:
        res = run_gang(["--master", "local[4]", "--conf", f"{DEVICE_CONF}=cpu",
                        str(Path(__file__).resolve()), str(outdir), gang])
        assert res.returncode == 0, (gang, res.stderr[-4000:])
    return outdir, want


def _ranks(outdir: Path, gang: str, fault: str = "none") -> list[dict]:
    return [json.loads((outdir / f"{gang}_{fault}_rank{r}.json").read_text())
            for r in range(4)]


def _gap(got: list[dict], want: list[dict], key: str) -> float:
    return max(abs(g[key] - w[key]) / max(abs(w[key]), 1e-12) for g, w in zip(got, want))


@pytest.mark.parametrize("gang", GANGS)
def test_gang_matches_jax_one_device(gangs, gang):
    """Every rank logs the same metrics, each step's JAX's; the final params
    JAX's."""
    outdir, want = gangs
    recs = _ranks(outdir, gang)
    assert recs[0]["mesh"] == tmesh.MeshSpec(
        **{k.split(".")[1]: v for k, v in GANGS[gang].items()}).shape(4)
    for rec in recs:
        assert rec["metrics"] == recs[0]["metrics"]
        for key in METRICS:
            assert _gap(rec["metrics"], want, key) <= RTOL, (key, rec["metrics"], want)
    final, jfinal = dict(np.load(outdir / f"{gang}_final.npz")), \
        dict(np.load(outdir / "jax_final.npz"))
    init = dict(np.load(outdir / "init.npz"))
    for n, w in jfinal.items():
        delta = np.abs(w - init[n]).max()
        assert np.abs(final[n] - w).max() <= PARAM_RTOL * max(delta, 1e-6), n


@pytest.mark.parametrize("gang", GANGS)
def test_each_rank_holds_its_experts(gangs, gang):
    """Each bank's local shard is ``[E/expert, H/fsdp, I/tensor]`` (``w_down``
    ``[E/expert, I/tensor, H/fsdp]``), the chunk of JAX's final bank at the
    rank's coordinates; resident bytes are the rule engine's reckoning."""
    outdir, _ = gangs
    shape = _ranks(outdir, gang)[0]["mesh"]
    e, f, t = shape["expert"], shape["fsdp"], shape["tensor"]
    cfg = _tcfg()
    h, i = cfg.hidden_size, cfg.intermediate_size
    for rec in _ranks(outdir, gang):
        assert rec["resident"] == rec["reckoned"]
        assert len(rec["expert_dims"]) == 3 * cfg.num_layers
        for n, bank in rec["banks"].items():
            want = ([EXPERTS // e, h // f, i // t] if not n.endswith("w_down")
                    else [EXPERTS // e, i // t, h // f])
            assert bank["shape"] == want, (n, bank)
            assert bank["err"] <= PARAM_RTOL, (n, bank)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_breaks_a_limit(gangs, fault):
    outdir, want = gangs
    recs = _ranks(outdir, FAULTS[fault], fault)
    gaps = {key: max(_gap(r["metrics"], want, key) for r in recs) for key in METRICS}
    assert max(gaps.values()) > 10 * RTOL, (fault, gaps)


def test_plan_validates_and_names_the_expert_axis():
    """A plan of the MoE rules validates on an ``expert`` mesh and names the
    axis among its params' logical axes."""
    plan = tplan.Plan(name="moe", rules=tllama.llama_rules(_tcfg()))
    plan.validate(tmesh.Mesh(tmesh.MeshSpec(data=1, fsdp=2, expert=2).shape(4)))
    assert "expert" in plan.logical_axes()["params"]


def test_pipe_axis_still_refuses():
    """The pipe axis beside expert names ROADMAP Queue 1 item 10, and the
    pipeline refuses the MoE model in JAX's words (its stage forward would
    drop the load balance); ``llama_rules(pipeline=True)`` lays the MoE
    layers out by stage all the same."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tmesh.MeshSpec(data=1, expert=2, pipe=2)
    from distributeddeeplearningspark_tpu_torch.models import llama_pp

    with pytest.raises(NotImplementedError, match="MoE is not wired"):
        llama_pp.check_pp_config(_tcfg(), 2)
    rules = tllama.llama_rules(_tcfg(), pipeline=True)
    assert rules.num_layers == _tcfg().num_layers and rules.stage_pattern


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])

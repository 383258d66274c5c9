"""The GPipe pipeline over the ``pipe`` axis against the JAX package, on
the CPU.

- The port's ``pipeline`` at ``pipe=4`` (a 4-rank gloo gang, each rank a
  stage with JAX's tanh ``stage_fn``) against JAX's ``pipeline`` on 4
  fake CPU devices, M ∈ {1, 2, 4}: outputs at atol/rtol 1e-5, gradients
  (each stage's weight and the input) at 1e-4 (``tests/test_pipeline.py``'s
  tolerances).
- The tiny Llama (4 layers, f32) at ``pipe=2``, ``pipe=4``, ``data=2 ×
  pipe=2``, ``fsdp=2 × pipe=2`` and ``pipe=2 × tensor=2`` (gloo gangs; this
  file is their script), the LoRA and the full fine-tune, 5 AdamW steps
  each, against the JAX ``Trainer``'s **one-device** run from the same
  converted weights and batches (ROADMAP Queue 3 item 3: the reference
  miscomputes ``data × pipe × tensor``): losses at rtol 1e-5, updated
  params at rtol 1e-4 (atol 1e-5), and the logged grad norms one
  device's. Besides: each rank holds only its stage's layers, as many
  bytes as the rule engine reckons; the meta-device init bitwise the eager
  one; the measured FLOPs of a step one rank's; the pipe peers feed the
  same rows; ``fit`` with eval at ``data × pipe``; a checkpoint written at
  ``pipe=2`` resumed there bitwise and restored bitwise at ``pipe=1``, at
  ``fsdp=2`` and at ``fsdp=2 × pipe=2``.
- The refusals: MoE, segment ids, an attention mask, the fused head loss,
  ``pipe × seq``, ``pipe × expert``, a model with no pipelined forward and
  ``num_layers % P``; and the driver at ``--pipeline 2``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
from distributeddeeplearningspark_tpu_torch.data.feed import host_batches
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.models import llama_pp as tllama_pp
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.parallel import plan as tplan
from distributeddeeplearningspark_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearningspark_tpu_torch.parallel.pipeline import pipeline, stage_layers
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_llama_lora.py"
RANK, B, S, STEPS = 4, 4, 32, 5
#: source partitions: the same global batches at 1 and 2 batch shards
PARTS = 4
#: JAX's test_pipeline tolerances: the loss, and the params one step
#: updated
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
#: each param's change over the 5 steps, |Δ_port − Δ_jax| / |Δ_jax| per
#: tensor (test_torch_tp.py's): AdamW steps ±lr wherever a gradient is
#: near 0, so summation order alone flips whole steps there (the full
#: fine-tune's embedding rows: up to 6e-4 here)
CHANGE_RTOL = 1e-3
#: the tanh pipeline against JAX's: outputs, gradients
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
#: the gangs: processes and the session's mesh conf
GANGS = {
    "pipe2": (2, {"mesh.data": 1, "mesh.pipe": 2}),
    "pipe4": (4, {"mesh.data": 1, "mesh.pipe": 4}),
    "data_pipe": (4, {"mesh.data": 2, "mesh.pipe": 2}),
    "fsdp_pipe": (4, {"mesh.data": 1, "mesh.fsdp": 2, "mesh.pipe": 2}),
    "pipe_tensor": (4, {"mesh.data": 1, "mesh.pipe": 2, "mesh.tensor": 2}),
}
#: the checkpoint's restores at other layouts (after the pipe2 gang wrote it)
RESTORES = {"fsdp": (2, {"mesh.data": 1, "mesh.fsdp": 2})}
#: the microbatches of each gang's Llama runs
MICRO = {"pipe2": 2, "pipe4": 4, "data_pipe": 2, "fsdp_pipe": 2, "pipe_tensor": 1}
TANH_M = (1, 2, 4)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- inputs both sides build ----------------------------------------------------


def _examples(n: int = 16, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, S).astype(np.int32),
             "loss_mask": np.ones(S, np.float32)} for _ in range(n)]


def _dataset(n: int = 16, seed: int = 3):
    return PartitionedDataset.parallelize(_examples(n, seed), PARTS)


def _tcfg(lora: bool):
    return tllama.LlamaConfig.tiny(lora_rank=RANK if lora else 0)


def _tx(mod, lora: bool):
    """The driver's optimizer: AdamW under the clip, masked for LoRA."""
    tx = mod.with_grad_clip(mod.adamw(mod.warmup_cosine(1e-2, 1, STEPS)), 1.0)
    if not lora:
        return tx
    if mod is optim:
        return mod.masked(tx, tllama.lora_trainable)
    from distributeddeeplearningspark_tpu.models import llama as jllama

    return mod.masked(tx, jllama.lora_trainable)


def _rules(cfg, full: bool):
    """``llama_rules`` by stage; the full fine-tune shards every divisible
    leaf over fsdp."""
    return tllama.llama_rules(cfg, pipeline=True, **({"fsdp_min_size": 1} if full else {}))


def _port_model(init: dict, lora: bool) -> tllama.LlamaForCausalLM:
    model = tllama.LlamaForCausalLM(_tcfg(lora), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _tanh_inputs() -> tuple[np.ndarray, np.ndarray]:
    """JAX's test_pipeline inputs: four stages' [16, 16] weights and a
    [8, 16] batch."""
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.5, (4, 16, 16)).astype(np.float32),
            rng.normal(0, 1, (8, 16)).astype(np.float32))


# -- the gangs' side ----------------------------------------------------------------


def _local_params(model) -> dict:
    """This rank's params whole within its stage (each stage's sharded ones
    gathered: every rank of the stage calls it)."""
    return {n: tsharding.full(p.detach()).numpy() for n, p in model.named_parameters()}


def _trainer(spark, model, lora: bool, gang: str, **kw) -> Trainer:
    cfg = model.cfg
    if lora:
        return Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                       rules=_rules(cfg, False), trainable=tllama.lora_trainable,
                       pipeline_microbatches=MICRO.get(gang), **kw)
    return Trainer(spark, model, losses.causal_lm, _tx(optim, False),
                   plan=tplan.Plan(name="full", rules=_rules(cfg, True)),
                   pipeline_microbatches=MICRO.get(gang), **kw)


def _batch(n: int = B, seed: int = 9) -> dict:
    return {k: torch.from_numpy(np.stack([e[k] for e in _examples(n, seed)]))
            for k in ("input_ids", "loss_mask")}


def _run(spark, outdir: Path, gang: str, name: str, lora: bool, **fit_kw) -> dict:
    """5 steps of the LoRA or the full fine-tune from the JAX init; each
    rank writes its params (whole within its stage). This rank's losses
    and grad norms, its param names, its resident bytes and the rule
    engine's reckoning, and the rows it fed first."""
    trainer = _trainer(spark, _port_model(dict(np.load(outdir / f"{name}_init.npz")),
                                          lora), lora, gang)
    logged: list = []

    def log(step: int, m: dict) -> None:
        logged.append((m["loss"], m["grad_norm"]))
        if step == 1:  # every rank: the gathers are collectives
            np.savez(outdir / f"{gang}_{name}_step1_rank{spark.rank}.npz",
                     **_local_params(trainer.model))

    _, summary = trainer.fit(_dataset().repeat(), batch_size=B, steps=STEPS, log_every=1,
                             callbacks=[log], **fit_kw)
    np.savez(outdir / f"{gang}_{name}_final_rank{spark.rank}.npz",
             **_local_params(trainer.model))
    whole = dict(tllama.LlamaForCausalLM(trainer.model.cfg, device="meta").named_parameters())
    return dict(
        losses=[x[0] for x in logged], grad_norms=[x[1] for x in logged],
        names=sorted(n for n, _ in trainer.model.named_parameters()),
        resident=tsharding.resident_param_bytes(trainer.model),
        reckoned=tsharding.bytes_per_card(
            {n: tuple(p.shape) for n, p in whole.items()},
            {n: p.element_size() for n, p in whole.items()},
            trainer.plan.rules, spark.mesh, stage=spark.mesh.pipe_index),
        skipped=summary.get("skipped_steps"))


def _first_rows(spark, gang: str) -> list:
    trainer = _trainer(spark, tllama.LlamaForCausalLM(_tcfg(True), device="meta"), True,
                       gang)
    feed = trainer._host_feed(_dataset(), B)
    try:
        return next(feed)["input_ids"].tolist()
    finally:
        feed.close()


def _meta_init(spark, outdir: Path, gang: str) -> None:
    """The LoRA model built on the meta device, converted, lowered,
    materialised and drawn by the Trainer from seed 0: each rank writes its
    params. Then the whole JAX init tree overlaid with ``load_pretrained``
    (strict): each rank writes what its params hold."""
    trainer = _trainer(spark, tllama.LlamaForCausalLM(_tcfg(True), device="meta"), True,
                       gang)
    np.savez(outdir / f"{gang}_meta_rank{spark.rank}.npz", **_local_params(trainer.model))
    trainer.init()
    trainer.load_pretrained(dict(np.load(outdir / "lora_init.npz")), strict=True)
    np.savez(outdir / f"{gang}_loaded_rank{spark.rank}.npz", **_local_params(trainer.model))


def _flops(spark, outdir: Path, gang: str) -> dict:
    """The measured FLOPs of one step on the same batch, LoRA and full."""
    out = {}
    for name, lora in (("lora", True), ("full", False)):
        init = dict(np.load(outdir / f"{name}_init.npz"))
        trainer = _trainer(spark, _port_model(init, lora), lora, gang)
        mine = slice(spark.mesh.batch_index(spark.rank) * (B // spark.default_parallelism),
                     (spark.mesh.batch_index(spark.rank) + 1) * (B // spark.default_parallelism))
        out[name] = trainer.measured_cost({k: v[mine] for k, v in _batch().items()})
    return out


def _tanh(spark, outdir: Path) -> None:
    """JAX's tanh stage at pipe=4, each rank its stage's weight: the output,
    this stage's weight's gradient and (stage 0) the input's, of the sum of
    the output's squares."""
    w_all, x_np = _tanh_inputs()
    k = spark.mesh.pipe_index
    for m in TANH_M:
        w = torch.from_numpy(w_all[k].copy()).requires_grad_(True)
        x = torch.from_numpy(x_np.copy()).requires_grad_(True)
        out = pipeline(lambda a: torch.tanh(a @ w), x, mesh=spark.mesh, num_microbatches=m)
        (out ** 2).sum().backward()
        np.savez(outdir / f"tanh_m{m}_rank{spark.rank}.npz", out=out.detach().numpy(),
                 dw=w.grad.numpy(),
                 **({"dx": x.grad.numpy()} if x.grad is not None else {}))


def _checkpoint(spark, outdir: Path, gang: str) -> None:
    """The full fine-tune: 4 steps straight with a checkpoint every 2, then
    a new trainer restored at step 2 and run to 4; each rank writes both
    runs' params."""
    init = dict(np.load(outdir / "full_init.npz"))
    for run in ("straight", "resumed"):
        ckpt = Checkpointer(outdir / "ckpt", async_save=run == "straight")
        trainer = _trainer(spark, _port_model(init, False), False, gang, checkpointer=ckpt)
        data_state = None
        if run == "resumed":
            _, data_state = trainer.restore(step=2)
        trainer.fit(_dataset().repeat(), batch_size=B, steps=4, log_every=2,
                    checkpoint_every=2 if run == "straight" else None,
                    data_state=data_state)
        ckpt.close()
        np.savez(outdir / f"ckpt_{run}_rank{spark.rank}.npz", **_local_params(trainer.model))


def _restore(spark, outdir: Path, gang: str) -> None:
    """The pipe=2 checkpoint's step 4 restored on this gang's mesh: each
    rank writes its params and the count of its optimizer leaves."""
    model = _port_model(dict(np.load(outdir / "full_init.npz")), False)
    trainer = _trainer(spark, model, False, gang, checkpointer=Checkpointer(outdir / "ckpt"))
    state, data_state = trainer.restore()
    assert state.step == 4 and data_state["examples_seen"] == 4 * B
    np.savez(outdir / f"restore_{gang}_rank{spark.rank}.npz", **_local_params(trainer.model))


def _refusals(spark, outdir: Path) -> dict:
    """What a pipe mesh refuses in a gang: a model with no pipelined
    forward, rules without the stage layout."""
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5

    from distributeddeeplearningspark_tpu_torch.parallel import live_reshard

    out = {}
    trainer = _trainer(spark, _port_model(dict(np.load(outdir / "lora_init.npz")), True),
                       True, "pipe2", checkpointer=Checkpointer(outdir / "drain"))
    trainer.init()
    for name, call, exc in (
            ("drain", lambda: trainer._graceful_drain(1, examples_seen=B, batch_size=B,
                                                      doomed=1), NotImplementedError),
            ("handoff", trainer.restore_live_handoff, live_reshard.HandoffError)):
        try:
            call()
            out[name] = None
        except exc as e:
            out[name] = str(e)
    for name, make in (
            ("lenet", lambda: Trainer(spark, LeNet5(device="cpu"), losses.softmax_xent,
                                      optim.sgd(0.1))),
            ("rules", lambda: Trainer(spark, _port_model(
                dict(np.load(outdir / "lora_init.npz")), True),
                losses.causal_lm, _tx(optim, True), rules=tllama.llama_rules(_tcfg(True)),
                trainable=tllama.lora_trainable))):
        try:
            make()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _worker(outdir: Path, gang: str) -> None:
    """One rank of a gang: every scenario of its mesh, in order."""
    n, conf = (GANGS.get(gang) or RESTORES[gang])
    builder = Session.builder.appName(f"pp-{gang}")
    for k, v in conf.items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == n
    out: dict = dict(mesh=spark.mesh.shape, rank=spark.rank)
    if gang in RESTORES:
        _restore(spark, outdir, gang)
        (outdir / f"{gang}_rank{spark.rank}.json").write_text(json.dumps(out))
        spark.stop()
        return
    out["stage"] = spark.mesh.pipe_index
    out["lora"] = _run(spark, outdir, gang, "lora", True)
    evals: list = []
    # the guard snapshots and restores each stage's params; a finite run
    # skips nothing and matches JAX's like the others
    fit_kw = dict(sanitize_every=1, on_nonfinite="skip")
    if gang == "data_pipe":
        orig = Trainer.evaluate

        def recorded(self, ds, *, batch_size):
            evals.append(orig(self, ds, batch_size=batch_size))
            return evals[-1]

        Trainer.evaluate = recorded
        fit_kw.update(eval_every=STEPS, eval_dataset=_dataset(6, seed=5))
    out["full"] = _run(spark, outdir, gang, "full", False, **fit_kw)
    out["evals"] = evals
    out["rows"] = _first_rows(spark, gang)
    _meta_init(spark, outdir, gang)
    if gang == "pipe4":
        _tanh(spark, outdir)
    if gang in ("pipe2", "pipe_tensor"):
        out["flops"] = _flops(spark, outdir, gang)
    if gang == "pipe2":
        out["refusals"] = _refusals(spark, outdir)
        _checkpoint(spark, outdir, gang)
    if gang == "fsdp_pipe":
        _restore(spark, outdir, gang)
    (outdir / f"{gang}_rank{spark.rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the JAX side -------------------------------------------------------------------


def _jax_run(outdir: Path, name: str, lora: bool) -> dict:
    """The JAX Trainer on one device: the init and final params as port
    state dicts, the logged losses and grad norms."""
    import jax

    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.models import llama as jllama
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim

    def port(trainer) -> dict:
        tree = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
        return {k: v.numpy() for k, v in tllama_io.params_from_flax(tree, _tcfg(lora)).items()}

    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    assert int(np.prod(list(dict(jspark.mesh.shape).values()))) == 1
    jcfg = jllama.LlamaConfig.tiny(lora_rank=RANK if lora else 0)
    kw = dict(trainable=jllama.lora_trainable) if lora else {}
    jt = JTrainer(jspark, jllama.LlamaForCausalLM(jcfg), jlosses.causal_lm,
                  _tx(joptim, lora), **kw)
    jds = JDataset.parallelize(_examples(), num_slices=PARTS)
    jt.init(jt._sample_batch(jds, B))
    init = port(jt)
    logged: list = []
    step1: dict = {}

    def log(step: int, m: dict) -> None:
        logged.append((float(m["loss"]), float(m["grad_norm"])))
        if step == 1:
            step1.update(port(jt))

    jt.fit(jds.repeat(), batch_size=B, steps=STEPS, log_every=1, callbacks=[log])
    final = port(jt)
    jspark.stop()
    np.savez(outdir / f"{name}_init.npz", **init)
    return dict(init=init, losses=[x[0] for x in logged],
                grad_norms=[x[1] for x in logged], step1=step1, final=final)


def _jax_tanh() -> dict:
    """JAX's ``pipeline`` at pipe=4 on 4 fake CPU devices: the output and
    the gradients of the sum of its squares, for each M."""
    import jax
    import jax.numpy as jnp

    from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from distributeddeeplearningspark_tpu.parallel.pipeline import pipeline as jpipeline

    mesh = JMeshSpec(data=1, pipe=4).build(jax.devices()[:4])
    w, x = (jnp.asarray(a) for a in _tanh_inputs())
    out = {}
    for m in TANH_M:
        def f(w, x, m=m):
            return jpipeline(lambda p, a: jnp.tanh(a @ p), w, x, mesh=mesh,
                             num_microbatches=m)
        y = jax.jit(f)(w, x)
        dw, dx = jax.jit(jax.grad(lambda w, x: jnp.sum(f(w, x) ** 2), argnums=(0, 1)))(w, x)
        out[m] = dict(out=np.asarray(y), dw=np.asarray(dw), dx=np.asarray(dx))
    return out


@pytest.fixture(scope="module")
@bounded()
def gangs(tmp_path_factory):
    """The JAX one-device runs (their init params seed the gangs) and JAX's
    tanh pipeline, then the gangs, then the restore at fsdp=2:
    (outdir, {"lora": JAX run, "full": JAX run, "tanh": ...})."""
    outdir = tmp_path_factory.mktemp("gang_pp")
    jruns = {name: _jax_run(outdir, name, name == "lora") for name in ("lora", "full")}
    jruns["tanh"] = _jax_tanh()
    for gang, (n, _) in [*GANGS.items(), *RESTORES.items()]:
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        str(Path(__file__).resolve()), str(outdir), gang])
        assert res.returncode == 0, (gang, res.stderr[-4000:])
    return outdir, jruns


def _rank(outdir, gang: str, r: int) -> dict:
    return json.loads((outdir / f"{gang}_rank{r}.json").read_text())


def _merged(outdir, prefix: str, ranks: int) -> dict:
    """Every rank's params file of ``prefix`` as one whole tree; a param
    several ranks hold (replicated, or its stage's copies) must be the same
    on each."""
    whole: dict = {}
    for r in range(ranks):
        for k, v in np.load(outdir / f"{prefix}_rank{r}.npz").items():
            if k in whole:
                assert np.array_equal(whole[k], v), (prefix, k, r)
            whole[k] = v
    return whole


# -- the tanh pipeline against JAX's ------------------------------------------------


@pytest.mark.parametrize("m", TANH_M)
def test_pipeline_matches_jax_pipeline(gangs, m):
    """The port's ``pipeline`` at pipe=4, M microbatches, JAX's tanh stage:
    every rank's output is JAX's (the bank broadcast from the last stage),
    each stage's weight gradient JAX's slice for it, stage 0's input
    gradient JAX's."""
    outdir, jruns = gangs
    want = jruns["tanh"][m]
    for r in range(4):
        got = dict(np.load(outdir / f"tanh_m{m}_rank{r}.npz"))
        np.testing.assert_allclose(got["out"], want["out"], atol=OUT_TOL, rtol=OUT_TOL)
        np.testing.assert_allclose(got["dw"], want["dw"][r], atol=GRAD_TOL, rtol=GRAD_TOL)
        assert ("dx" in got) == (r == 0)
    got0 = dict(np.load(outdir / f"tanh_m{m}_rank0.npz"))
    np.testing.assert_allclose(got0["dx"], want["dx"], atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("stages,stage,want", [(4, 0, [0]), (4, 3, [3]), (2, 1, [2, 3]),
                                               (1, 0, [0, 1, 2, 3])])
def test_stage_layers_is_stack_stages(stages, stage, want):
    """Stage k of P holds layers k·L/P … (k+1)·L/P − 1, JAX's
    ``stack_stages`` regrouping ``[L]`` into ``[P, L/P]``; L must divide."""
    import jax.numpy as jnp

    from distributeddeeplearningspark_tpu.parallel.pipeline import stack_stages

    assert list(stage_layers(4, stages, stage)) == want
    staged = stack_stages({"w": jnp.arange(4.0)}, stages)["w"]
    assert np.asarray(staged[stage]).tolist() == [float(i) for i in want]
    with pytest.raises(ValueError, match="divisible"):
        stage_layers(6, 4, 0)


# -- the gangs against JAX's one device -----------------------------------------------


@pytest.mark.parametrize("gang", sorted(GANGS))
@pytest.mark.parametrize("name", ["lora", "full"])
def test_gang_matches_jax_one_device(gangs, gang, name):
    """The tiny LoRA and the full fine-tune on each pipe mesh: every rank
    logged the same losses, JAX's one-device ones at rtol 1e-5; the params
    after the first step, put together from the stages, JAX's at rtol
    1e-4; each param's change over the 5 steps JAX's at CHANGE_RTOL."""
    outdir, jruns = gangs
    jrun = jruns[name]
    n = GANGS[gang][0]
    ranks = [_rank(outdir, gang, r) for r in range(n)]
    got = [r[name]["losses"] for r in ranks]
    assert all(g == got[0] for g in got) and len(got[0]) == STEPS
    if name == "full":  # under the guard: nothing skipped
        assert all(r[name]["skipped"] == 0.0 for r in ranks)
    np.testing.assert_allclose(got[0], jrun["losses"], rtol=LOSS_RTOL)
    step1 = _merged(outdir, f"{gang}_{name}_step1", n)
    assert sorted(step1) == sorted(jrun["step1"])
    for k, v in step1.items():
        np.testing.assert_allclose(v, jrun["step1"][k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    final = _merged(outdir, f"{gang}_{name}_final", n)
    assert sorted(final) == sorted(jrun["final"])
    for k, v in final.items():
        change = np.linalg.norm(jrun["final"][k] - jrun["init"][k])
        assert np.linalg.norm(v - jrun["final"][k]) <= CHANGE_RTOL * change, k
    moved = [k for k in final if not np.array_equal(final[k], jrun["init"][k])]
    if name == "lora":
        assert sorted(moved) == sorted(k for k in final if tllama.lora_trainable(k))
    else:
        assert len(moved) == len(final)


@pytest.mark.parametrize("gang", sorted(GANGS))
@pytest.mark.parametrize("name", ["lora", "full"])
def test_grad_norm_is_one_devices(gangs, gang, name):
    """Each logged ``grad_norm`` is the whole gradient's, JAX's one device's:
    each stage's squares summed across the pipe group once, the replicated
    head's and final norm's counted once, the embedding's (stage 0's only)
    summed over the pipe group first."""
    outdir, jruns = gangs
    for r in range(GANGS[gang][0]):
        np.testing.assert_allclose(_rank(outdir, gang, r)[name]["grad_norms"],
                                   jruns[name]["grad_norms"], rtol=1e-4)


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_each_rank_holds_its_stage_only(gangs, gang):
    """Each rank's params are the replicated embedding, final norm and head
    and its stage's layers (LoRA and norms included), no other layer's;
    its resident bytes are the rule engine's reckoning for its stage, the
    whole model's less the other stages' layers."""
    outdir, _ = gangs
    n = GANGS[gang][0]
    whole = tllama_pp.whole_param_names(_tcfg(True))
    for r in range(n):
        rec = _rank(outdir, gang, r)
        stages = rec["mesh"]["pipe"]
        mine = stage_layers(4, stages, rec["stage"])
        want = sorted(k for k in whole if not k.startswith("layers.")
                      or int(k.split(".")[1]) in mine)
        assert rec["lora"]["names"] == want
        assert rec["lora"]["resident"] == rec["lora"]["reckoned"]
        assert rec["full"]["resident"] == rec["full"]["reckoned"]
    stages = {_rank(outdir, gang, r)["stage"] for r in range(n)}
    assert stages == set(range(_rank(outdir, gang, 0)["mesh"]["pipe"]))


def test_pipe4_holds_a_quarter_of_the_7b_layers():
    """Config 5 at ``pipe=4``: a card holds 8 of the 32 layers' bf16 base
    and f32 LoRA and norms, and the whole bf16 embedding and head and f32
    final norm: 3,770,957,824 B, against 3,403,694,080 at ``fsdp=4``."""
    cfg = tllama.LlamaConfig.llama2_7b(lora_rank=16)
    named = dict(tllama.LlamaForCausalLM(cfg, device="meta").named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    sizes = {n: p.element_size() for n, p in named.items()}
    pipe4 = tmesh.Mesh(tmesh.MeshSpec(data=1, pipe=4).shape(4))
    got = {k: tsharding.bytes_per_card(shapes, sizes, tllama.llama_rules(cfg, pipeline=True),
                                       pipe4, stage=k) for k in range(4)}
    assert set(got.values()) == {8 * 202_375_168 * 2 + 2 * 131_072_000 * 2
                                 + (65_536 + 2_097_152 + 4_096) * 4} == {3_770_957_824}
    fsdp4 = tmesh.Mesh(tmesh.MeshSpec(data=1, fsdp=4).shape(4))
    assert tsharding.bytes_per_card(shapes, sizes, tllama.llama_rules(cfg), fsdp4) \
        == 3_403_694_080


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_meta_device_init_is_the_eager_init_bitwise(gangs, gang):
    """The model built on the meta device, converted to its stage, lowered,
    moved with ``to_empty`` and drawn by the Trainer from seed 0 (the other
    stages' layers drawn in their places and discarded) is, put together
    from the ranks, bit for bit the model built whole on one device."""
    outdir, _ = gangs
    meta = _merged(outdir, f"{gang}_meta", GANGS[gang][0])
    eager = {n: p.detach().numpy() for n, p in
             tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK).named_parameters()}
    assert sorted(meta) == sorted(eager)
    for k in eager:
        assert np.array_equal(meta[k], eager[k]), k


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_load_pretrained_writes_each_stage_after_meta_init(gangs, gang):
    """``Trainer.load_pretrained`` of the whole model's tree (strict) on the
    model the meta-device init made: each rank writes its stage's layers and
    the replicated params, the other stages' layers are neither extra nor
    missing, and the params put together are the tree, bit for bit."""
    outdir, _ = gangs
    loaded = _merged(outdir, f"{gang}_loaded", GANGS[gang][0])
    tree = dict(np.load(outdir / "lora_init.npz"))
    assert sorted(loaded) == sorted(tree)
    for k in tree:
        assert np.array_equal(loaded[k], tree[k]), k


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_pipe_peers_feed_the_same_rows(gangs, gang):
    """Each rank feeds the rows of its coordinate on ``data × fsdp``: the
    ranks of a pipe group (and of a tensor group) the same rows, and the
    batch shards together the global batch's rows."""
    outdir, _ = gangs
    n = GANGS[gang][0]
    ranks = [_rank(outdir, gang, r) for r in range(n)]
    mesh = tmesh.Mesh(ranks[0]["mesh"])
    by_shard: dict = {}
    for r, rec in enumerate(ranks):
        by_shard.setdefault(mesh.batch_index(r), []).append(rec["rows"])
    for rows in by_shard.values():
        assert all(x == rows[0] for x in rows)
    assert len(by_shard) == mesh.shape["data"] * mesh.shape["fsdp"]
    everything = sorted(tuple(x) for rows in by_shard.values() for x in rows[0])
    whole = next(host_batches(_dataset(), B))["input_ids"].tolist()
    assert everything == sorted(tuple(x) for x in whole)


@pytest.fixture(scope="module")
def one_rank_flops():
    """One process's measured FLOPs of a step on the whole batch."""
    out = {}
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        for name, lora in (("lora", True), ("full", False)):
            model = tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK if lora else 0)
            kw = dict(trainable=tllama.lora_trainable) if lora else {}
            trainer = Trainer(spark, model, losses.causal_lm, _tx(optim, lora), **kw)
            out[name] = trainer.measured_cost(_batch())
    return out


@pytest.mark.parametrize("gang", ["pipe2", "pipe_tensor"])
@pytest.mark.parametrize("name", ["lora", "full"])
def test_measured_flops_are_one_devices(gangs, one_rank_flops, gang, name):
    """A pipe gang's measured FLOPs of a step are one process's on the same
    batch: the stages' layers summed, the head that every pipe peer
    repeats counted once (and the tensor peers' adapter products once)."""
    outdir, _ = gangs
    for r in range(GANGS[gang][0]):
        assert _rank(outdir, gang, r)["flops"][name] == one_rank_flops[name] > 0


def test_eval_inside_fit_at_data_by_pipe(gangs):
    """``fit(eval_every=5)`` at ``data=2 × pipe=2``: every rank's evaluation
    is the same, one process's ``evaluate`` of the final params (the loss
    group's sums: the pipe peers' rows counted once)."""
    outdir, _ = gangs
    evals = [_rank(outdir, "data_pipe", r)["evals"] for r in range(4)]
    assert all(e == evals[0] for e in evals) and len(evals[0]) == 1
    final = _merged(outdir, "data_pipe_full_final", 4)
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(final, False), losses.causal_lm,
                          _tx(optim, False))
        want = trainer.evaluate(_dataset(6, seed=5), batch_size=B)
    assert set(want) == set(evals[0][0])
    np.testing.assert_allclose(evals[0][0]["loss"], want["loss"], rtol=1e-5)


def test_resume_at_pipe2_is_bitwise(gangs):
    """The full fine-tune at ``pipe=2`` restored from its own checkpoint at
    step 2 and run to 4 is the straight run bitwise."""
    outdir, _ = gangs
    straight = _merged(outdir, "ckpt_straight", 2)
    resumed = _merged(outdir, "ckpt_resumed", 2)
    assert sorted(straight) == sorted(resumed)
    for k in straight:
        assert np.array_equal(straight[k], resumed[k]), k


@pytest.mark.parametrize("where", ["one", "fsdp", "fsdp_pipe"])
def test_pipe2_checkpoint_restores_bitwise_elsewhere(gangs, where):
    """The step ``pipe=2`` wrote holds the whole state in the format of
    ``pipe`` 1: it restores bitwise into one process (params and every
    optimizer tensor), at ``fsdp=2`` and at ``fsdp=2 × pipe=2``."""
    outdir, _ = gangs
    straight = _merged(outdir, "ckpt_straight", 2)
    if where == "one":
        with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() \
                as spark:
            trainer = Trainer(spark, _port_model(dict(np.load(outdir / "full_init.npz")),
                                                 False),
                              losses.causal_lm, _tx(optim, False),
                              checkpointer=Checkpointer(outdir / "ckpt"))
            state, data_state = trainer.restore()
            assert state.step == 4 and data_state["examples_seen"] == 4 * B
            got = {k: p.detach().numpy() for k, p in state.params.items()}
            moments = [t for t in _tensor_leaves(state.opt_state) if t.dim()]
            assert len(moments) == 2 * len(state.params)
    else:
        n = (RESTORES.get(where) or GANGS[where])[0]
        got = _merged(outdir, f"restore_{where}", n)
    assert sorted(got) == sorted(straight)
    for k in straight:
        assert np.array_equal(got[k], straight[k]), k


def _tensor_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# -- the refusals ---------------------------------------------------------------------


def test_a_pipe_gang_refuses_other_models_and_unstaged_rules(gangs):
    """On a ``pipe=2`` mesh a model with no pipelined forward raises JAX's
    ``NotImplementedError``, and Llama rules without the stage layout a
    ``ValueError`` naming ``llama_rules(cfg, pipeline=True)``."""
    outdir, _ = gangs
    for r in range(2):
        ref = _rank(outdir, "pipe2", r)["refusals"]
        assert ref["lenet"].startswith("NotImplementedError") \
            and "no pipeline-parallel forward" in ref["lenet"]
        assert ref["rules"].startswith("ValueError") and "pipeline=True" in ref["rules"]


def test_a_pipeline_refuses_the_drain_and_the_handoff(gangs):
    """The graceful drain of a pipeline raises, and a live handoff into one
    raises ``HandoffError`` (the drivers then walk back through the
    checkpoint), both naming ROADMAP Queue 1 item 11."""
    outdir, _ = gangs
    for r in range(2):
        ref = _rank(outdir, "pipe2", r)["refusals"]
        assert "Queue 1 item 11" in ref["drain"] and "Queue 1 item 11" in ref["handoff"]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(moe_experts=4), NotImplementedError, "MoE is not wired"),
    (dict(fused_head_loss=True), ValueError, "fused_head_loss is not supported"),
    (dict(num_layers=3), ValueError, "must divide by pipe 2"),
])
def test_check_pp_config_refuses_as_jax(kw, exc, match):
    """JAX's ``check_pp_config`` ladder, in its words (the port's layers are
    a ``ModuleList``, so ``scan_layers`` has no counterpart)."""
    with pytest.raises(exc, match=match):
        tllama_pp.check_pp_config(tllama.LlamaConfig.tiny(**kw), 2)


@pytest.mark.parametrize("key,match", [("attention_mask", "causal packing only"),
                                       ("segment_ids", "does not thread segment_ids")])
def test_pipelined_forward_refuses_masks_and_segments(key, match):
    """The pipelined forward refuses an attention mask and segment ids, in
    JAX's words, before it runs anything."""
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1, pipe=2).shape(2))
    fwd = tllama_pp.PipelinedForward(mesh, 2, stage_layers(4, 2, 0))
    model = tllama.llama_tiny(device="cpu")
    batch = {"input_ids": torch.zeros((2, 8), dtype=torch.long),
             key: torch.ones((2, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match=match):
        fwd.forward(model, batch)


@pytest.mark.parametrize("axes", [dict(seq=2), dict(seq=-1), dict(expert=2),
                                  dict(expert=-1), dict(seq=2, expert=2)])
def test_pipe_beside_seq_or_expert_is_refused(axes):
    """``pipe`` beside ``seq`` or ``expert`` names ROADMAP Queue 1 item 10:
    the JAX package has no tested path there (and refuses MoE under the
    pipeline)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tmesh.MeshSpec(data=1, pipe=2, **axes)


def test_pipeline_refuses_a_batch_that_does_not_divide():
    """JAX's validation: the batch must divide by the microbatches."""
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1))
    with pytest.raises(ValueError, match="must divide by microbatches 2"):
        pipeline(lambda a: a, torch.zeros(3, 4), mesh=mesh, num_microbatches=2)


@pytest.mark.parametrize("flags,match", [
    (["--pipeline", "2", "--segment-ids"], "--segment-ids is not supported with --pipeline"),
    (["--pipeline", "2", "--moe-experts", "4"], "--moe-experts is not supported with"),
    (["--fused-head-loss", "--pipeline", "2"], "--fused-head-loss is not supported with"),
])
def test_driver_refuses_as_jax(capsys, flags, match):
    """The driver's ``--pipeline`` refusals, JAX's at parse time."""
    from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as tdriver

    with pytest.raises(SystemExit) as e:
        tdriver.parse_args(["--variant", "tiny", *flags])
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_driver_pipelines(tmp_path):
    """The port's driver at ``local[4]`` with ``--pipeline 2 --microbatches
    2`` and ``--fsdp -1`` (fsdp=2 × pipe=2) on the CPU: every rank holds
    what the rule engine reckons for its stage, sends two microbatches a
    step each way, the replicas are checked, and the losses are those of
    one rank on the same batches."""
    args = [str(DRIVER), "--variant", "tiny", "--steps", "3", "--batch-size", "4",
            "--seq-len", "64", "--lora-rank", "4", "--log-every", "1",
            "--source-partitions", "2"]
    recs = {}
    for n, extra in ((4, ["--pipeline", "2", "--microbatches", "2"]), (1, [])):
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        "--workdir", str(tmp_path / str(n)), *args, *extra])
        assert res.returncode == 0, res.stderr[-4000:]
        recs[n] = json.loads([x for x in res.stdout.splitlines()
                              if x.startswith('{"train"')][-1])
    rec = recs[4]
    assert rec["mesh"]["pipe"] == 2 and rec["mesh"]["fsdp"] == 2 and rec["microbatches"] == 2
    assert rec["replicas_checked"] and rec["step"] == 3
    # a microbatch: 1 row of 64 tokens × 128 wide, f32; each way each step
    mb = 1 * 64 * 128 * 4
    for card in rec["by_rank"]:
        assert card["param_bytes"] == card["param_bytes_reckoned"]
        assert card["handoff_bytes"] == 3 * 2 * mb
        assert card["broadcast_bytes"] == (3 * 2 * mb if card["pipe_stage"] == 1 else 0)
    np.testing.assert_allclose(rec["train"]["loss"], recs[1]["train"]["loss"], rtol=1e-5)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])

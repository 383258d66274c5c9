"""Config 5 FSDP-sharded: the port's rule engine, Plans and FSDP2 lowering
against the JAX package's sharding, on the CPU.

- The rule engine: the port's ``ShardingRules.spec_for``/``add_axis_spec``
  against JAX's on the same (path, shape) pairs over JAX meshes of
  ``fsdp`` 2 and 4 (the fake CPU devices); every Llama-2 7B LoRA leaf
  placed from its shape alone (the port's model on the meta device, JAX's
  ``eval_shape``), and the bytes a card holds against JAX's reckoning:
  the one difference allowed is the norm scales, which JAX stacks over
  the layers past ``fsdp_min_size`` (sharded) and the port keeps a layer
  each (replicated).
- Plans: records and signatures are JAX's; what the port lacks raises.
- One gloo gang at ``local[2]`` (this file is its script) against the JAX
  ``Trainer`` at ``mesh.data=1, mesh.fsdp=2`` (pure fsdp is exact in the
  reference) from the same converted weights and batches: the tiny Llama
  LoRA and a full fine-tune (``trainable=None``, FSDP at
  ``fsdp_min_size=1``, through ``plan=``), 5 AdamW steps each; one reduced
  gradient against one process on the whole batch; ``eval_every``,
  ``sanitize_every``, a bitwise resume, a checkpoint written at
  ``fsdp=2`` restored at one rank; the ``inference_mode`` × FSDP2 fault
  (ROADMAP Queue 3).
- The driver at ``local[2]`` takes ``--fsdp -1`` and ``--tensor 2``, and
  refuses the pipeline axis.

f32 throughout: each tolerance is summation order, and says so."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.parallel import plan as jplan
from distributeddeeplearningspark_tpu.parallel import sharding as jsharding
from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as tdriver
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.parallel import plan as tplan
from distributeddeeplearningspark_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from distributeddeeplearningspark_tpu_torch.train.step import make_train_step
from distributeddeeplearningspark_tpu_torch.utils import sanitize

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_llama_lora.py"
RANK, B, S, STEPS = 4, 4, 32, 5
# logged losses over 5 f32 AdamW steps, the port's sums in torch's order
# against XLA's (test_torch_llama.py's tolerance)
RTOL = 1e-4
# each param's change over those steps, |Δ_port − Δ_jax| / |Δ_jax| per
# tensor: Adam takes steps of about ±lr wherever a gradient is near 0, so
# summation order moves single elements by up to ~1e-4 (an embedding row
# the batch barely touches) while whole tensors read at most 3.6e-5
PARAM_RTOL = 1e-3
# one reduced gradient against one process's on the whole batch: the
# halves' sums added, per tensor against its largest element
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- inputs both sides build ----------------------------------------------------


def _examples(n: int = 16, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, S).astype(np.int32),
             "loss_mask": np.ones(S, np.float32)} for _ in range(n)]


def _tcfg(lora: bool):
    return tllama.LlamaConfig.tiny(lora_rank=RANK if lora else 0)


def _tx(mod, lora: bool):
    """The driver's optimizer: AdamW under the clip, masked for LoRA."""
    tx = mod.with_grad_clip(mod.adamw(mod.warmup_cosine(1e-2, 1, STEPS)), 1.0)
    return mod.masked(tx, jllama.lora_trainable if mod is not optim
                      else tllama.lora_trainable) if lora else tx


def _full_rules(mod):
    """The full fine-tune's rules: auto-FSDP on every divisible leaf."""
    return mod.ShardingRules(fsdp=True, fsdp_min_size=1)


def _port_model(init: dict, lora: bool) -> tllama.LlamaForCausalLM:
    model = tllama.LlamaForCausalLM(_tcfg(lora), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


# -- the gang's side --------------------------------------------------------------


def _capture_tx(store: list):
    def update(updates, state, params):
        store.extend(u.detach().clone() for u in updates)
        return [torch.zeros_like(u) for u in updates], state
    return optim.GradientTransformation(lambda params: (), update)


def _full_params(model) -> dict:
    """Every param whole (sharded ones gathered: every rank calls it)."""
    return {n: tsharding.full(p.detach()).numpy() for n, p in model.named_parameters()}


def _layout(trainer) -> dict:
    """Each param's global and local shape, and the dim the rules shard."""
    return {n: dict(shape=list(p.shape), local=list(tsharding.local(p).shape),
                    dim=trainer.shard_dims.get(n))
            for n, p in trainer.model.named_parameters()}


def _replicated(model) -> dict:
    return {n: p.detach().numpy() for n, p in model.named_parameters()
            if not tsharding.is_sharded(p)}


def _run(spark, outdir: Path, name: str, lora: bool, evals: list | None = None,
         **fit_kw) -> Trainer:
    """5 steps of the LoRA fine-tune (``rules=llama_rules``) or the full
    one (``plan=`` FSDP at min size 1) from the JAX init; every rank
    writes its layout, its replicated params and the losses, rank 0 the
    final params whole. ``evals`` receives what each evaluation inside
    ``fit`` returned, and rank 0 writes the params the last one saw."""
    rank = spark.rank
    init = dict(np.load(outdir / f"{name}_init.npz"))
    model = _port_model(init, lora)
    if lora:
        trainer = Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                          rules=tllama.llama_rules(model.cfg),
                          trainable=tllama.lora_trainable)
    else:
        plan = tplan.Plan(name="full", rules=_full_rules(tsharding))
        trainer = Trainer(spark, model, losses.causal_lm, _tx(optim, False), plan=plan)
    logged: list = []
    callbacks = [lambda s, m: logged.append(m["loss"])]
    if evals is not None:
        orig = trainer.evaluate

        def recorded(ds, *, batch_size):
            evals.append(orig(ds, batch_size=batch_size))
            return evals[-1]

        def seen(step, _metrics):  # the params an evaluation at step 4 sees
            if step == STEPS - 1:
                params = _full_params(trainer.model)
                if rank == 0:
                    np.savez(outdir / "eval_params.npz", **params)

        trainer.evaluate = recorded
        callbacks.append(seen)
    trainer.fit(PartitionedDataset.parallelize(_examples(), 2).repeat(), batch_size=B,
                steps=STEPS, log_every=1, callbacks=callbacks, **fit_kw)
    final = _full_params(trainer.model)
    np.savez(outdir / f"{name}_replicated_{rank}.npz", **_replicated(trainer.model))
    if rank == 0:
        np.savez(outdir / f"{name}_final.npz", **final)
    (outdir / f"{name}_{rank}.json").write_text(json.dumps(dict(
        losses=logged, layout=_layout(trainer))))
    return trainer


def _grads(spark, outdir: Path) -> None:
    """One step's gradient at half the batch a rank, every param trainable
    under ``llama_rules`` (sharded and replicated leaves both), from the
    JAX LoRA run's trained weights (nonzero B): each rank's local
    gradients, their dims and the step's grad norm."""
    model = _port_model(dict(np.load(outdir / "lora_jax_final.npz")), True)
    dims = tsharding.fully_shard_model(model, tllama.llama_rules(model.cfg), spark.mesh)
    store: list = []
    named = dict(model.named_parameters())
    state = TrainState(step=0, params=named, opt_state=(),
                       generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, _capture_tx(store), losses.causal_lm, distributed=True)
    batch = _grad_batch()
    rows = slice(2 * spark.rank, 2 * spark.rank + 2)
    _, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    np.savez(outdir / f"grads_{spark.rank}.npz",
             **{n: g.numpy() for n, g in zip(named, store)})
    (outdir / f"grads_{spark.rank}.json").write_text(json.dumps(dict(
        dims=dims, grad_norm=float(metrics["grad_norm"]))))


def _grad_batch() -> dict:
    return {k: np.stack([e[k] for e in _examples(4, seed=9)]) for k in ("input_ids",
                                                                      "loss_mask")}


def _inference_mode_then_train(spark) -> dict:
    """The ROADMAP Queue 3 fault: a forward of a freshly sharded model under
    ``inference_mode`` (an evaluation before any training), then a
    training step; and the same with ``no_grad``. What each raised, None
    where nothing did."""
    out = {}
    batch = {k: torch.from_numpy(v[:2]) for k, v in _grad_batch().items()}
    for mode, ctx in (("inference_mode", torch.inference_mode), ("no_grad", torch.no_grad)):
        model = tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK)
        tsharding.fully_shard_model(model, tllama.llama_rules(model.cfg), spark.mesh)
        try:
            with ctx():
                model(batch)
            losses.causal_lm(model(batch), batch)[0].backward()
            out[mode] = None
        except RuntimeError as e:
            out[mode] = str(e)[:300]
    return out


def _resume(spark, outdir: Path) -> None:
    """The full fine-tune (sharded params and moments): 4 steps straight
    with a checkpoint every 2, then a new trainer restored at step 2 run
    to 4; rank 0 writes both runs' final params."""
    init = dict(np.load(outdir / "full_init.npz"))
    finals = {}
    for run in ("straight", "resumed"):
        ckpt = Checkpointer(outdir / "ckpt", async_save=run == "straight")
        trainer = Trainer(spark, _port_model(init, False), losses.causal_lm,
                          _tx(optim, False), rules=_full_rules(tsharding),
                          checkpointer=ckpt)
        data_state = None
        if run == "resumed":
            _, data_state = trainer.restore(step=2)
        trainer.fit(PartitionedDataset.parallelize(_examples(), 2).repeat(),
                    batch_size=B, steps=4, log_every=2,
                    checkpoint_every=2 if run == "straight" else None,
                    data_state=data_state)
        ckpt.close()
        finals[run] = _full_params(trainer.model)
    if spark.rank == 0:
        for run, params in finals.items():
            np.savez(outdir / f"resume_{run}.npz", **params)


def _worker(outdir: Path) -> None:
    """One rank of the gang: every scenario, in order."""
    spark = (Session.builder.appName("fsdp").config("mesh.data", 1)
             .config("mesh.fsdp", -1).getOrCreate())
    rank = spark.rank
    assert spark.world_size == 2 and spark.backend == "gloo"
    out: dict = dict(mesh=spark.mesh.shape, parallelism=spark.default_parallelism)

    _run(spark, outdir, "lora", True)
    evals: list = []  # at steps 2 and 4
    _run(spark, outdir, "full", False, evals, sanitize_every=1, eval_every=2,
         eval_dataset=PartitionedDataset.parallelize(_examples(6, seed=5), 2))
    out["evals"] = evals

    # a replicated param edited on one rank is caught; a shard is not
    caught = {}
    for target in ("lora_", "mlp.gate.weight"):
        model = _port_model(dict(np.load(outdir / "lora_init.npz")), True)
        t = Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                    rules=tllama.llama_rules(model.cfg), trainable=tllama.lora_trainable)

        def plant(step, _metrics, t=t, target=target):
            if step == 2 and rank == 1:
                name = next(n for n in t.state.params if target in n)
                with torch.no_grad():
                    tsharding.local(t.state.params[name]).add_(1e-3)

        try:
            t.fit(PartitionedDataset.parallelize(_examples(), 2).repeat(), batch_size=B,
                  steps=4, log_every=1, sanitize_every=1, callbacks=[plant])
            caught[target] = None
        except sanitize.DesyncError as e:
            caught[target] = dict(step=t.state.step, error=str(e)[:200])
    out["desync"] = caught

    # imported weights overlaid on a sharded model land in each rank's shard
    trained = dict(np.load(outdir / "lora_jax_final.npz"))
    model = _port_model(dict(np.load(outdir / "lora_init.npz")), True)
    t = Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                rules=tllama.llama_rules(model.cfg), trainable=tllama.lora_trainable)
    t.init()
    t.load_pretrained(trained, strict=True)
    loaded = _full_params(t.model)
    out["load_pretrained_exact"] = sorted(loaded) == sorted(trained) and all(
        np.array_equal(loaded[k], trained[k]) for k in trained)
    out["load_pretrained_sharded"] = len(t.shard_dims)

    _grads(spark, outdir)
    out["inference_mode"] = _inference_mode_then_train(spark)
    _resume(spark, outdir)
    (outdir / f"rank{rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the JAX side -------------------------------------------------------------------


def _jax_run(outdir: Path, name: str, lora: bool) -> dict:
    """The JAX Trainer at ``mesh.data=1, mesh.fsdp=2``: the init and final
    params as port state dicts, and the logged losses."""
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim

    def port(trainer) -> dict:
        tree = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
        return {k: v.numpy() for k, v in tllama_io.params_from_flax(tree, _tcfg(lora)).items()}

    jspark = (JSession.builder.master("local[2]").appName("j").config("mesh.data", 1)
              .config("mesh.fsdp", -1).getOrCreate())
    assert dict(jspark.mesh.shape)["fsdp"] == 2
    jcfg = jllama.LlamaConfig.tiny(lora_rank=RANK if lora else 0)
    kw = (dict(rules=jllama.llama_rules(jcfg), trainable=jllama.lora_trainable) if lora
          else dict(rules=_full_rules(jsharding)))
    jt = JTrainer(jspark, jllama.LlamaForCausalLM(jcfg), jlosses.causal_lm,
                  _tx(joptim, lora), **kw)
    jds = JDataset.parallelize(_examples(), num_slices=2)
    jt.init(jt._sample_batch(jds, B))
    init = port(jt)
    logged: list = []
    jt.fit(jds.repeat(), batch_size=B, steps=STEPS, log_every=1,
           callbacks=[lambda s, m: logged.append(float(m["loss"]))])
    final = port(jt)
    jspark.stop()
    np.savez(outdir / f"{name}_init.npz", **init)
    np.savez(outdir / f"{name}_jax_final.npz", **final)
    return dict(init=init, losses=logged, final=final)


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    """The JAX runs (their init params seed the gang), then the gang:
    (outdir, {"lora": JAX run, "full": JAX run})."""
    outdir = tmp_path_factory.mktemp("gang_fsdp")
    jruns = {name: _jax_run(outdir, name, name == "lora") for name in ("lora", "full")}
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return outdir, jruns


def _rank(outdir, r, name="rank") -> dict:
    return json.loads((outdir / f"{name}{r}.json").read_text())


def _npz(path) -> dict:
    return dict(np.load(path))


# -- the rule engine ----------------------------------------------------------------


def _jax_mesh(fsdp: int):
    return JMeshSpec(data=1, fsdp=fsdp).build(jax.devices()[:fsdp])


PAIRS = [("layers/0/attention/wq/weight", (128, 128)), ("a/b", (6, 4)),
         ("a/b", (8, 3)), ("a/b", (3, 5)), ("x", (4096,)), ("x", (4, 4096, 32, 128)),
         ("emb", (32000, 4096)), ("odd", (7, 9, 11)), ("lora_a", (4096, 16)),
         ("scalar1", (1,)), ("big", (2, 2 ** 14))]
RULE_SETS = {
    "replicated": lambda m: (m.REPLICATED, jsharding.REPLICATED),
    "fsdp": lambda m: (m.FSDP, jsharding.FSDP),
    "fsdp_min_1": lambda m: (m.ShardingRules(fsdp=True, fsdp_min_size=1),
                             jsharding.ShardingRules(fsdp=True, fsdp_min_size=1)),
    "explicit": lambda m: (
        m.ShardingRules(rules=((r"wq", m.P("tensor", None)), (r"emb", m.P(None, "fsdp"))),
                        fsdp=True, fsdp_min_size=16, fsdp_exclude=(r"lora_",)),
        jsharding.ShardingRules(rules=((r"wq", jax.sharding.PartitionSpec("tensor", None)),
                                       (r"emb", jax.sharding.PartitionSpec(None, "fsdp"))),
                                fsdp=True, fsdp_min_size=16, fsdp_exclude=(r"lora_",))),
}


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("rules", sorted(RULE_SETS))
def test_rule_engine_places_as_jax(fsdp, rules):
    """``spec_for`` on every (path, shape) pair, over a JAX mesh, and
    ``add_axis_spec`` over two axes at once: the port's specs are JAX's."""
    mesh = _jax_mesh(fsdp)
    port, jax_rules = RULE_SETS[rules](tsharding)
    for path, shape in PAIRS:
        got = port.spec_for(path, shape, mesh)
        want = jax_rules.spec_for(path, shape, mesh)
        assert tuple(got) == tuple(want), (path, shape, got, want)
    two = JMeshSpec(data=2, fsdp=fsdp).build(jax.devices()[:2 * fsdp])
    for path, shape in PAIRS:
        for axes in (("data", "fsdp"), ("fsdp",)):
            got = tsharding.add_axis_spec(tsharding.P(), shape, two, axes, 1)
            want = jsharding.add_axis_spec(jax.sharding.PartitionSpec(), shape, two,
                                           axes, 1)
            assert tuple(got) == tuple(want), (shape, axes, got, want)


def _kind(path: str) -> str:
    """A leaf's kind on either side: ``attention/wq``, ``attention/wq/lora_a``,
    ``mlp_norm/scale``, ``token_embed``... (layer indices, the stacked
    ``layers`` prefix and the weight's own name dropped)."""
    parts = [p for p in path.split("/") if not p.isdigit() and p != "layers"]
    if parts[-1] in ("weight", "kernel", "embedding"):
        parts = parts[:-1]
    if parts[-1] == "base":
        parts = parts[:-1]
    return "/".join(parts)


@pytest.fixture(scope="module")
def shapes_7b():
    """The Llama-2 7B LoRA (rank 16) leaves' shapes and dtypes: the port's
    from a model on the meta device, JAX's from ``eval_shape``."""
    tcfg = tllama.LlamaConfig.llama2_7b(lora_rank=16)
    model = tllama.LlamaForCausalLM(tcfg, device="meta")
    port = {n: (tuple(p.shape), p.element_size()) for n, p in model.named_parameters()}
    jcfg = jllama.LlamaConfig.llama2_7b(lora_rank=16)
    tree = jax.eval_shape(jllama.LlamaForCausalLM(jcfg).init, jax.random.PRNGKey(0),
                          {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    jx = {jsharding.path_str(p): (tuple(v.shape), np.dtype(v.dtype).itemsize)
          for p, v in leaves}
    return tcfg, jcfg, tree, port, jx


@pytest.mark.parametrize("fsdp", [2, 4])
def test_llama_7b_bytes_per_card_match_jax(shapes_7b, fsdp):
    """Each kind of 7B leaf is sharded on both sides or on neither, but the
    norm scales (JAX: [32, 4096] stacked, sharded; the port: [4096] a
    layer, replicated); the port's bytes a card are JAX's ``tree_specs``
    reckoning plus exactly those scales' unsharded part."""
    tcfg, jcfg, tree, port, jx = shapes_7b
    mesh = _jax_mesh(fsdp)
    tspecs = tllama.llama_rules(tcfg).tree_specs({n: s for n, (s, _) in port.items()}, mesh)
    jspecs = jax.tree_util.tree_flatten_with_path(
        jllama.llama_rules(jcfg).tree_specs(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    jsharded = {jsharding.path_str(p): any(
        e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e) for e in s) for p, s in jspecs}
    kinds_t = {}
    for n, spec in tspecs.items():
        kinds_t.setdefault(_kind(tsharding.path_str(n)), set()).add(
            tsharding.fsdp_dim(spec) is not None)
    kinds_j = {}
    for p, sharded in jsharded.items():
        kinds_j.setdefault(_kind(p), set()).add(sharded)
    norms = {"attention_norm/scale", "mlp_norm/scale"}
    assert set(kinds_t) == set(kinds_j)
    for kind in kinds_t:
        want = {False} if kind in norms else kinds_j[kind]
        assert kinds_t[kind] == want, kind
    assert kinds_j["attention_norm/scale"] == {True}
    assert kinds_t["attention/wq"] == {True} and kinds_t["attention/wq/lora_a"] == {False}

    def card_bytes(specs_sharded, sizes):
        return sum(int(np.prod(sizes[n][0])) * sizes[n][1] // (fsdp if sh else 1)
                   for n, sh in specs_sharded.items())

    got = tsharding.bytes_per_card({n: s for n, (s, _) in port.items()},
                                   {n: b for n, (_, b) in port.items()},
                                   tllama.llama_rules(tcfg), mesh)
    assert got == card_bytes({n: tsharding.fsdp_dim(s) is not None
                              for n, s in tspecs.items()}, port)
    want = card_bytes(jsharded, jx)
    norm_bytes = sum(int(np.prod(s)) * b for p, (s, b) in jx.items() if _kind(p) in norms)
    assert norm_bytes == 2 * 32 * 4096 * 4
    assert got - want == norm_bytes - norm_bytes // fsdp
    # the base (6.74 B bf16 params) over the cards, plus the replicated rest
    base = sum(int(np.prod(s)) * b for n, (s, b) in port.items()
               if not tllama.lora_trainable(n) and "norm" not in n)
    assert abs(base / 2 - 6.74e9) < 0.01e9
    assert got == base // fsdp + sum(int(np.prod(s)) * b for n, (s, b) in port.items()
                                     if tllama.lora_trainable(n) or "norm" in n)


# -- meshes and plans ----------------------------------------------------------


@pytest.mark.parametrize("master,conf,want", [
    ("local[2]", {"mesh.data": "1", "mesh.fsdp": "-1"}, (1, 2)),
    ("local[4]", {"mesh.data": "1", "mesh.fsdp": "-1"}, (1, 4)),
    ("local[1]", {"mesh.data": "1", "mesh.fsdp": "-1"}, (1, 1)),
    ("local[4]", {"mesh.fsdp": "-1"}, (4, 1)),
    ("local[1]", {"mesh.fsdp": "2"}, (1, 2)),
])
def test_fsdp_mesh_parses_as_jax(master, conf, want):
    """``mesh.fsdp`` (``-1`` too) as the JAX Session reads it: the devices a
    master asks for and the axes' sizes over them."""
    from distributeddeeplearningspark_tpu.session import _parse_master

    devices, jspec = _parse_master(master, conf)
    n = tmesh.devices_from_conf(master, conf)
    assert n == len(devices)
    sizes = tmesh.spec_from_conf(master, conf).axis_sizes(n)
    assert sizes == jspec.axis_sizes(n) and sizes[:2] == want


def test_what_the_mesh_cannot_shard_raises():
    """The mesh refuses the pipe axis beside seq and beside expert (ROADMAP
    Queue 1 item 10; every axis is ported, pipe beside data, fsdp and
    tensor), and the lowering what it cannot place, before it needs a
    group: an axis other than fsdp, expert and tensor, two axes on one dim,
    a tensor or an expert dim that does not divide. Heads that do not
    divide by tensor raise in the gang (``test_torch_tp.py``)."""
    assert tmesh.MeshSpec(data=2, fsdp=2, tensor=2, pipe=2).axis_sizes(16)[2] == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tmesh.MeshSpec(data=2, fsdp=2, tensor=2, pipe=2, expert=2)
    for extra in ({}, {"expert": 2}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            tmesh.MeshSpec(data=2, seq=2, pipe=2, **extra)
    assert tmesh.MeshSpec(data=2, fsdp=2, expert=2).axis_sizes(8)[3] == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tmesh.spec_from_conf("local[2]", {"mesh.seq": "2", "mesh.pipe": "2"})
    assert tmesh.MeshSpec(data=-1, fsdp=2).axis_sizes(8)[:2] == (4, 2)
    with pytest.raises(ValueError, match="at most one"):
        tmesh.MeshSpec(data=-1, fsdp=-1)
    model = tllama.llama_tiny(device="cpu", lora_rank=RANK)
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=2, fsdp=2, tensor=2).shape(8))
    for rules, err, what in (
            (tsharding.ShardingRules(rules=((r"wq/weight", tsharding.P("data", None)),)),
             NotImplementedError, "fsdp, expert and tensor entries only"),
            (tsharding.ShardingRules(rules=((r"wq/weight", tsharding.P(("fsdp", "tensor"),
                                                                       None)),)),
             NotImplementedError, "one axis a dim"),
            (tsharding.ShardingRules(rules=((r"lora_a", tsharding.P(None, "tensor")),)),
             ValueError, "does not divide by tensor=2")):
        with pytest.raises(err, match=what):
            tsharding.fully_shard_model(tllama.llama_tiny(device="cpu", lora_rank=1),
                                        rules, mesh)
    # three experts over expert=2
    moe = tllama.llama_tiny(device="cpu", moe_experts=3)
    with pytest.raises(ValueError, match="does not divide by expert=2"):
        tsharding.fully_shard_model(moe, tllama.llama_rules(moe.cfg), tmesh.Mesh(
            tmesh.MeshSpec(data=1, fsdp=2, expert=2).shape(4)))
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        tsharding.fully_shard_model(model, tllama.llama_rules(model.cfg), mesh)


def test_an_fsdp_mesh_without_a_group_never_replicates(monkeypatch):
    """A session cannot make an fsdp mesh without the launcher's gang, and
    the lowering refuses a mesh with no ``DeviceMesh``."""
    for k in ("DLS_COORDINATOR", "DLS_NUM_PROCESSES", "DLS_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="cli"):
        Session.builder.master("local[2]").config("mesh.data", 1).config(
            "mesh.fsdp", -1).config(DEVICE_CONF, "cpu").getOrCreate()
    model = tllama.llama_tiny(device="cpu", lora_rank=RANK)
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1, fsdp=2).shape(2))
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        tsharding.fully_shard_model(model, tllama.llama_rules(model.cfg), mesh)
    # at fsdp 1 nothing is sharded and nothing is called
    assert tsharding.fully_shard_model(
        model, tllama.llama_rules(model.cfg), tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1))) == {}


@pytest.mark.parametrize("name", ["DP", "FSDP_PLAN"])
def test_plan_records_and_signatures_are_jax(name, tmp_path):
    """The canned plans' records and signatures are JAX's; a plan JAX saves
    loads into the port unchanged, its rules placing as JAX's."""
    jp, tp = getattr(jplan, name), getattr(tplan, name)
    assert tp.to_record() == jp.to_record() and tp.signature() == jp.signature()
    assert tp.describe() == jp.describe() and tp.logical_axes() == jp.logical_axes()
    rules = jllama.llama_rules(jllama.LlamaConfig.tiny())
    saved = jplan.Plan(name="custom", rules=rules, description="d",
                       model_hints=(("attention_impl", "xla"),))
    saved.save(str(tmp_path / "p.json"))
    loaded = tplan.Plan.load(str(tmp_path / "p.json"))
    assert loaded.to_record() == saved.to_record()
    assert loaded.signature() == saved.signature()
    mesh = _jax_mesh(2)
    for path, shape in PAIRS:
        assert tuple(loaded.rules.spec_for(path, shape, mesh)) == tuple(
            saved.rules.spec_for(path, shape, mesh))
    assert tplan.plan_for_rules(tsharding.FSDP).to_record() == \
        jplan.plan_for_rules(jsharding.FSDP).to_record()


@pytest.mark.parametrize("kw,item", [
    (dict(seq_axis="seq", zero_axes=("tensor",)), "not replica"),
    (dict(zero_axes=("seq",)), "not replica"), (dict(style="shard_map"), "Queue 1 item 5")])
def test_plans_the_port_lacks_raise(kw, item):
    """style="shard_map" raises naming its ROADMAP item, and zero axes
    outside the batch axes as JAX's ``validate`` does (ZeRO is ported:
    ``test_torch_zero.py``), also beside a seq_axis (context parallelism is
    ported), from ``validate`` and from the Trainer; so does an axis the
    mesh lacks."""
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1))
    plan = tplan.Plan(name="x", **kw)
    with pytest.raises(tplan.PlanValidationError, match=item):
        plan.validate(mesh)
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        with pytest.raises(tplan.PlanValidationError, match=item):
            Trainer(spark, tllama.llama_tiny(device="cpu"), losses.causal_lm,
                    optim.adamw(1e-3), plan=plan)
    with pytest.raises(tplan.PlanValidationError, match="do not exist"):
        tplan.Plan(name="y", batch_axes=("rows",)).validate(mesh)


# -- the gang against JAX -----------------------------------------------------------


@pytest.mark.parametrize("name", ["lora", "full"])
def test_fsdp_gang_matches_jax_step_for_step(gang, name):
    """The tiny LoRA (``llama_rules``) and the full fine-tune (FSDP at min
    size 1, through ``plan=``) at ``fsdp=2``: every logged loss and the
    final params are JAX's at ``mesh.fsdp=2``; every rank logged the same."""
    outdir, jruns = gang
    jrun = jruns[name]
    got = [_rank(outdir, r, f"{name}_")["losses"] for r in (0, 1)]
    assert got[0] == got[1] and len(got[0]) == STEPS
    np.testing.assert_allclose(got[0], jrun["losses"], rtol=RTOL)
    final = _npz(outdir / f"{name}_final.npz")
    assert sorted(final) == sorted(jrun["final"])
    for k, v in final.items():
        change = np.linalg.norm(jrun["final"][k] - jrun["init"][k])
        assert np.linalg.norm(v - jrun["final"][k]) <= PARAM_RTOL * change, k
    moved = [k for k in final if not np.array_equal(final[k], jrun["init"][k])]
    if name == "lora":
        assert sorted(moved) == sorted(k for k in final if tllama.lora_trainable(k))
    else:
        assert len(moved) == len(final)


@pytest.mark.parametrize("name", ["lora", "full"])
def test_sharded_leaves_hold_half_their_rows_a_rank(gang, name):
    """Every leaf the rules shard holds half of its sharded dim on each
    rank, the other dims whole; the replicated ones are whole and equal
    across the ranks."""
    outdir, _ = gang
    layouts = [_rank(outdir, r, f"{name}_")["layout"] for r in (0, 1)]
    assert layouts[0] == layouts[1]
    sharded = {n: v for n, v in layouts[0].items() if v["dim"] is not None}
    assert sharded
    for n, v in layouts[0].items():
        want = list(v["shape"])
        if v["dim"] is not None:
            want[v["dim"]] //= 2
        assert v["local"] == want, n
    if name == "lora":  # the base's large leaves; adapters, norms and wk/wv whole
        assert all(not tllama.lora_trainable(n) and "norm" not in n for n in sharded)
        assert any("wq.weight" in n for n in sharded)
        assert not any("wk.weight" in n for n in sharded)
    reps = [_npz(outdir / f"{name}_replicated_{r}.npz") for r in (0, 1)]
    assert sorted(reps[0]) == sorted(n for n, v in layouts[0].items() if v["dim"] is None)
    for k in reps[0]:
        assert np.array_equal(reps[0][k], reps[1][k]), k


def test_reduced_gradient_is_the_whole_batch_gradient(gang):
    """One step at half the batch a rank, every param trainable: the
    sharded gradients (reduce-scattered by FSDP2) put together, and the
    replicated ones (all-reduced), are one process's on the whole batch,
    and so is the step's grad norm. An averaged reduce-scatter would give
    the sharded ones half."""
    outdir, _ = gang
    meta = [_rank(outdir, r, "grads_") for r in (0, 1)]
    halves = [_npz(outdir / f"grads_{r}.npz") for r in (0, 1)]
    model = _port_model(_npz(outdir / "lora_jax_final.npz"), True)
    store: list = []
    named = dict(model.named_parameters())
    step = make_train_step(model, _capture_tx(store), losses.causal_lm)
    _, metrics = step(TrainState(step=0, params=named, opt_state=(),
                                 generator=torch.Generator().manual_seed(0)),
                      {k: torch.from_numpy(v) for k, v in _grad_batch().items()})
    whole = {n: g.numpy() for n, g in zip(named, store)}
    dims = meta[0]["dims"]
    assert dims == meta[1]["dims"] and dims and set(whole) - set(dims)
    for n, want in whole.items():
        got = (np.concatenate([h[n] for h in halves], axis=dims[n]) if n in dims
               else halves[0][n])
        if n not in dims:
            assert np.array_equal(halves[0][n], halves[1][n]), n
        scale = float(np.abs(want).max())
        assert scale > 0, n
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale, err_msg=n)
    for m in meta:
        np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)


def test_eval_and_sanitize_inside_fit_under_fsdp(gang):
    """``fit(eval_every=2, sanitize_every=1)`` on the sharded full
    fine-tune (whose losses and final params are JAX's, above): each
    evaluation is the same on both ranks, and the one at step 4 is one
    process's ``evaluate`` of the params after step 4."""
    outdir, _ = gang
    evals = [_rank(outdir, r)["evals"] for r in (0, 1)]
    assert evals[0] == evals[1] and len(evals[0]) == 2  # steps 2 and 4
    assert evals[0][0]["loss"] != evals[0][1]["loss"]
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(_npz(outdir / "eval_params.npz"), False),
                          losses.causal_lm, _tx(optim, False))
        want = trainer.evaluate(PartitionedDataset.parallelize(_examples(6, seed=5), 2),
                                batch_size=B)
    # the loss: a weighted mean over the batches, exact in any split (the
    # perplexity, a mean of each batch's exp, is not)
    assert set(want) == set(evals[0][-1])
    np.testing.assert_allclose(evals[0][-1]["loss"], want["loss"], rtol=1e-5)


def test_sanitize_compares_replicated_leaves_only(gang):
    """A LoRA adapter moved on rank 1 is caught at the next step on both
    ranks; a shard moved on rank 1 is not a desync (shards differ by
    design)."""
    outdir, _ = gang
    for r in (0, 1):
        caught = _rank(outdir, r)["desync"]
        assert caught["lora_"] is not None and caught["lora_"]["step"] == 3
        assert caught["mlp.gate.weight"] is None


def test_inference_mode_and_fsdp2_do_not_mix(gang):
    """ROADMAP Queue 3: a sharded model's forward under ``inference_mode``
    before it has trained raises on inference tensors (FSDP2 gathers its
    params into tensors made in inference mode); with ``no_grad`` the
    forward and the training step after it run. So the port's evaluate
    and predict run under ``no_grad``."""
    outdir, _ = gang
    for r in (0, 1):
        seen = _rank(outdir, r)["inference_mode"]
        assert seen["no_grad"] is None
        assert seen["inference_mode"] and "nference tensor" in seen["inference_mode"]


def test_load_pretrained_writes_each_rank_shard(gang):
    """``Trainer.load_pretrained`` on the sharded LoRA model (strict): the
    params gathered back are the imported ones, bit for bit."""
    outdir, _ = gang
    for r in (0, 1):
        seen = _rank(outdir, r)
        assert seen["load_pretrained_exact"] and seen["load_pretrained_sharded"] > 0


def test_resume_is_bitwise_and_restores_at_one_rank(gang):
    """The sharded full fine-tune restored at step 2 and run to 4 is the
    straight run bitwise; the checkpoint written at fsdp=2 restores into
    one unsharded process with the same params and optimizer state."""
    outdir, _ = gang
    straight, resumed = (_npz(outdir / f"resume_{r}.npz") for r in ("straight", "resumed"))
    assert sorted(straight) == sorted(resumed)
    for k in straight:
        assert np.array_equal(straight[k], resumed[k]), k
    init = _npz(outdir / "full_init.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(init, False), losses.causal_lm,
                          _tx(optim, False), rules=_full_rules(tsharding),
                          checkpointer=Checkpointer(outdir / "ckpt"))
        assert trainer.shard_dims == {}
        state, data_state = trainer.restore()
        assert state.step == 4 and data_state["examples_seen"] == 4 * B
        for k, p in state.params.items():
            assert np.array_equal(p.detach().numpy(), straight[k]), k
        moments = [t for t in _tensor_leaves(state.opt_state) if t.dim()]
        assert len(moments) == 2 * len(state.params)
        assert all(m.shape == state.params[n].shape for m, n in
                   zip(moments, list(state.params) * 2))


def _tensor_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# -- the driver ---------------------------------------------------------------------


def test_driver_shards_over_every_rank_by_default(tmp_path):
    """The port's driver at ``local[2]`` on the CPU with its default
    ``--fsdp -1``: the JAX driver's mesh (``data=1, fsdp=2``), the base's
    large leaves sharded, each rank holding what the rule engine reckons
    (less than the whole), the replicated params checked, every rank's
    losses the same."""
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(tmp_path), str(DRIVER), "--variant", "tiny",
                    "--steps", "3", "--batch-size", "4", "--seq-len", "64",
                    "--lora-rank", "4", "--log-every", "1"])
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads([x for x in res.stdout.splitlines() if x.startswith('{"train"')][-1])
    assert rec["world_size"] == 2 and rec["mesh"]["data"] == 1 and rec["mesh"]["fsdp"] == 2
    assert rec["sharded_params"] > 0 and rec["replicas_checked"] and rec["step"] == 3
    cards = rec["by_rank"]
    assert len(cards) == 2 and cards[0] == cards[1]
    assert cards[0]["param_bytes"] == cards[0]["param_bytes_reckoned"]
    assert np.isfinite(rec["train"]["loss"])


def test_driver_refuses_tensor_parallelism(capsys, monkeypatch):
    """The driver takes ``--tensor``, ``--seq-parallel``, ``--expert``,
    ``--pipeline`` and ``--microbatches`` (tensor, context, expert and
    pipeline parallelism are ported); it still refuses the pipeline beside
    the MoE (JAX's refusal, at parse time) and its session the pipeline
    beside context parallelism, naming ROADMAP Queue 1 item 10."""
    args = tdriver.parse_args(["--variant", "tiny", "--tensor", "2", "--pipeline", "2",
                               "--microbatches", "4"])
    assert (args.tensor, args.pipeline, args.microbatches) == (2, 2, 4)
    args = tdriver.parse_args(["--variant", "tiny", "--moe-experts", "4", "--expert",
                               "2", "--microbatches", "2"])
    assert (args.pipeline, args.microbatches) == (1, 2)
    with pytest.raises(SystemExit) as e:
        tdriver.parse_args(["--variant", "tiny", "--tensor", "2", "--moe-experts", "4",
                            "--pipeline", "2"])
    assert e.value.code == 2
    assert "--moe-experts is not supported with --pipeline" in capsys.readouterr().err
    args = tdriver.parse_args(["--variant", "tiny", "--tensor", "2", "--seq-parallel",
                               "2", "--pipeline", "2", "--master", "local[8]"])
    monkeypatch.setenv("DLS_CONF_spark__dls__device", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        tdriver.make_session(args)
    args = tdriver.parse_args(["--variant", "tiny", "--tensor", "2"])
    assert args.fsdp == -1 and args.tensor == 2
    args = tdriver.parse_args(["--variant", "tiny", "--tensor", "2", "--moe-experts",
                               "4", "--expert", "2"])
    assert (args.expert, args.moe_experts) == (2, 4)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

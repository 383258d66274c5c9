"""Config 5 on a 2-D mesh: tensor parallelism, HSDP and meta-device init
against the JAX package, on the CPU.

- The rule engine on JAX ``tensor`` meshes: every Llama-2 7B LoRA leaf's
  ``llama_rules`` spec in the port (torch's ``[out, in]``) against JAX's
  ``tree_specs`` (flax's ``[in, ..., out]``, layers stacked), as which
  mesh axes shard each logical dim; and the bytes a card holds against
  JAX's reckoning (the one difference allowed is ``test_torch_fsdp.py``'s:
  JAX shards its stacked norm scales over ``fsdp``). JAX is used for placement only:
  its partitioner miscomputes on ``tensor`` meshes on this jax (ROADMAP
  Queue 3 item 3), so no JAX ``tensor`` mesh computes anything here.
- Three gloo gangs (this file is their script), each against the JAX
  ``Trainer``'s **one-device** run from the same converted weights and
  batches: ``local[2]`` at ``tensor=2``, ``local[4]`` at ``fsdp=2 ×
  tensor=2`` and at ``data=2 × fsdp=2`` (HSDP). In each, the tiny Llama
  LoRA (``llama_rules``) and a full fine-tune (every param trainable,
  ``llama_rules`` at ``fsdp_min_size=1`` through ``plan=``, with
  ``sanitize_every=1`` and the step's non-finite guard), 5 AdamW steps;
  every rank logs the same losses.
  Besides: the meta-device init bitwise the eager one and
  ``load_pretrained`` after it, the rows each rank feeds (tensor peers
  the same), ``predict``, one step's gradients at ``tensor=2`` (the
  adapters' summed over the tensor peers, the norm scales' not), the
  heads that do not divide by ``tensor`` refused, ``eval_every``, a
  bitwise resume at ``fsdp=2 × tensor=2`` and its checkpoint restored at
  one rank.
- The driver at ``local[2]`` with ``--tensor 2``.

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
from distributeddeeplearningspark_tpu.parallel import sharding as jsharding
from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
from distributeddeeplearningspark_tpu_torch.data.feed import host_batches
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

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_llama_lora.py"
RANK, B, S, STEPS = 4, 4, 32, 5
#: source partitions: the same global batches at 1, 2 and 4 batch shards
PARTS = 4
# logged losses over 5 f32 AdamW steps against JAX's one device: the
# ranks' sums (over the batch shards, the tensor peers' heads and vocab
# columns) in another order than XLA's (test_torch_fsdp.py's tolerance)
RTOL = 1e-4
# each param's change over those steps, |Δ_port − Δ_jax| / |Δ_jax| per
# tensor (test_torch_fsdp.py's: Adam's ±lr steps where a gradient is ~0)
PARAM_RTOL = 1e-3
# one step's gradients at tensor=2 against one process's, per tensor
# against its largest element: the peers' parts summed in another order
GRAD_RTOL = 1e-5
#: the gangs: processes and the session's mesh conf
GANGS = {
    "tensor": (2, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.tensor": 2}),
    "fsdp_tensor": (4, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.tensor": 2}),
    "hsdp": (4, {"mesh.data": 2, "mesh.fsdp": 2}),
}


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
    return mod.masked(tx, jllama.lora_trainable if mod is not optim
                      else tllama.lora_trainable) if lora else tx


def _full_plan(cfg) -> tplan.Plan:
    """The full fine-tune's layout: llama_rules, every divisible leaf
    sharded over fsdp."""
    return tplan.Plan(name="full", rules=tllama.llama_rules(cfg, fsdp_min_size=1))


def _port_model(init: dict, lora: bool) -> tllama.LlamaForCausalLM:
    model = tllama.LlamaForCausalLM(_tcfg(lora), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


# -- the gangs' side ----------------------------------------------------------------


def _full_params(model) -> dict:
    """Every param whole (sharded ones gathered: every rank calls it)."""
    return {n: tsharding.full(p.detach()).numpy() for n, p in model.named_parameters()}


def _trainer(spark, model, lora: bool, **kw) -> Trainer:
    if lora:
        return Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                       rules=tllama.llama_rules(model.cfg),
                       trainable=tllama.lora_trainable, **kw)
    return Trainer(spark, model, losses.causal_lm, _tx(optim, False),
                   plan=_full_plan(model.cfg), **kw)


def _predict(trainer) -> list:
    """Each row's next-token argmax over a small dataset (``predict``)."""
    return [p.tolist() for p in trainer.predict(_dataset(8, seed=7), batch_size=B,
                                                output_fn=lambda t: t.argmax(-1))]


def _run(spark, outdir: Path, gang: str, name: str, lora: bool, **fit_kw) -> dict:
    """5 steps of the LoRA fine-tune or the full one from the JAX init;
    rank 0 writes the final params whole. Returns this rank's losses, the
    dims its params are split on, its resident bytes and what ``predict``
    yields after training."""
    trainer = _trainer(spark, _port_model(dict(np.load(outdir / f"{name}_init.npz")), lora),
                       lora)
    logged: list = []
    _, summary = trainer.fit(_dataset().repeat(), batch_size=B, steps=STEPS, log_every=1,
                             callbacks=[lambda s, m: logged.append(m["loss"])], **fit_kw)
    final = _full_params(trainer.model)
    if spark.rank == 0:
        np.savez(outdir / f"{gang}_{name}_final.npz", **final)
    return dict(losses=logged, fsdp_dims=trainer.shard_dims,
                tensor_dims=trainer.tensor_dims,
                resident=tsharding.resident_param_bytes(trainer.model),
                predict=_predict(trainer), skipped=summary.get("skipped_steps"))


def _first_rows(spark) -> list:
    """The input ids of this rank's first batch."""
    trainer = _trainer(spark, tllama.LlamaForCausalLM(_tcfg(True), device="meta"), True)
    feed = trainer._host_feed(_dataset(), B)
    try:
        return next(feed)["input_ids"].tolist()
    finally:
        feed.close()


def _meta_init(spark, outdir: Path, gang: str) -> bool:
    """The LoRA model built on the meta device, lowered, materialised and
    drawn by the Trainer from seed 0; rank 0 writes its params whole. Then
    imported weights (the JAX LoRA run's) overlaid with ``load_pretrained``:
    whether the params gathered back are they, bit for bit."""
    trainer = _trainer(spark, tllama.LlamaForCausalLM(_tcfg(True), device="meta"), True)
    params = _full_params(trainer.model)
    if spark.rank == 0:
        np.savez(outdir / f"{gang}_meta_init.npz", **params)
    trained = dict(np.load(outdir / "lora_jax_final.npz"))
    trainer.init()
    trainer.load_pretrained(trained, strict=True)
    loaded = _full_params(trainer.model)
    return sorted(loaded) == sorted(trained) and all(
        np.array_equal(loaded[k], trained[k]) for k in trained)


def _capture_tx(store: list):
    def update(updates, state, params):
        store.extend(u.detach().clone() for u in updates)
        return [torch.zeros_like(u) for u in updates], state
    return optim.GradientTransformation(lambda params: (), update)


def _grad_batch() -> dict:
    return {k: np.stack([e[k] for e in _examples(4, seed=9)]) for k in ("input_ids",
                                                                      "loss_mask")}


def _grads(spark, outdir: Path) -> None:
    """One step on the whole batch (both tensor peers feed it), every param
    trainable under ``llama_rules``, from the JAX LoRA run's trained
    weights (nonzero B): each rank's local gradients and grad norm."""
    model = _port_model(dict(np.load(outdir / "lora_jax_final.npz")), True)
    tsharding.fully_shard_model(model, tllama.llama_rules(model.cfg), spark.mesh)
    store: list = []
    named = dict(model.named_parameters())
    state = TrainState(step=0, params=named, opt_state=(),
                       generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, _capture_tx(store), losses.causal_lm, distributed=True,
                           mesh=spark.mesh)
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in _grad_batch().items()})
    np.savez(outdir / f"grads_{spark.rank}.npz",
             **{n: g.numpy() for n, g in zip(named, store)})
    (outdir / f"grads_{spark.rank}.json").write_text(json.dumps(dict(
        grad_norm=float(metrics["grad_norm"]),
        dims={n: tsharding.tensor_split(p).dim for n, p in named.items()
              if tsharding.tensor_split(p) is not None})))


def _heads_refused(spark) -> str | None:
    """A forward of a model whose kv heads (1) do not divide by tensor=2."""
    cfg = tllama.LlamaConfig.tiny(num_kv_heads=1, lora_rank=RANK)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    tsharding.fully_shard_model(model, tllama.llama_rules(cfg), spark.mesh)
    try:
        model({"input_ids": torch.zeros((1, 8), dtype=torch.long)})
    except ValueError as e:
        return str(e)
    return None


def _resume(spark, outdir: Path) -> None:
    """The full fine-tune (2-D sharded params and moments): 4 steps
    straight with a checkpoint every 2, then a new trainer restored at step
    2 run to 4; rank 0 writes both runs' final params."""
    init = dict(np.load(outdir / "full_init.npz"))
    finals = {}
    for run in ("straight", "resumed"):
        ckpt = Checkpointer(outdir / "ckpt", async_save=run == "straight")
        trainer = _trainer(spark, _port_model(init, False), False, checkpointer=ckpt)
        data_state = None
        if run == "resumed":
            _, data_state = trainer.restore(step=2)
        trainer.fit(_dataset().repeat(), batch_size=B, steps=4, log_every=2,
                    checkpoint_every=2 if run == "straight" else None,
                    data_state=data_state)
        ckpt.close()
        finals[run] = _full_params(trainer.model)
    if spark.rank == 0:
        for run, params in finals.items():
            np.savez(outdir / f"resume_{run}.npz", **params)


def _worker(outdir: Path, gang: str) -> None:
    """One rank of a gang: every scenario of its mesh, in order."""
    builder = Session.builder.appName(f"tp-{gang}")
    for k, v in GANGS[gang][1].items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == GANGS[gang][0]
    out: dict = dict(mesh=spark.mesh.shape, rank=spark.rank)
    out["lora"] = _run(spark, outdir, gang, "lora", True)
    evals: list = []
    # the guard snapshots and restores each rank's 2-D shards; a finite run
    # skips nothing and matches JAX's like the others
    fit_kw = dict(sanitize_every=1, on_nonfinite="skip")
    if gang == "fsdp_tensor":
        orig = Trainer.evaluate

        def recorded(self, ds, *, batch_size):
            evals.append(orig(self, ds, batch_size=batch_size))
            return evals[-1]

        Trainer.evaluate = recorded
        fit_kw.update(eval_every=STEPS, eval_dataset=_dataset(6, seed=5))
    out["full"] = _run(spark, outdir, gang, "full", False, **fit_kw)
    out["evals"] = evals
    out["rows"] = _first_rows(spark)
    out["load_pretrained_exact"] = _meta_init(spark, outdir, gang)
    if gang == "tensor":
        _grads(spark, outdir)
        out["heads_refused"] = _heads_refused(spark)
    if gang == "fsdp_tensor":
        _resume(spark, outdir)
    (outdir / f"{gang}_rank{spark.rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the JAX side -------------------------------------------------------------------


def _jax_run(outdir: Path, name: str, lora: bool) -> dict:
    """The JAX Trainer on one device: the init and final params as port
    state dicts, and the logged losses."""
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
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
    jt.fit(jds.repeat(), batch_size=B, steps=STEPS, log_every=1,
           callbacks=[lambda s, m: logged.append(float(m["loss"]))])
    final = port(jt)
    jspark.stop()
    np.savez(outdir / f"{name}_init.npz", **init)
    np.savez(outdir / f"{name}_jax_final.npz", **final)
    return dict(init=init, losses=logged, final=final)


@pytest.fixture(scope="module")
@bounded()
def gangs(tmp_path_factory):
    """The JAX one-device runs (their init params seed the gangs), then the
    three gangs: (outdir, {"lora": JAX run, "full": JAX run})."""
    outdir = tmp_path_factory.mktemp("gang_tp")
    jruns = {name: _jax_run(outdir, name, name == "lora") for name in ("lora", "full")}
    for gang, (n, _) in GANGS.items():
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        str(Path(__file__).resolve()), str(outdir), gang])
        assert res.returncode == 0, (gang, res.stderr[-4000:])
    return outdir, jruns


def _rank(outdir, gang: str, r: int) -> dict:
    return json.loads((outdir / f"{gang}_rank{r}.json").read_text())


def _npz(path) -> dict:
    return dict(np.load(path))


# -- the rule engine on JAX tensor meshes ---------------------------------------------


MESHES = [dict(tensor=2), dict(fsdp=2, tensor=2), dict(tensor=4),
          dict(data=2, fsdp=2), dict(data=2, fsdp=2, tensor=2)]


def _jax_mesh(axes: dict):
    spec = JMeshSpec(**{"data": 1, **axes})
    n = int(np.prod(spec.axis_sizes(int(np.prod(list(axes.values()))))))
    return spec.build(jax.devices()[:n])


def _kind(path: str) -> str:
    """A leaf's kind on either side (``attention/wq``, ``attention/wq/lora_a``,
    ``mlp_norm/scale``...): layer indices, the stacked ``layers`` prefix and
    the weight's own name dropped."""
    parts = [p for p in path.split("/") if not p.isdigit() and p != "layers"]
    while parts[-1] in ("weight", "kernel", "embedding", "base"):
        parts = parts[:-1]
    return "/".join(parts)


@pytest.fixture(scope="module")
def shapes_7b():
    """The Llama-2 7B LoRA (rank 16) leaves: the port's shapes and dtypes
    from a model on the meta device, JAX's tree from ``eval_shape``."""
    tcfg = tllama.LlamaConfig.llama2_7b(lora_rank=16)
    model = tllama.LlamaForCausalLM(tcfg, device="meta")
    port = {n: (tuple(p.shape), p.element_size()) for n, p in model.named_parameters()}
    jcfg = jllama.LlamaConfig.llama2_7b(lora_rank=16)
    tree = jax.eval_shape(jllama.LlamaForCausalLM(jcfg).init, jax.random.PRNGKey(0),
                          {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    return tcfg, jcfg, tree, port


def _jax_specs(jcfg, tree, mesh) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_flatten_with_path(
        jllama.llama_rules(jcfg).tree_specs(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsharding.path_str(p): (tuple(v.shape), tuple(s), np.dtype(v.dtype).itemsize)
            for (p, v), (_, s) in zip(leaves, specs)}


def _axes_by_dim(spec, shape, torch_shape) -> tuple:
    """The mesh axes on each of ``torch_shape``'s dims, read from a JAX
    leaf's ``spec`` over ``shape``: the stacked layer dim dropped, a flax
    kernel ``[in..., out...]`` grouped into torch's ``(out, in)``, any other
    leaf in its own order."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if len(shape) > len(torch_shape) and np.prod(shape[1:]) == np.prod(torch_shape):
        shape, entries = shape[1:], entries[1:]

    def axes(dims):
        return frozenset(a for d in dims for a in tsharding._axes(entries[d]))

    if tuple(shape) == tuple(torch_shape) and len(shape) != 2 or len(torch_shape) == 1:
        return tuple(axes([d]) for d in range(len(shape)))
    out, inn = torch_shape
    for k in range(1, len(shape)):
        if np.prod(shape[:k]) == inn and np.prod(shape[k:]) == out:
            return axes(range(k, len(shape))), axes(range(k))
    return tuple(axes([d]) for d in range(len(shape)))


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_rules_place_7b_as_jax_on_tensor_meshes(shapes_7b, axes):
    """Every 7B LoRA leaf's spec: the mesh axes on each logical dim are
    JAX's (``tree_specs`` on a JAX mesh of those axes), but the norm scales,
    which JAX stacks over the layers past ``fsdp_min_size`` and shards over
    ``fsdp`` (the port keeps one ``[H]`` a layer, replicated); the
    ``tensor`` entries split q/k/v's heads, gate/up's columns, wo/down's
    inputs and the vocab of the embedding and the head."""
    tcfg, jcfg, tree, port = shapes_7b
    mesh = _jax_mesh(axes)
    tspecs = tllama.llama_rules(tcfg).tree_specs({n: s for n, (s, _) in port.items()}, mesh)
    jspecs = {_kind(p): v for p, v in _jax_specs(jcfg, tree, mesh).items()}
    seen = set()
    for name, spec in tspecs.items():
        kind = _kind(tsharding.path_str(name))
        shape = port[name][0]
        got = tuple(frozenset(tsharding._axes(e)) for e in
                    list(spec) + [None] * (len(shape) - len(spec)))
        jshape, jspec, _ = jspecs[kind]
        want = _axes_by_dim(jspec, jshape, shape)
        if kind.endswith("norm/scale"):
            want = tuple(a - {"fsdp"} for a in want)
        assert got == want, (name, spec, jspec)
        seen.add(kind)
    assert seen == set(jspecs)
    split = {_kind(tsharding.path_str(n)): tsharding.axis_dim(s, "tensor")
             for n, s in tspecs.items()}
    if axes.get("tensor", 1) > 1:
        assert split == {**{k: None for k in split}, "attention/wq": 0, "attention/wk": 0,
                         "attention/wv": 0, "attention/wo": 1, "mlp/gate": 0,
                         "mlp/up": 0, "mlp/down": 1, "token_embed": 0, "lm_head": 0}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_llama_7b_bytes_per_card_match_jax_on_tensor_meshes(shapes_7b, axes):
    """The port's bytes a card (``bytes_per_card``) are JAX's reckoning
    (each leaf over the sizes of the axes its spec names) plus the norm
    scales' part that JAX shards over ``fsdp``; at ``fsdp × tensor`` = 4
    both reckon the 7B LoRA at 3,403,694,080 B a card, 1/4 of the base."""
    tcfg, jcfg, tree, port = shapes_7b
    mesh = _jax_mesh(axes)
    got = tsharding.bytes_per_card({n: s for n, (s, _) in port.items()},
                                   {n: b for n, (_, b) in port.items()},
                                   tllama.llama_rules(tcfg), mesh)
    want, norm_bytes = 0, 0
    for path, (shape, spec, itemsize) in _jax_specs(jcfg, tree, mesh).items():
        nbytes = int(np.prod(shape)) * itemsize
        want += nbytes // int(np.prod([mesh.shape[a] for e in spec
                                       for a in tsharding._axes(e)]))
        if "norm/scale" in path and _kind(path) != "final_norm/scale":
            norm_bytes += nbytes
    fsdp = mesh.shape["fsdp"]
    assert got - want == norm_bytes - norm_bytes // fsdp
    if mesh.shape["fsdp"] * mesh.shape["tensor"] == 4:
        assert got == 3_403_694_080


# -- the gangs against JAX's one device -----------------------------------------------


@pytest.mark.parametrize("gang", sorted(GANGS))
@pytest.mark.parametrize("name", ["lora", "full"])
def test_gang_matches_jax_one_device(gangs, gang, name):
    """The tiny LoRA and the full fine-tune on each mesh: every rank logged
    the same losses, JAX's one-device ones; the final params are JAX's."""
    outdir, jruns = gangs
    jrun = jruns[name]
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    got = [r[name]["losses"] for r in ranks]
    assert all(g == got[0] for g in got) and len(got[0]) == STEPS
    if name == "full":  # under the guard: nothing skipped
        assert all(r[name]["skipped"] == 0.0 for r in ranks)
    np.testing.assert_allclose(got[0], jrun["losses"], rtol=RTOL)
    final = _npz(outdir / f"{gang}_{name}_final.npz")
    assert sorted(final) == sorted(jrun["final"])
    for k, v in final.items():
        change = np.linalg.norm(jrun["final"][k] - jrun["init"][k])
        assert np.linalg.norm(v - jrun["final"][k]) <= PARAM_RTOL * change, k
    moved = [k for k in final if not np.array_equal(final[k], jrun["init"][k])]
    if name == "lora":
        assert sorted(moved) == sorted(k for k in final if tllama.lora_trainable(k))
    else:
        assert len(moved) == len(final)


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_each_card_holds_its_shards(gangs, gang):
    """Which params each mesh splits over ``tensor`` and shards over
    ``fsdp``, and each card's resident bytes: the rule engine's reckoning,
    the whole model's over the ranks' product of shard axes where every
    leaf divides (the full fine-tune at ``fsdp_min_size=1``)."""
    outdir, _ = gangs
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    mesh = ranks[0]["mesh"]
    model = tllama.LlamaForCausalLM(_tcfg(True), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sizes = {n: p.element_size() for n, p in model.named_parameters()}
    want = tsharding.bytes_per_card(shapes, sizes, tllama.llama_rules(model.cfg),
                                    tmesh.Mesh(mesh))
    for r in ranks:
        assert r["lora"]["resident"] == want
        assert r["lora"]["tensor_dims"] == ranks[0]["lora"]["tensor_dims"]
    tdims, fdims = ranks[0]["lora"]["tensor_dims"], ranks[0]["lora"]["fsdp_dims"]
    if mesh["tensor"] > 1:
        assert tdims["layers.0.attention.wq.weight"] == 0
        assert tdims["layers.0.attention.wo.weight"] == 1
        assert tdims["token_embed.weight"] == 0 and tdims["lm_head.weight"] == 0
        assert not any("lora_" in n or "norm" in n for n in tdims)
    else:
        assert tdims == {}
    assert (fdims != {}) == (mesh["fsdp"] > 1)
    for n, d in fdims.items():  # fsdp on the other dim of a tensor-split weight
        assert tdims.get(n, -1) != d, n


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_meta_device_init_is_the_eager_init_bitwise(gangs, gang):
    """The model built on the meta device, lowered onto the mesh, moved with
    ``to_empty`` and drawn by the Trainer from seed 0 (each param whole,
    each rank keeping its shard) is, gathered, bit for bit the model built
    whole on one device from seed 0."""
    outdir, _ = gangs
    meta = _npz(outdir / f"{gang}_meta_init.npz")
    eager = {n: p.detach().numpy() for n, p in
             tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK).named_parameters()}
    assert sorted(meta) == sorted(eager)
    for k in eager:
        assert np.array_equal(meta[k], eager[k]), k


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_load_pretrained_writes_each_shard_after_meta_init(gangs, gang):
    """``Trainer.load_pretrained`` on the model the meta-device init made
    (strict): the params gathered back are the imported ones, bit for
    bit, on every rank."""
    outdir, _ = gangs
    assert all(_rank(outdir, gang, r)["load_pretrained_exact"]
               for r in range(GANGS[gang][0]))


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_tensor_peers_feed_the_same_rows(gangs, gang):
    """Each rank feeds the rows of its coordinate on ``data × fsdp``: the
    ranks of one tensor group the same rows, and the batch shards together
    the global batch's rows."""
    outdir, _ = gangs
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    mesh = ranks[0]["mesh"]
    t = mesh["tensor"]
    rows = [r["rows"] for r in ranks]
    for r, got in enumerate(rows):
        assert got == rows[r - r % t]
    shards = [rows[i] for i in range(0, len(rows), t)]
    assert len(shards) == mesh["data"] * mesh["fsdp"]
    everything = sorted(tuple(x) for s in shards for x in s)
    whole = next(host_batches(_dataset(), B))["input_ids"].tolist()
    assert everything == sorted(tuple(x) for x in whole)
    if len(shards) > 1:
        assert shards[0] != shards[1]


def test_adapter_gradients_sum_over_tensor_peers(gangs):
    """One step at ``tensor=2``, every param trainable: each rank's split
    gradients put together along their split dim, and its whole ones
    (the LoRA adapters, summed over the peers in the backward; the norm
    scales, whole on each peer and not summed), are one process's on the
    same batch, and so is the grad norm. Left unsummed, an adapter's
    gradient is one peer's part; summed, a norm scale's is doubled."""
    outdir, _ = gangs
    meta = [json.loads((outdir / f"grads_{r}.json").read_text()) for r in (0, 1)]
    parts = [_npz(outdir / f"grads_{r}.npz") for r in (0, 1)]
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
        got = (np.concatenate([p[n] for p in parts], axis=dims[n]) if n in dims
               else parts[0][n])
        if n not in dims:
            assert np.array_equal(parts[0][n], parts[1][n]), n
        scale = float(np.abs(want).max())
        assert scale > 0, n
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale, err_msg=n)
    assert any("lora_" in n for n in whole) and any("norm" in n for n in whole)
    for m in meta:
        np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)


def test_heads_that_do_not_divide_by_tensor_raise(gangs):
    """A model with one kv head at ``tensor=2``: the forward raises
    ``ValueError`` naming the head counts and the shapes, and never runs
    a rank on part of a head."""
    outdir, _ = gangs
    for r in (0, 1):
        msg = _rank(outdir, "tensor", r)["heads_refused"]
        assert msg and "num_kv_heads=1" in msg and "tensor=2" in msg and "wk (32, 128)" in msg


def test_eval_inside_fit_at_fsdp_by_tensor(gangs):
    """``fit(eval_every=5)`` at ``fsdp=2 × tensor=2``: every rank's
    evaluation is the same, one process's ``evaluate`` of the final params
    (the batch group's sums: the tensor peers' rows counted once)."""
    outdir, _ = gangs
    evals = [_rank(outdir, "fsdp_tensor", r)["evals"] for r in range(4)]
    assert all(e == evals[0] for e in evals) and len(evals[0]) == 1
    final = _npz(outdir / "fsdp_tensor_full_final.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(final, False), losses.causal_lm,
                          _tx(optim, False))
        want = trainer.evaluate(_dataset(6, seed=5), batch_size=B)
    assert set(want) == set(evals[0][0])
    np.testing.assert_allclose(evals[0][0]["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_predict_gathers_the_global_rows(gangs, gang):
    """``predict`` after the full fine-tune: every rank yields the whole
    global row stream (the vocab-split logits gathered, then the rows over
    the batch group), one process's ``predict`` of the final params, row
    for row (in the feed order of each shard count: at 2 batch shards of 4
    partitions, rows 1 and 2 of a batch trade places)."""
    outdir, _ = gangs
    got = [_rank(outdir, gang, r)["full"]["predict"] for r in range(GANGS[gang][0])]
    assert all(g == got[0] for g in got) and len(got[0]) == 8
    final = _npz(outdir / f"{gang}_full_final.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        want = _predict(Trainer(spark, _port_model(final, False), losses.causal_lm,
                                _tx(optim, False)))
    assert sorted(got[0]) == sorted(want)


def test_resume_at_fsdp_by_tensor_is_bitwise_and_restores_at_one_rank(gangs):
    """The full fine-tune at ``fsdp=2 × tensor=2`` restored at step 2 and
    run to 4 is the straight run bitwise; the checkpoint (whole tensors,
    gathered from 2-D ``DTensor``\\ s) restores into one unsharded process
    with the same params and optimizer state."""
    outdir, _ = gangs
    straight, resumed = (_npz(outdir / f"resume_{r}.npz") for r in ("straight", "resumed"))
    assert sorted(straight) == sorted(resumed)
    for k in straight:
        assert np.array_equal(straight[k], resumed[k]), k
    init = _npz(outdir / "full_init.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(init, False), losses.causal_lm,
                          _tx(optim, False), plan=_full_plan(_tcfg(False)),
                          checkpointer=Checkpointer(outdir / "ckpt"))
        assert trainer.shard_dims == {} and trainer.tensor_dims == {}
        state, data_state = trainer.restore()
        assert state.step == 4 and data_state["examples_seen"] == 4 * B
        for k, p in state.params.items():
            assert np.array_equal(p.detach().numpy(), straight[k]), k
        moments = [t for t in _tensor_leaves(state.opt_state) if t.dim()]
        assert len(moments) == 2 * len(state.params)


def _tensor_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_a_group_of_one_still_all_reduces(tmp_path):
    """``all_reduce_grads`` over a group of one rank (a gang of one, or the
    batch group at ``tensor`` = world) makes its collective, the one a step
    the LeNet gang of one counts on the card, and leaves the sums alone."""
    import torch.distributed as dist

    from distributeddeeplearningspark_tpu_torch.parallel import collectives

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        g = [torch.arange(3.0), torch.ones(2, dtype=torch.float64)]
        before = collectives.all_reduce_grads.calls
        collectives.all_reduce_grads(g)
        collectives.all_reduce_grads(g, dist.new_group([0]))
        assert collectives.all_reduce_grads.calls == before + 2
        assert g[0].tolist() == [0.0, 1.0, 2.0] and g[1].tolist() == [1.0, 1.0]
    finally:
        dist.destroy_process_group()


# -- the driver ---------------------------------------------------------------------


def test_driver_splits_over_tensor(tmp_path):
    """The port's driver at ``local[2]`` with ``--tensor 2`` on the CPU: the
    JAX driver's mesh (``data=1, fsdp=1, tensor=2``), the base's weights
    split (2 of 4 heads a rank), each rank holding what the rule engine
    reckons, the replicas checked, every rank's losses the same and those
    of one rank on the same batches."""
    args = [str(DRIVER), "--variant", "tiny", "--steps", "3", "--batch-size", "4",
            "--seq-len", "64", "--lora-rank", "4", "--log-every", "1"]
    recs = {}
    for n, extra in ((2, ["--tensor", "2"]), (1, [])):
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        "--workdir", str(tmp_path / str(n)), *args, *extra])
        assert res.returncode == 0, res.stderr[-4000:]
        recs[n] = json.loads([x for x in res.stdout.splitlines()
                              if x.startswith('{"train"')][-1])
    rec = recs[2]
    assert rec["world_size"] == 2 and rec["mesh"]["tensor"] == 2 and rec["mesh"]["fsdp"] == 1
    assert rec["local_heads"] == 2 and recs[1]["local_heads"] == 4
    assert rec["tensor_split_params"] == rec["sharded_params"] > 0
    assert rec["replicas_checked"] and rec["step"] == 3
    cards = rec["by_rank"]
    assert cards[0]["param_bytes"] == cards[0]["param_bytes_reckoned"] == cards[1]["param_bytes"]
    assert cards[0]["param_bytes"] < recs[1]["by_rank"][0]["param_bytes"]
    assert cards[0]["tensor_all_reduces"] > 0 == recs[1]["by_rank"][0]["tensor_all_reduces"]
    np.testing.assert_allclose(rec["train"]["loss"], recs[1]["train"]["loss"], rtol=RTOL)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])

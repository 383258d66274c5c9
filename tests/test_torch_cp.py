"""Context parallelism for config 5 against the JAX package, on the CPU.

- The ops: the port's ``ring_attention`` at ``seq=2`` and ``seq=4`` and
  ``ulysses_attention`` at ``seq=2`` (the tiny model's two kv heads cap
  it), forward and dq/dk/dv, each rank on its block of the sequence in a
  gloo gang, held against two references: JAX ``ring_attention(use_flash=
  True)`` / ``ulysses_attention(use_flash=True)`` (interpret-mode kernels)
  on the 8-device CPU mesh, and JAX dense attention on one device. Causal
  and not, GQA, a key-padding mask with a fully masked row (O = 0), packed
  segment ids riding the ring. The hops a rank computes (the inactive
  ones: none) and what the ops refuse.
- Four gloo gangs (this file is their script), each against the JAX
  ``Trainer``'s **one-device** run from the same converted weights and
  batches (ROADMAP Queue 3 item 3: this jax miscomputes on mixed-axis
  meshes, so no JAX CP Trainer is a reference): ``local[2]`` at ``seq=2``
  with the ring and with Ulysses, ``local[4]`` at ``seq=4`` (ring), at
  ``fsdp=2 × seq=2`` and at ``tensor=2 × seq=2``. In each, the tiny Llama
  LoRA and a full fine-tune (``sanitize_every=1``), 5 AdamW steps; every
  rank logs the same losses. Besides: next-token labels across the
  blocks' boundaries (``loss_mask`` and packed ``segment_ids``), the
  global RoPE positions, one step's gradients summed over the ``seq``
  peers, ``predict`` and ``evaluate``, a bitwise resume at ``fsdp=2 ×
  seq=2`` and its checkpoint restored at one rank.
- The driver at ``local[2]`` with ``--seq-parallel 2 --cp-impl ulysses``.

f32 throughout: each tolerance is summation order, and says so."""

import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.ops.attention import _xla_attention
from distributeddeeplearningspark_tpu.ops.ring_attention import ring_attention as jring
from distributeddeeplearningspark_tpu.ops.ulysses import ulysses_attention as julysses
from distributeddeeplearningspark_tpu.parallel import plan as jplan
from distributeddeeplearningspark_tpu.parallel import sharding as jsharding
from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.ops import ring_attention as tring
from distributeddeeplearningspark_tpu_torch.ops.attention import dot_product_attention
from distributeddeeplearningspark_tpu_torch.ops import ulysses as tulysses
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
#: source partitions: the same global batches at 1 and 2 batch shards
PARTS = 4
# logged losses over 5 f32 AdamW steps against JAX's one device: each
# token's loss summed over the seq peers' blocks and the batch shards in
# another order than XLA's (test_torch_tp.py's tolerance)
RTOL = 1e-4
# each param's change over those steps, |Δ_port − Δ_jax| / |Δ_jax| per
# tensor (test_torch_tp.py's: Adam's ±lr steps where a gradient is ~0)
PARAM_RTOL = 1e-3
# one step's gradients at seq=2 against one process's on the whole rows,
# per tensor against its largest element: the peers' parts summed in
# another order
GRAD_RTOL = 1e-5
# the ops against JAX, f32: hops merged on the LSE against one softmax
# (JAX's own ring tests' tolerance)
OP_TOL = 2e-5
#: the gangs: processes and the session's mesh conf
GANGS = {
    "seq2": (2, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.seq": 2}),
    "seq4": (4, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.seq": 4}),
    "fsdp_seq": (4, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.seq": 2}),
    "tensor_seq": (4, {"mesh.data": 1, "mesh.fsdp": -1, "mesh.seq": 2,
                       "mesh.tensor": 2}),
}
#: the Trainer runs of each gang: (name, attention_impl, lora)
RUNS = {
    "seq2": [("ring_lora", "ring", True), ("ring_full", "ring", False),
             ("ulysses_lora", "ulysses", True), ("ulysses_full", "ulysses", False)],
    "seq4": [("ring_lora", "ring", True), ("ring_full", "ring", False)],
    "fsdp_seq": [("ring_lora", "ring", True), ("ring_full", "ring", False)],
    "tensor_seq": [("ring_lora", "ring", True), ("ring_full", "ring", False)],
}
#: the op cases: (name, causal, kv heads, mask, segment ids)
OP_CASES = {
    "causal_gqa": (True, 2, False, False),
    "noncausal_gqa": (False, 2, False, False),
    "mask": (True, 4, True, False),
    "segments": (True, 2, True, True),
}
OP_B, OP_S, OP_H, OP_D = 4, 16, 4, 8
#: the op runs: (gang, impl) → seq degree
OP_RUNS = {("seq2", "ring"): 2, ("seq4", "ring"): 4, ("seq2", "ulysses"): 2}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- inputs both sides build ----------------------------------------------------


def _examples(n: int = 16, seed: int = 3, packed: bool = False) -> list[dict]:
    """Rows of S tokens; ``packed``: a random ``loss_mask`` and three
    packed documents a row, cut where the blocks' boundaries are not."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ex = {"input_ids": rng.integers(0, 512, S).astype(np.int32),
              "loss_mask": np.ones(S, np.float32)}
        if packed:
            ex["loss_mask"] = (rng.random(S) > 0.25).astype(np.float32)
            ex["segment_ids"] = np.repeat(np.arange(3), [5, 13, S - 18]).astype(np.int32)
        out.append(ex)
    return out


def _dataset(n: int = 16, seed: int = 3, packed: bool = False):
    return PartitionedDataset.parallelize(_examples(n, seed, packed), PARTS)


def _tcfg(lora: bool, impl: str = "auto"):
    return tllama.LlamaConfig.tiny(lora_rank=RANK if lora else 0, attention_impl=impl)


def _tx(mod, lora: bool):
    """The driver's optimizer: AdamW under the clip, masked for LoRA."""
    tx = mod.with_grad_clip(mod.adamw(mod.warmup_cosine(1e-2, 1, STEPS)), 1.0)
    return mod.masked(tx, jllama.lora_trainable if mod is not optim
                      else tllama.lora_trainable) if lora else tx


def _port_model(init: dict, lora: bool, impl: str = "auto") -> tllama.LlamaForCausalLM:
    model = tllama.LlamaForCausalLM(_tcfg(lora, impl), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _op_inputs(case: str) -> dict:
    """The global q, k, v, the output's cotangent, and the case's mask
    (row 1 fully masked, row 2 padded) and segment ids, f32 numpy."""
    causal, hkv, masked, segmented = OP_CASES[case]
    rng = np.random.default_rng(sorted(OP_CASES).index(case))
    mk = lambda h: rng.normal(0, 1, (OP_B, OP_S, h, OP_D)).astype(np.float32)  # noqa: E731
    out = dict(q=mk(OP_H), k=mk(hkv), v=mk(hkv), w=mk(OP_H))
    if masked:
        mask = np.ones((OP_B, OP_S), np.int32)
        mask[1] = 0
        mask[2, 11:] = 0
        out["mask"] = mask
    if segmented:
        out["segs"] = np.repeat(np.arange(3), [3, 7, OP_S - 10])[None].repeat(
            OP_B, 0).astype(np.int32)
    return out


def _block(x: np.ndarray, index: int, n: int) -> np.ndarray:
    s = x.shape[1] // n
    return x[:, index * s:(index + 1) * s]


# -- the gangs' side ----------------------------------------------------------------


def _full_params(model) -> dict:
    """Every param whole (sharded ones gathered: every rank calls it)."""
    return {n: tsharding.full(p.detach()).numpy() for n, p in model.named_parameters()}


def _trainer(spark, model, lora: bool, **kw) -> Trainer:
    if lora:
        return Trainer(spark, model, losses.causal_lm, _tx(optim, True),
                       rules=tllama.llama_rules(model.cfg),
                       trainable=tllama.lora_trainable, context_parallel=True, **kw)
    return Trainer(spark, model, losses.causal_lm, _tx(optim, False),
                   plan=tplan.Plan(name="full", seq_axis="seq",
                                   rules=tllama.llama_rules(model.cfg, fsdp_min_size=1)),
                   **kw)


def _predict(trainer) -> list:
    """Each row's next-token argmax over a small dataset (``predict``)."""
    return [p.tolist() for p in trainer.predict(_dataset(8, seed=7), batch_size=B,
                                                output_fn=lambda t: t.argmax(-1))]


def _run(spark, outdir: Path, gang: str, name: str, impl: str, lora: bool,
         init: str, steps: int = STEPS, data=None, **fit_kw) -> dict:
    """The LoRA or the full fine-tune from the JAX init ``init``; rank 0
    writes the final params whole. This rank's losses, resident bytes and
    what ``predict`` yields after training."""
    trainer = _trainer(spark, _port_model(dict(np.load(outdir / f"{init}_init.npz")),
                                          lora, impl), lora)
    logged: list = []
    _, summary = trainer.fit((data or _dataset()).repeat(), batch_size=B, steps=steps,
                             log_every=1, tokens_per_example=S,
                             callbacks=[lambda s, m: logged.append(m["loss"])], **fit_kw)
    final = _full_params(trainer.model)
    if spark.rank == 0:
        np.savez(outdir / f"{gang}_{name}_final.npz", **final)
    out = dict(losses=logged, resident=tsharding.resident_param_bytes(trainer.model),
               fsdp_dims=trainer.shard_dims, tensor_dims=trainer.tensor_dims,
               tokens_per_sec=summary["tokens_per_sec"],
               step_ms=summary["step_time_ms"])
    if not lora:
        out["predict"] = _predict(trainer)
        out["evaluate"] = trainer.evaluate(_dataset(6, seed=5), batch_size=B)
    return out


def _ops(spark, outdir: Path, gang: str, impl: str) -> None:
    """Each op case on this rank's block: the output and dq/dk/dv of
    ``sum(o·w)``, and the hops each rank computed and the exchanges it
    made, written to ``ops_<gang>_<impl>_<case>_<rank>.npz``."""
    n, r = spark.mesh.shape["seq"], spark.mesh.seq_index
    op = tring.ring_attention if impl == "ring" else tulysses.ulysses_attention
    counts = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    hop_fwd, hop_bwd = tring.hop_forward, tring.hop_backward
    tring.hop_forward, tring.hop_backward = counted(hop_fwd, "fwd"), counted(hop_bwd, "bwd")
    try:
        for case, (causal, *_rest) in OP_CASES.items():
            inp = _op_inputs(case)
            loc = {k: torch.from_numpy(np.ascontiguousarray(_block(v, r, n)))
                   for k, v in inp.items()}
            q, k, v = (loc[x].requires_grad_() for x in "qkv")
            counts.update(fwd=0, bwd=0)
            calls = tring.exchange.calls
            o = op(q, k, v, causal=causal, mask=loc.get("mask"),
                   segment_ids=loc.get("segs"))
            (o * loc["w"]).sum().backward()
            np.savez(outdir / f"ops_{gang}_{impl}_{case}_{r}.npz", o=o.detach().numpy(),
                     dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy(),
                     hops=np.array([counts["fwd"], counts["bwd"]]),
                     exchanges=np.array(tring.exchange.calls - calls))
    finally:
        tring.hop_forward, tring.hop_backward = hop_fwd, hop_bwd


def _grad_batch() -> dict:
    return {k: np.stack([e[k] for e in _examples(4, seed=9)]) for k in ("input_ids",
                                                                      "loss_mask")}


def _capture_tx(store: list):
    def update(updates, state, params):
        store.extend(u.detach().clone() for u in updates)
        return [torch.zeros_like(u) for u in updates], state
    return optim.GradientTransformation(lambda params: (), update)


def _grads(spark, outdir: Path) -> None:
    """One step at seq=2, every param trainable, from the JAX LoRA run's
    trained weights (nonzero B), each rank on its block of the whole
    batch: its gradients and grad norm."""
    model = _port_model(dict(np.load(outdir / "lora_jax_final.npz")), True, "ring")
    store: list = []
    named = dict(model.named_parameters())
    state = TrainState(step=0, params=named, opt_state=(),
                       generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, _capture_tx(store), losses.causal_lm, distributed=True,
                           mesh=spark.mesh)
    batch = tfeed.seq_shard(_grad_batch(), spark.mesh.seq_index, 2)
    _, metrics = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()})
    np.savez(outdir / f"grads_{spark.rank}.npz",
             **{n: g.numpy() for n, g in zip(named, store)})
    (outdir / f"grads_{spark.rank}.json").write_text(json.dumps(dict(
        grad_norm=float(metrics["grad_norm"]), loss=float(metrics["loss"]))))


def _resume(spark, outdir: Path) -> None:
    """The full fine-tune at fsdp=2 × seq=2: 4 steps straight with a
    checkpoint every 2, then a new trainer restored at step 2 run to 4;
    rank 0 writes both runs' final params."""
    init = dict(np.load(outdir / "full_init.npz"))
    finals = {}
    for run in ("straight", "resumed"):
        ckpt = Checkpointer(outdir / "ckpt", async_save=run == "straight")
        trainer = _trainer(spark, _port_model(init, False, "ring"), False,
                           checkpointer=ckpt)
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
    builder = Session.builder.appName(f"cp-{gang}")
    for k, v in GANGS[gang][1].items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == GANGS[gang][0]
    mesh = spark.mesh
    out: dict = dict(mesh=mesh.shape, rank=spark.rank, seq_index=mesh.seq_index,
                     batch_index=mesh.batch_index(spark.rank),
                     positions=tllama.positions(8, "cpu", "ring")[0].tolist())
    for (g, impl) in OP_RUNS:
        if g == gang:
            _ops(spark, outdir, gang, impl)
    for name, impl, lora in RUNS[gang]:
        kw = dict(sanitize_every=1) if not lora else {}
        out[name] = _run(spark, outdir, gang, name, impl, lora,
                         "lora" if lora else "full", **kw)
    if gang == "seq4":
        out["packed"] = _run(spark, outdir, gang, "packed", "ring", True, "packed",
                             steps=3, data=_dataset(packed=True))
        kv = torch.zeros(1, 4, 2, 8)
        try:
            tulysses.ulysses_attention(torch.zeros(1, 4, 4, 8), kv, kv)
        except ValueError as e:
            out["ulysses_refused"] = str(e)
    if gang == "seq2":
        _grads(spark, outdir)
    if gang == "fsdp_seq":
        _resume(spark, outdir)
    (outdir / f"{gang}_rank{spark.rank}.json").write_text(json.dumps(out))
    spark.stop()


# -- the JAX side -------------------------------------------------------------------


def _jax_run(outdir: Path, name: str, lora: bool, steps: int = STEPS,
             packed: bool = False) -> dict:
    """The JAX Trainer on one device: the init and final params as port
    state dicts, and the logged losses."""
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
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
    jds = JDataset.parallelize(_examples(packed=packed), num_slices=PARTS)
    jt.init(jt._sample_batch(jds, B))
    init = port(jt)
    logged: list = []
    jt.fit(jds.repeat(), batch_size=B, steps=steps, log_every=1,
           callbacks=[lambda s, m: logged.append(float(m["loss"]))])
    final = port(jt)
    jspark.stop()
    np.savez(outdir / f"{name}_init.npz", **init)
    np.savez(outdir / f"{name}_jax_final.npz", **final)
    return dict(init=init, losses=logged, final=final)


def _jax_mesh(seq: int):
    """The 8-device CPU mesh at ``seq`` (the rest on ``data``)."""
    return JMeshSpec(data=8 // seq, seq=seq).build(jax.devices()[:8])


def _jax_op(impl: str, seq: int, case: str) -> dict:
    """JAX's ring or Ulysses (interpret-mode kernels on each hop) over the
    whole sequence on the 8-device mesh, and JAX's dense attention on one
    device: the outputs and dq/dk/dv of ``sum(o·w)``. The dense side's
    cotangent is zero on the rows no key may reach (its softmax averages
    v there, the kernels' convention is 0)."""
    causal, _, _, _ = OP_CASES[case]
    inp = {k: jnp.asarray(v) for k, v in _op_inputs(case).items()}
    mask, segs = inp.get("mask"), inp.get("segs")
    mesh = _jax_mesh(seq)
    op = jring if impl == "ring" else julysses

    def cp(q, k, v):
        o = op(q, k, v, mesh=mesh, causal=causal, mask=mask, segment_ids=segs,
               use_flash=True)
        return jnp.sum(o * inp["w"]), o

    allowed = jnp.ones((OP_B, 1, OP_S, OP_S), bool)
    if mask is not None:
        allowed = allowed & (mask[:, None, None, :] > 0)
    if segs is not None:
        allowed = allowed & (segs[:, None, :, None] == segs[:, None, None, :])
    causal_ok = jnp.tril(jnp.ones((OP_S, OP_S), bool)) if causal else True
    reach = jnp.any(allowed & causal_ok, axis=-1)[:, 0]            # [B, S]
    w_dense = inp["w"] * reach[:, :, None, None]

    def dense(q, k, v):
        g = OP_H // k.shape[2]
        o = _xla_attention(q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2),
                           bias=None, mask=allowed, causal=causal, scale=None)
        return jnp.sum(o * w_dense), o

    out = {}
    for name, fn in (("cp", cp), ("dense", dense)):
        (_, o), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(
            inp["q"], inp["k"], inp["v"])
        out[name] = dict(o=np.asarray(o), dq=np.asarray(grads[0]),
                         dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))
    out["reach"] = np.asarray(reach)
    return out


@pytest.fixture(scope="module")
@bounded()
def gangs(tmp_path_factory):
    """The JAX one-device runs (their init params seed the gangs), then the
    four gangs: (outdir, JAX runs by name)."""
    outdir = tmp_path_factory.mktemp("gang_cp")
    jruns = {name: _jax_run(outdir, name, name == "lora") for name in ("lora", "full")}
    jruns["packed"] = _jax_run(outdir, "packed", True, steps=3, packed=True)
    for gang, (n, _) in GANGS.items():
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        str(Path(__file__).resolve()), str(outdir), gang])
        assert res.returncode == 0, (gang, res.stderr[-4000:])
    return outdir, jruns


def _rank(outdir, gang: str, r: int) -> dict:
    return json.loads((outdir / f"{gang}_rank{r}.json").read_text())


def _npz(path) -> dict:
    return dict(np.load(path))


# -- the mesh, the plan, the feed and the loss, in process ------------------------------


@pytest.mark.parametrize("axes", [dict(seq=2), dict(seq=4), dict(seq=8),
                                  dict(data=2, seq=2, tensor=2), dict(fsdp=2, seq=-1),
                                  dict(data=-1, seq=2), dict(fsdp=2, seq=2, tensor=2)],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_seq_meshes_are_jax_meshes(axes):
    """Each axis's size and each rank's coordinates on a mesh with ``seq``
    above 1 (a ``-1`` axis included) are the JAX ``MeshSpec``'s over 8
    devices; ``seq_index`` is the rank's ``seq`` coordinate; the batch
    group and the loss group (``data × fsdp × seq``) differ by the ``seq``
    peers."""
    spec = {"data": 1, **axes}
    n = 8 if -1 in spec.values() else int(np.prod(list(spec.values())))
    tspec, jspec = tmesh.MeshSpec(**spec), JMeshSpec(**spec)
    assert tspec.axis_sizes(n) == jspec.axis_sizes(n)
    jm = jspec.build(jax.devices()[:n])
    shape = tspec.shape(n)
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    for r, dev in enumerate(jax.devices()[:n]):
        assert tuple(tmesh.coordinates(shape, r).values()) == where[dev.id]
        assert tmesh.Mesh(shape, rank=r).seq_index == where[dev.id][4]
    batch = tmesh.group_ranks(shape, tmesh.BATCH_AXES)
    loss = tmesh.group_ranks(shape, tmesh.LOSS_AXES)
    assert len(batch[0]) * shape["seq"] == len(loss[0]) and len(loss[0]) > len(batch[0])


def test_plan_with_seq_axis_validates_as_jax():
    """``seq_axis`` is ported: ``plan_for_rules(context_parallel=True)``
    is JAX's record and validates; a seq axis of another name raises."""
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1, seq=2).shape(2))
    plan = tplan.plan_for_rules(tsharding.FSDP, context_parallel=True)
    assert plan.seq_sharded and plan.to_record() == jplan.plan_for_rules(
        jsharding.FSDP, context_parallel=True).to_record()
    plan.validate(mesh)
    with pytest.raises(tplan.PlanValidationError, match="exchange over"):
        tplan.Plan(name="x", seq_axis="data").validate(mesh)


def test_a_seq_mesh_without_context_parallel_raises():
    """A mesh with ``seq`` above 1 and a Trainer without
    ``context_parallel``: every seq peer would train the same whole rows."""
    sess = Session("cp", {}, torch.device("cpu"), tmesh.MeshSpec(data=1, seq=2),
                   world_size=2)
    with pytest.raises(ValueError, match="context_parallel=True"):
        Trainer(sess, tllama.llama_tiny(device="cpu"), losses.causal_lm,
                optim.adamw(1e-3))


def test_seq_shard_cuts_each_row_and_labels_the_whole_row():
    """Block i of n of each leaf of rank ≥ 2, rank-1 leaves whole; the
    next-token labels and weights made from the whole rows first: a
    block's last position takes the next block's first token, the last
    block's last position weighs 0, the shifted ``loss_mask`` elsewhere. A
    sequence that does not divide raises."""
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 9, (2, 8)).astype(np.int32),
             "loss_mask": (rng.random((2, 8)) > 0.3).astype(np.float32),
             "eval_mask": np.ones(2, np.float32)}
    assert tfeed.seq_shard(batch, 0, 1) is batch
    blocks = [tfeed.seq_shard(batch, i, 4) for i in range(4)]
    for i, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk["input_ids"], batch["input_ids"][:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(blk["eval_mask"], batch["eval_mask"])
    ids = np.concatenate([b[tfeed.NEXT_IDS] for b in blocks], 1)
    weight = np.concatenate([b[tfeed.NEXT_MASK] for b in blocks], 1)
    np.testing.assert_array_equal(ids[:, :-1], batch["input_ids"][:, 1:])
    np.testing.assert_array_equal(weight[:, :-1], batch["loss_mask"][:, 1:])
    assert not weight[:, -1].any()
    with pytest.raises(ValueError, match="divide by the seq degree 3"):
        tfeed.seq_shard(batch, 0, 3)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("eval_rows", [False, True])
def test_causal_lm_over_blocks_is_jax_causal_lm_over_whole_rows(n, eval_rows):
    """``causal_lm`` on each block with the labels ``seq_shard`` made: the
    blocks' weighted sums, summed, over the summed weights, are JAX's
    ``causal_lm`` over the whole rows, with ``loss_mask`` and
    ``eval_mask`` (f32 summation order: 1e-6)."""
    rng = np.random.default_rng(n)
    logits = rng.normal(0, 1, (3, 8, 11)).astype(np.float32)
    batch = {"input_ids": rng.integers(0, 11, (3, 8)).astype(np.int32),
             "loss_mask": (rng.random((3, 8)) > 0.3).astype(np.float32)}
    if eval_rows:
        batch["eval_mask"] = np.array([1.0, 0.0, 1.0], np.float32)
    want, wm = jlosses.causal_lm(jnp.asarray(logits),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    total = weight = 0.0
    for i in range(n):
        blk = tfeed.seq_shard(batch, i, n)
        loss, m = losses.causal_lm(torch.from_numpy(_block(logits, i, n).copy()),
                                   {k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in blk.items()})
        total += float(loss) * float(m["weight"])
        weight += float(m["weight"])
    np.testing.assert_allclose(total / weight, float(want), rtol=1e-6)
    assert weight == float(wm["weight"])


def test_the_hop_gate():
    """The kernels run each hop only on a CUDA bf16 tensor with a head dim
    the kernels are built for, and a local sequence that tiles by
    ``min(512, S/N)`` (JAX's ``_flash_hop_qualifies``)."""
    def q(device="cuda", dtype=torch.bfloat16, d=128):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(1, 8, 4, d))
    assert tring.flash_hop_qualifies(q(), 1024)
    assert tring.flash_hop_qualifies(q(d=64), 6)
    assert tring.flash_hop_qualifies(q(), 512)
    assert not tring.flash_hop_qualifies(q(), 768)            # 768 % 512
    assert not tring.flash_hop_qualifies(q(), 0)
    assert not tring.flash_hop_qualifies(q(d=96), 512)
    assert not tring.flash_hop_qualifies(q(dtype=torch.float32), 512)
    assert not tring.flash_hop_qualifies(q(device="cpu"), 512)
    assert [tring.hop_active(r, i, 4, True) for r in range(4) for i in range(4)] == [
        i == 0 or r + i >= 4 for r in range(4) for i in range(4)]
    assert all(tring.hop_active(r, i, 4, False) for r in range(4) for i in range(4))


def test_the_ops_refuse_what_jax_refuses():
    """Bias, a mask that varies over queries, unequal k/v, heads that are
    not whole GQA groups, an explicit ``use_flash=True`` the kernels do not
    take (here: the CPU), and for Ulysses local heads that do not divide by
    the ``seq`` degree (kv heads 2 at seq 4), naming the ring."""
    mesh = tmesh.Mesh(tmesh.MeshSpec(data=1, seq=4).shape(4))
    q = torch.zeros(1, 8, 4, 8)
    kv = torch.zeros(1, 8, 2, 8)
    for op in (tring.ring_attention, tulysses.ulysses_attention):
        with pytest.raises(NotImplementedError, match="bias"):
            op(q, kv, kv, mesh=mesh, bias=torch.zeros(1, 1, 8, 8))
        with pytest.raises(ValueError, match="k/v shapes"):
            op(q, kv, q, mesh=mesh)
        with pytest.raises(ValueError, match="multiple"):
            op(q, q[:, :, :3], q[:, :, :3], mesh=mesh)
    with pytest.raises(ValueError, match="divide by the seq degree"):
        tulysses.ulysses_attention(q, kv, kv, mesh=mesh)
    one = tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1))
    for op in (tring.ring_attention, tulysses.ulysses_attention):
        with pytest.raises(ValueError, match="use_flash=True"):
            op(q, kv, kv, mesh=one, use_flash=True)
        with pytest.raises(NotImplementedError, match="key-only"):
            op(q, kv, kv, mesh=one, mask=torch.ones(1, 1, 8, 8, dtype=torch.bool))


def test_seq_degree_one_is_local_attention():
    """At ``seq`` 1 the ring is one hop with no collective and Ulysses is
    plain attention: both are the one-device kernel's plain version, with
    a mask, GQA and segment ids, forward and gradients (f32: 1e-6)."""
    inp = _op_inputs("segments")
    one = tmesh.Mesh(tmesh.MeshSpec(data=1).shape(1))
    want = None
    for op in (tring.ring_attention, tulysses.ulysses_attention, None):
        q, k, v = (torch.from_numpy(inp[x]).requires_grad_() for x in "qkv")
        mask, segs = torch.from_numpy(inp["mask"]), torch.from_numpy(inp["segs"])
        if op is None:
            o = dot_product_attention(q, k, v, mask=mask[:, None, None, :] > 0,
                                      causal=True, segment_ids=segs, impl="flash")
        else:
            o = op(q, k, v, mesh=one, causal=True, mask=mask, segment_ids=segs)
        (o * torch.from_numpy(inp["w"])).sum().backward()
        got = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
        if want is None:
            want = got
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# -- the ops in the gangs against JAX -----------------------------------------------


@pytest.fixture(scope="module")
@bounded()
def jax_ops():
    """JAX's side of every op run and case."""
    return {(gang, impl, case): _jax_op(impl, n, case)
            for (gang, impl), n in OP_RUNS.items() for case in OP_CASES}


@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("run", sorted(OP_RUNS), ids=lambda r: f"{r[1]}-{r[0]}")
def test_ops_match_jax_cp_and_dense(gangs, jax_ops, run, case):
    """Each rank's block of the output and of dq/dk/dv, put together along
    the sequence, against JAX's ring or Ulysses with its interpret-mode
    kernels on the 8-device mesh, and against JAX's dense attention on one
    device where a key is reachable; the rows no key reaches are 0."""
    outdir, _ = gangs
    gang, impl = run
    n = OP_RUNS[run]
    blocks = [_npz(outdir / f"ops_{gang}_{impl}_{case}_{r}.npz") for r in range(n)]
    got = {k: np.concatenate([b[k] for b in blocks], axis=1) for k in ("o", "dq", "dk", "dv")}
    ref = jax_ops[(gang, impl, case)]
    reach = ref["reach"]
    for k in got:
        np.testing.assert_allclose(got[k], ref["cp"][k], rtol=OP_TOL, atol=OP_TOL, err_msg=k)
        # dense averages v over a row no key reaches; its cotangent there is 0
        sel = reach if k == "o" else slice(None)
        np.testing.assert_allclose(got[k][sel], ref["dense"][k][sel], rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=k)
    unreached = ~reach
    assert unreached.any() == OP_CASES[case][2]
    assert not got["o"][unreached].any() and not got["dq"][unreached].any()


@pytest.mark.parametrize("run", [("seq2", "ring"), ("seq4", "ring")],
                         ids=lambda r: r[0])
def test_inactive_hops_compute_nothing(gangs, run):
    """Under ``causal`` the rank at ``seq`` index r computes hops 0 and
    those past ``N − r``: ``1 + r`` forward and ``1 + r`` backward hops
    (the kernels' launches on the card), every hop without ``causal``; the
    K/V blocks rotate all the same: N − 1 exchanges forward, 2N − 1
    backward (the K/V ones and the dK/dV ones)."""
    outdir, _ = gangs
    gang, impl = run
    n = OP_RUNS[run]
    for case, (causal, *_rest) in OP_CASES.items():
        for r in range(n):
            blk = _npz(outdir / f"ops_{gang}_{impl}_{case}_{r}.npz")
            want = 1 + r if causal else n
            assert blk["hops"].tolist() == [want, want], (case, r)
            assert int(blk["exchanges"]) == 3 * n - 2, (case, r)


def test_ulysses_refuses_kv_heads_that_do_not_divide(gangs):
    """In the ``seq=4`` gang, Ulysses on 4 q heads and 2 kv heads raises
    naming the head counts and the ring, before any all-to-all."""
    outdir, _ = gangs
    for r in range(4):
        msg = _rank(outdir, "seq4", r)["ulysses_refused"]
        assert "(4/2)" in msg and "seq degree (4)" in msg and "ring" in msg


# -- the Trainer in the gangs against JAX's one device -----------------------------


@pytest.mark.parametrize("gang,name,lora", [(g, n, lora) for g in sorted(RUNS)
                                            for n, _, lora in RUNS[g]],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_trainer_matches_jax_one_device(gangs, gang, name, lora):
    """The tiny LoRA and the full fine-tune on each CP mesh: every rank
    logged the same losses, JAX's one-device ones; the final params are
    JAX's; only the adapters moved in the LoRA run."""
    outdir, jruns = gangs
    jrun = jruns["lora" if lora else "full"]
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    got = [r[name]["losses"] for r in ranks]
    assert all(g == got[0] for g in got) and len(got[0]) == STEPS
    np.testing.assert_allclose(got[0], jrun["losses"], rtol=RTOL)
    final = _npz(outdir / f"{gang}_{name}_final.npz")
    assert sorted(final) == sorted(jrun["final"])
    for k, v in final.items():
        change = np.linalg.norm(jrun["final"][k] - jrun["init"][k])
        assert np.linalg.norm(v - jrun["final"][k]) <= PARAM_RTOL * change, k
    moved = [k for k in final if not np.array_equal(final[k], jrun["init"][k])]
    if lora:
        assert sorted(moved) == sorted(k for k in final if tllama.lora_trainable(k))
    else:
        assert len(moved) == len(final)


def test_labels_cross_the_blocks_as_jax_causal_lm(gangs):
    """A ``loss_mask`` with holes and three packed documents a row, at
    ``seq=4`` (8 positions a block): each block's last position labelled
    by the next block's first token, the segment ids riding the ring, and
    the losses are JAX's one-device ``causal_lm`` over the whole rows."""
    outdir, jruns = gangs
    got = [_rank(outdir, "seq4", r)["packed"]["losses"] for r in range(4)]
    assert all(g == got[0] for g in got) and len(got[0]) == 3
    np.testing.assert_allclose(got[0], jruns["packed"]["losses"], rtol=RTOL)


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_positions_and_rows_of_each_rank(gangs, gang):
    """Each rank's RoPE positions are its block's global ones (``seq``
    index · 8 on, for 8 positions), its ``seq`` index its coordinate, and
    its batch index that of its ``data × fsdp`` coordinate."""
    outdir, _ = gangs
    n, conf = GANGS[gang]
    shape = tmesh.spec_from_conf(f"local[{n}]", {k: str(v) for k, v in conf.items()}
                                 ).shape(n)
    for r in range(n):
        rec = _rank(outdir, gang, r)
        c = tmesh.coordinates(shape, r)
        assert rec["mesh"] == shape and rec["seq_index"] == c["seq"]
        assert rec["positions"] == list(range(8 * c["seq"], 8 * c["seq"] + 8))
        assert rec["batch_index"] == c["data"] * shape["fsdp"] + c["fsdp"]


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_each_card_holds_its_shards_and_counts_tokens_once(gangs, gang):
    """Each card's resident bytes are the rule engine's reckoning (the
    ``seq`` peers hold replicas), and tokens/s counts each token once: the
    global batch's tokens over the step time."""
    outdir, _ = gangs
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    model = tllama.LlamaForCausalLM(_tcfg(True), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sizes = {n: p.element_size() for n, p in model.named_parameters()}
    want = tsharding.bytes_per_card(shapes, sizes, tllama.llama_rules(model.cfg),
                                    tmesh.Mesh(ranks[0]["mesh"]))
    for r in ranks:
        run = r["ring_lora"]
        assert run["resident"] == want
        np.testing.assert_allclose(run["tokens_per_sec"], B * S / (run["step_ms"] / 1e3),
                                   rtol=1e-6)
    assert (ranks[0]["ring_lora"]["fsdp_dims"] != {}) == (ranks[0]["mesh"]["fsdp"] > 1)
    assert (ranks[0]["ring_lora"]["tensor_dims"] != {}) == (ranks[0]["mesh"]["tensor"] > 1)


def test_gradients_sum_over_seq_peers(gangs):
    """One step at ``seq=2``, every param trainable, each rank on its block:
    every rank's gradients (the adapters', the norm scales', the base's)
    and grad norm are one process's on the whole rows. Left unsummed over
    the seq peers, each would be one block's part."""
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
    assert any("lora_" in n for n in whole) and any("norm" in n for n in whole)
    for n, want in whole.items():
        assert np.array_equal(parts[0][n], parts[1][n]), n
        scale = float(np.abs(want).max())
        assert scale > 0, n
        np.testing.assert_allclose(parts[0][n], want, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=n)
    for m in meta:
        np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["loss"], float(metrics["loss"]), rtol=1e-6)


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_predict_and_evaluate_see_whole_rows(gangs, gang):
    """After the full fine-tune: ``predict`` gathers each row's blocks and
    rows, every rank yields one process's stream of the final params, and
    ``evaluate``'s sums over the loss group are one process's (f32: 1e-5)."""
    outdir, _ = gangs
    ranks = [_rank(outdir, gang, r) for r in range(GANGS[gang][0])]
    got = [r["ring_full"]["predict"] for r in ranks]
    assert all(g == got[0] for g in got) and len(got[0]) == 8
    evals = [r["ring_full"]["evaluate"] for r in ranks]
    assert all(e == evals[0] for e in evals)
    final = _npz(outdir / f"{gang}_ring_full_final.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(final, False), losses.causal_lm,
                          _tx(optim, False))
        want = _predict(trainer)
        want_eval = trainer.evaluate(_dataset(6, seed=5), batch_size=B)
    assert sorted(got[0]) == sorted(want)
    np.testing.assert_allclose(evals[0]["loss"], want_eval["loss"], rtol=1e-5)


def test_resume_at_fsdp_by_seq_is_bitwise_and_restores_at_one_rank(gangs):
    """The full fine-tune at ``fsdp=2 × seq=2`` restored at step 2 and run
    to 4 is the straight run bitwise; the checkpoint restores into one
    unsharded process with the same params."""
    outdir, _ = gangs
    straight, resumed = (_npz(outdir / f"resume_{r}.npz") for r in ("straight", "resumed"))
    assert sorted(straight) == sorted(resumed)
    for k in straight:
        assert np.array_equal(straight[k], resumed[k]), k
    init = _npz(outdir / "full_init.npz")
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        trainer = Trainer(spark, _port_model(init, False), losses.causal_lm,
                          _tx(optim, False), checkpointer=Checkpointer(outdir / "ckpt"))
        state, data_state = trainer.restore()
        assert state.step == 4 and data_state["examples_seen"] == 4 * B
        for k, p in state.params.items():
            assert np.array_equal(p.detach().numpy(), straight[k]), k


# -- the driver ---------------------------------------------------------------------


def test_driver_runs_ulysses_at_two_ranks(tmp_path):
    """The port's driver at ``local[2]`` with ``--seq-parallel 2 --cp-impl
    ulysses`` on the CPU: the JAX driver's mesh (``seq=2``), the CP
    implementation and the bytes its all-to-alls sent on each card in the
    JSON line, the replicas checked, and the losses of one rank on the
    same batches."""
    args = [str(DRIVER), "--variant", "tiny", "--steps", "3", "--batch-size", "4",
            "--seq-len", "64", "--lora-rank", "4", "--log-every", "1"]
    recs = {}
    for n, extra in ((2, ["--seq-parallel", "2", "--cp-impl", "ulysses"]), (1, [])):
        res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                        "--workdir", str(tmp_path / str(n)), *args, *extra])
        assert res.returncode == 0, res.stderr[-4000:]
        recs[n] = json.loads([x for x in res.stdout.splitlines()
                              if x.startswith('{"train"')][-1])
    rec = recs[2]
    assert rec["world_size"] == 2 and rec["mesh"]["seq"] == 2 and rec["mesh"]["fsdp"] == 1
    assert rec["cp_impl"] == "ulysses" and recs[1]["cp_impl"] is None
    assert rec["replicas_checked"] and rec["step"] == 3
    cards = rec["by_rank"]
    assert cards[0]["cp_bytes_sent"] == cards[1]["cp_bytes_sent"] > 0
    assert recs[1]["by_rank"][0]["cp_bytes_sent"] == 0
    np.testing.assert_allclose(rec["train"]["loss"], recs[1]["train"]["loss"], rtol=RTOL)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])

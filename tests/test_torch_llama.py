"""Llama-2 + LoRA (config 5) in the port against the JAX package on the CPU,
at ``LlamaConfig.tiny`` (4 layers, 128 wide, GQA 4/2, LoRA rank 4 on wq and
wv, f32), the flax weights carried across by ``params_from_flax`` and the
batches made from a seed with numpy:

- the forward's logits, through the plain attention path and through the
  flash path (JAX: its Pallas kernels in interpret mode; the port: the
  kernels' plain versions), with padding and packed segments;
- the adapters' gradients from a nonzero ``lora_b`` (B = 0 at init would
  zero every ``lora_a`` gradient);
- AdamW steps under ``masked(with_grad_clip(...), lora_trainable)`` with
  ``trainable=lora_trainable``, at ``accum_steps`` 1 and 2; frozen params
  take no gradient, no optimizer state and no change;
- weight files: JAX's safetensors export read by the port, the port's
  export read back by the port, by the ``safetensors`` package and by JAX,
  ``merge_lora``; ``Trainer.load_pretrained``'s strict and uncovered
  rules;
- the port's driver through its cli, and the flags it refuses.

f32 throughout: each tolerance is summation order, and says so."""

import json
import logging
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.models import llama_io as jllama_io
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu.train import step as jstep
from distributeddeeplearningspark_tpu.train.state import TrainState as JState
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as tdriver
from distributeddeeplearningspark_tpu_torch.metrics import llama_model_flops_per_token
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.train import step as tstep
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_llama_lora.py"
B, S, RANK = 2, 128, 4
# f32 logits through 4 layers, summed in another order (XLA's and torch's
# matmuls; Pallas interpret against the plain version's one-pass softmax)
LOGIT_ATOL = 1e-4
# gradients of the same loss, per tensor against its largest element
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _jcfg(**kw):
    return jllama.LlamaConfig.tiny(lora_rank=RANK, **kw)


def _tcfg(**kw):
    return tllama.LlamaConfig.tiny(lora_rank=RANK, **kw)


def _batch(rows=B, seed=0, *, pad=False, segments=False):
    rng = np.random.default_rng(seed)
    out = {"input_ids": rng.integers(0, 512, (rows, S)).astype(np.int32),
           "loss_mask": np.ones((rows, S), np.float32)}
    if pad:  # right padding: no query row loses every key
        am = np.ones((rows, S), np.int32)
        am[1, 100:] = 0
        out["attention_mask"] = am
        out["loss_mask"] = am.astype(np.float32)
    if segments:
        seg = np.zeros((rows, S), np.int32)
        seg[:, 40:] = 1
        seg[0, 90:] = 2
        if pad:
            seg[1, 100:] = -1
        out["segment_ids"] = seg
    return out


def _nonzero_b(tree, seed=1):
    """The tree with every ``lora_b`` drawn from a normal(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                    if k == "lora_b" else walk(v) if isinstance(v, dict) else v)
                for k, v in node.items()}

    return walk(tree)


@pytest.fixture(scope="module")
@bounded()
def trees():
    """The flax params of the tiny LoRA model: scanned (the default) and
    unrolled, each with nonzero ``lora_b``."""
    batch = {"input_ids": jnp.zeros((B, S), jnp.int32)}
    out = {}
    for layout, scan in (("scanned", True), ("unrolled", False)):
        model = jllama.LlamaForCausalLM(_jcfg(scan_layers=scan))
        params = model.init(jax.random.PRNGKey(0), batch)["params"]
        out[layout] = _nonzero_b(jax.tree.map(np.asarray, params))
    return out


def _port_model(tree, **kw):
    cfg = _tcfg(**kw)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama_io.params_from_flax(tree, cfg))
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
@pytest.mark.parametrize("impl,extras", [
    ("xla", {}), ("xla", {"pad": True}), ("xla", {"pad": True, "segments": True}),
    ("flash", {}), ("flash", {"pad": True, "segments": True})])
def test_forward_matches_jax(trees, layout, impl, extras):
    tree = trees[layout]
    batch = _batch(**extras)
    jmodel = jllama.LlamaForCausalLM(_jcfg(attention_impl=impl,
                                           scan_layers=layout == "scanned"))
    want = np.asarray(jmodel.apply({"params": tree},
                                   {k: jnp.asarray(v) for k, v in batch.items()}))
    model = _port_model(tree, attention_impl=impl)
    with torch.no_grad():
        got = model(_tbatch(batch)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, S, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_adapter_gradients_match_jax(trees, impl):
    """From nonzero B, through the remat'd layers and a frozen base: every
    adapter's gradient is JAX's, and the base takes none."""
    tree = trees["scanned"]
    batch = _batch(pad=True, segments=True)
    jmodel = jllama.LlamaForCausalLM(_jcfg(attention_impl=impl))

    def jloss(params):
        logits = jmodel.apply({"params": params},
                              {k: jnp.asarray(v) for k, v in batch.items()})
        return jlosses.causal_lm(logits, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    jgrads = tllama_io.params_from_flax(jax.tree.map(
        np.asarray, jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))), _tcfg())
    model = _port_model(tree, attention_impl=impl)
    for name, p in model.named_parameters():
        p.requires_grad_(tllama.lora_trainable(name))
    model.train()
    tlosses.causal_lm(model(_tbatch(batch)), _tbatch(batch))[0].backward()
    adapters = 0
    for name, p in model.named_parameters():
        if not tllama.lora_trainable(name):
            assert p.grad is None, name
            continue
        adapters += 1
        want = jgrads[name].numpy()
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=name)
    assert adapters == 2 * 2 * 4  # A and B of wq and wv in each of 4 layers


def _jax_steps(tree, batches, accum):
    model = jllama.LlamaForCausalLM(_jcfg())
    tx = joptim.masked(joptim.with_grad_clip(
        joptim.adamw(joptim.warmup_cosine(1e-2, 1, len(batches))), 1.0),
        jllama.lora_trainable)
    jp = jax.tree.map(jnp.asarray, tree)
    state = JState.create(params=jp, opt_state=tx.init(jp))
    step = jax.jit(jstep.make_train_step(model.apply, tx, jlosses.causal_lm,
                                         accum_steps=accum,
                                         trainable=jllama.lora_trainable))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, tllama_io.params_from_flax(
        jax.tree.map(np.asarray, state.params), _tcfg())


def _port_steps(tree, batches, accum):
    model = _port_model(tree)
    tx = toptim.masked(toptim.with_grad_clip(
        toptim.adamw(toptim.warmup_cosine(1e-2, 1, len(batches))), 1.0),
        tllama.lora_trainable)
    named = dict(model.named_parameters())
    step = tstep.make_train_step(model, tx, tlosses.causal_lm, accum_steps=accum,
                                 trainable=tllama.lora_trainable)
    names = tstep.optimizer_params(named, tx, tllama.lora_trainable)
    state = TrainState(step=0, params=named,
                       opt_state=tx.init([named[n] for n in names]),
                       generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in named.items()}
    metrics = []
    for b in batches:
        state, m = step(state, _tbatch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        assert all(p.grad is None for p in named.values())
    return metrics, state, before, names


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_steps_match_jax(trees, accum):
    """Three steps (the first at lr 0 under the warmup) of 4 rows, split
    into ``accum`` micro-batches: the loss, grad norm and adapters are
    JAX's; the base is bitwise unchanged and holds no optimizer state."""
    tree = trees["scanned"]
    batches = [_batch(4, seed=s, pad=True, segments=True) for s in range(3)]
    want, jparams = _jax_steps(tree, batches, accum)
    got, state, before, names = _port_steps(tree, batches, accum)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert names == [n for n in state.params if tllama.lora_trainable(n)]
    for n, p in state.params.items():
        if tllama.lora_trainable(n):
            assert not torch.equal(p, before[n]), n
            np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
        else:
            assert not p.requires_grad and torch.equal(p, before[n]), n
    leaves = _tensors(state.opt_state)
    lora = sum(state.params[n].numel() for n in names)
    # Adam's mu and nu only, beside the 0-d counts
    assert sum(t.numel() for t in leaves if t.dim()) == 2 * lora


def _tensors(tree):
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_accumulation_refuses_a_batch_that_does_not_divide(trees):
    model = _port_model(trees["scanned"])
    tx = toptim.masked(toptim.adamw(1e-3), tllama.lora_trainable)
    step = tstep.make_train_step(model, tx, tlosses.causal_lm, accum_steps=2,
                                 trainable=tllama.lora_trainable)
    named = dict(model.named_parameters())
    names = tstep.optimizer_params(named, tx, tllama.lora_trainable)
    state = TrainState(step=0, params=named,
                       opt_state=tx.init([named[n] for n in names]),
                       generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="must divide by accum_steps 2"):
        step(state, _tbatch(_batch(3)))
    jmodel = jllama.LlamaForCausalLM(_jcfg())
    jtx = joptim.adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, trees["scanned"])
    with pytest.raises(ValueError, match="must divide by accum_steps 2"):
        jstep.make_train_step(jmodel.apply, jtx, jlosses.causal_lm, accum_steps=2)(
            JState.create(params=jp, opt_state=jtx.init(jp)),
            {k: jnp.asarray(v) for k, v in _batch(3).items()})


def test_masked_must_be_the_outermost_transformation():
    tx = toptim.masked(toptim.adamw(1e-3), tllama.lora_trainable)
    with pytest.raises(ValueError, match="outermost"):
        toptim.with_grad_clip(tx, 1.0)
    assert toptim.updated_by(tx)("layers.0.attention.wq.lora_a")
    assert not toptim.updated_by(tx)("layers.0.attention.wq.weight")
    assert toptim.updated_by(toptim.adamw(1e-3))("anything")


#: what the port refuses (and how), or None for what it now builds
_BUILT = None


@pytest.mark.parametrize("fields,refusal", [
    pytest.param(dict(moe_experts=4, fused_head_loss=True), _BUILT,
                 id="moe_experts-4-fused_head_loss-True"),
    pytest.param(dict(base_quant="int8"), _BUILT, id="base_quant-int8"),
    pytest.param(dict(decode=True), _BUILT, id="decode-True"),
    pytest.param(dict(fused_head_loss=True), _BUILT, id="fused_head_loss-True"),
    pytest.param(dict(attention_impl="ring", moe_experts=4),
                 (NotImplementedError, "ROADMAP Queue 1 item"),
                 id="attention_impl-ring-moe_experts-4"),
    pytest.param(dict(attention_impl="ulysses", decode=True), _BUILT,
                 id="attention_impl-ulysses-decode-True")])
def test_model_refuses_what_is_not_ported(fields, refusal):
    """What the port lacks raises by name: MoE under context parallelism.
    The fused head loss (with MoE too), the int8 base and the decode mode
    (beside Ulysses too: decode attends with the plain path) are ported and
    build (``test_torch_fused_ce.py``, ``test_torch_qlora.py``,
    ``test_torch_llama_gen.py``)."""
    if refusal is _BUILT:
        model = tllama.LlamaForCausalLM(_tcfg(**fields), device="cpu")
        assert all(getattr(model.cfg, k) == v for k, v in fields.items())
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        tllama.LlamaForCausalLM(_tcfg(**fields), device="cpu")


def test_configs_and_flops_match_jax():
    """The published widths, LoRA's bf16 base storage, and the model FLOPs
    a token (the port's copy of JAX's count)."""
    for name in ("llama2_7b", "llama2_13b", "tiny"):
        j = getattr(jllama.LlamaConfig, name)(lora_rank=16)
        t = getattr(tllama.LlamaConfig, name)(lora_rank=16)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "num_kv_heads", "intermediate_size", "max_position",
                  "rope_theta", "rms_eps", "lora_alpha", "head_dim"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert tuple(t.lora_targets) == tuple(j.lora_targets)
        assert str(t.param_dtype).split(".")[-1] == jnp.dtype(j.param_dtype).name
        for frozen in (True, False):
            from distributeddeeplearningspark_tpu import metrics as jmetrics

            assert llama_model_flops_per_token(t, 1024, frozen_base=frozen) == \
                jmetrics.llama_model_flops_per_token(j, 1024, frozen_base=frozen)
    assert tllama.LlamaConfig.llama2_7b().param_dtype == torch.float32


def test_rotary_embedding_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 3, 8)).astype(np.float32)
    pos = np.arange(16)[None, :]
    want = np.asarray(jllama.rotary_embedding(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = tllama.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- weight files ------------------------------------------------------------------


def _base(params):
    return {k: v for k, v in params.items() if ".lora_" not in k}


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_jax_export_reads_into_the_port(trees, layout, tmp_path):
    tree = trees[layout]
    cfg = _tcfg()
    path = str(tmp_path / "model.safetensors")
    jllama_io.export_llama_safetensors(tree, _jcfg(scan_layers=layout == "scanned"),
                                       path)
    got = tllama_io.load_llama_safetensors(path, cfg)
    want = _base(tllama_io.params_from_flax(tree, cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_port_export_reads_back_bitwise_and_into_jax(trees, tmp_path):
    cfg = _tcfg()
    params = tllama_io.params_from_flax(trees["scanned"], cfg)
    path = str(tmp_path / "port.safetensors")
    tllama_io.export_llama_safetensors(params, cfg, path)
    back = tllama_io.load_llama_safetensors(path, cfg)
    assert sorted(back) == sorted(_base(params))
    assert all(torch.equal(back[k], params[k]) for k in back)
    from safetensors.numpy import load_file

    theirs = load_file(path)  # the reference reader takes the port's bytes
    assert theirs["model.layers.2.self_attn.q_proj.weight"].tobytes() == \
        params["layers.2.attention.wq.weight"].numpy().tobytes()
    jtree = jllama_io.load_llama_safetensors(path, _jcfg())
    jback = _base(tllama_io.params_from_flax(jtree, cfg))
    assert all(torch.equal(jback[k], params[k]) for k in jback)


def test_bf16_and_shard_directories_round_trip(trees, tmp_path):
    """bf16 written as its raw 16 bits and read back bitwise (by the port
    and by ``safetensors.torch``); a HF shard directory through its
    index."""
    cfg = _tcfg(param_dtype=torch.bfloat16)
    params = {k: (v.to(torch.bfloat16) if not k.endswith(".scale") else v)
              for k, v in _base(tllama_io.params_from_flax(trees["scanned"],
                                                           cfg)).items()}
    one = tmp_path / "one.safetensors"
    tllama_io.export_llama_safetensors(params, cfg, str(one))
    back = tllama_io.load_llama_safetensors(str(one), cfg)
    assert all(back[k].dtype == params[k].dtype and torch.equal(back[k], params[k])
               for k in params)
    from safetensors.torch import load_file

    assert torch.equal(load_file(str(one))["lm_head.weight"], params["lm_head.weight"])
    shards = tmp_path / "shards"
    shards.mkdir()
    tensors = load_file(str(one))
    names = sorted(tensors)
    halves = {"a.safetensors": names[::2], "b.safetensors": names[1::2]}
    for f, keys in halves.items():
        tllama_io.write_safetensors({k: tensors[k] for k in keys}, str(shards / f))
    (shards / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, keys in halves.items() for k in keys}}))
    again = tllama_io.load_llama_safetensors(str(shards), cfg)
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_merge_lora_matches_jax(trees):
    cfg = _tcfg()
    tree = trees["scanned"]
    want = tllama_io.params_from_flax(jllama_io.merge_lora(tree, _jcfg()), cfg)
    got = tllama_io.merge_lora(tllama_io.params_from_flax(tree, cfg), cfg)
    assert sorted(got) == sorted(want) and not any(".lora_" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


# -- Trainer.load_pretrained ---------------------------------------------------------


@pytest.fixture
def cpu_trainer():
    spark = Session.builder.master("local[1]").appName("llama").config(
        DEVICE_CONF, "cpu").getOrCreate()
    model = tllama.llama_tiny(device="cpu", lora_rank=RANK)
    tx = toptim.masked(toptim.adamw(1e-3), tllama.lora_trainable)
    yield Trainer(spark, model, tlosses.causal_lm, tx, trainable=tllama.lora_trainable)
    spark.stop()


def test_load_pretrained_overlays_in_place(trees, cpu_trainer, caplog):
    base = _base(tllama_io.params_from_flax(trees["scanned"], _tcfg()))
    with pytest.raises(RuntimeError, match="init"):
        cpu_trainer.load_pretrained(base)
    state = cpu_trainer.init()
    live = dict(state.params)
    lora = {k: v.detach().clone() for k, v in live.items() if ".lora_" in k}
    with caplog.at_level(logging.WARNING):
        cpu_trainer.load_pretrained(base, strict=True)  # the adapters may stay
    assert not caplog.records
    for k, v in cpu_trainer.state.params.items():
        assert v is live[k]  # in place: the optimizer's tensors stay the params
        assert torch.equal(v, base[k] if k in base else lora[k]), k


@pytest.mark.parametrize("case", ["extra", "uncovered", "adapters_not_allowed"])
def test_load_pretrained_strict_and_uncovered_rules(trees, cpu_trainer, case, caplog):
    base = _base(tllama_io.params_from_flax(trees["scanned"], _tcfg()))
    kw = {}
    if case == "extra":
        base["layers.9.attention.wq.weight"] = base["layers.0.attention.wq.weight"]
    elif case == "uncovered":
        del base["lm_head.weight"]
    else:
        kw["allow_uncovered"] = ()
    cpu_trainer.init()
    with pytest.raises(ValueError, match="pretrained overlay mismatch"):
        cpu_trainer.load_pretrained(base, strict=True, **kw)
    with caplog.at_level(logging.WARNING):
        cpu_trainer.load_pretrained(base, **kw)
    want = {"extra": "ignored 1 pretrained keys",
            "uncovered": "1 model params not covered",
            "adapters_not_allowed": "16 model params not covered"}[case]
    assert want in caplog.text


def test_load_pretrained_checks_shapes_and_buffers(trees, cpu_trainer):
    cpu_trainer.init()
    with pytest.raises(ValueError, match="shape"):
        cpu_trainer.load_pretrained({"final_norm.scale": torch.ones(7)})
    with pytest.raises(ValueError, match="no buffers"):
        cpu_trainer.load_pretrained({}, batch_stats={"x": torch.ones(1)})


# -- the driver --------------------------------------------------------------------


def _run_cli(args, deadline_s=200):
    cmd = [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.cli", *args]
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the driver ran past {deadline_s} s: {err[-2000:]}")
    return proc.returncode, out, err


def test_driver_trains_through_the_cli_on_the_cpu(tmp_path):
    code, out, err = _run_cli([
        "--master", "local[1]", "--conf", f"{DEVICE_CONF}=cpu",
        "--workdir", str(tmp_path), str(DRIVER), "--variant", "tiny",
        "--steps", "4", "--batch-size", "4", "--seq-len", "64",
        "--lora-rank", "4", "--accum-steps", "2", "--segment-ids",
        "--log-every", "2", "--lr", "1e-2"])
    assert code == 0, err[-3000:]
    rec = json.loads([x for x in out.splitlines() if x.startswith('{"train"')][-1])
    assert rec["step"] == 4 and rec["device"] == "cpu" and rec["world_size"] == 1
    assert rec["variant"] == "tiny" and np.isfinite(rec["train"]["loss"])
    # only the adapters train: A [128, 4] and B [4, 128] (wq), B [4, 64] (wv)
    assert rec["trainable_params"] == 4 * (128 * 4 + 4 * 128 + 128 * 4 + 4 * 64)
    # "auto" picks the plain path off the card
    assert rec["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                     "flash_bwd_dkv": 0}


@pytest.mark.parametrize("flag,refused", [
    (["--weights", "w"], "parse"), (["--tokenizer", "t"], "parse"),
    (["--seq-parallel", "2", "--pipeline", "2"], "session"),
    (["--microbatches", "2"], None), (["--moe-experts", "4", "--microbatches", "2"], None),
    (["--moe-experts", "4", "--moe-group", "8", "--fused-head-loss"], None),
    (["--moe-experts", "4", "--expert", "2", "--sample-tokens", "8"], None),
    (["--base-quant", "int8"], None), (["--fused-head-loss"], None),
    (["--sample-tokens", "8"], None),
    (["--seq-parallel", "2", "--moe-experts", "4", "--expert", "2", "--weights", "w"],
     "parse"),
    (["--tensor", "2", "--pipeline", "2"], None),
    (["--seq-parallel", "2", "--cp-impl", "ulysses", "--microbatches", "2"], None),
    (["--pipeline", "2"], None),
    (["--seq-parallel", "2", "--cp-impl", "ulysses", "--pipeline", "2"], "session")])
def test_driver_refuses_what_is_not_ported(flag, refused, capsys, monkeypatch):
    """What the port has not ported fails at parse time naming its ROADMAP
    item; the pipeline's flags, the int8 base, the fused head and the
    sampling after fit are ported and parse, and the session refuses the
    pipeline beside context parallelism naming Queue 1 item 10."""
    if refused == "parse":
        with pytest.raises(SystemExit) as e:
            tdriver.parse_args(["--variant", "tiny", *flag])
        assert e.value.code == 2
        assert "ROADMAP Queue 1 item" in capsys.readouterr().err
        return
    args = tdriver.parse_args(["--variant", "tiny", *flag])
    assert args.pipeline == (2 if "--pipeline" in flag else 1)
    assert args.microbatches == (2 if "--microbatches" in flag else 0)
    assert args.base_quant == ("int8" if "--base-quant" in flag else None)
    assert args.fused_head_loss == ("--fused-head-loss" in flag)
    if refused == "session":
        monkeypatch.setenv("DLS_CONF_spark__dls__device", "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
            tdriver.make_session(args)


@pytest.mark.parametrize("flags,words", [
    (["--expert", "2"], "--expert > 1 without --moe-experts just replicates"),
    (["--moe-group", "8"], "--moe-group only applies to the MoE router"),
    (["--moe-experts", "6", "--expert", "4"],
     "--moe-experts 6 must divide by --expert 4 (expert-dim sharding)"),
    (["--moe-experts", "4", "--pipeline", "2"],
     "--moe-experts is not supported with --pipeline (the stage forward drops"),
    (["--base-quant", "int8", "--lora-rank", "0"],
     "--base-quant requires --lora-rank > 0"),
    (["--base-quant", "int8", "--moe-experts", "4"],
     "the expert bank, frozen with the base under LoRA")])
def test_driver_keeps_the_jax_drivers_moe_refusals(flags, words, capsys):
    """The JAX driver's parse-time refusals, in its words (but for MoE
    beside the int8 base, whose reason the port words for its LoRA run)."""
    with pytest.raises(SystemExit) as e:
        tdriver.parse_args(["--variant", "tiny", *flags])
    assert e.value.code == 2
    assert words in capsys.readouterr().err


def test_driver_takes_the_moe_flags():
    args = tdriver.parse_args(["--variant", "7b", "--moe-experts", "8", "--moe-group",
                               "64", "--expert", "4", "--lora-rank", "16"])
    cfg = tdriver.make_config(args, 2048)
    assert (cfg.moe_experts, cfg.moe_group_size, cfg.moe_top_k, args.expert) == \
        (8, 64, 2, 4)
    assert cfg.param_dtype == torch.bfloat16


def test_driver_takes_the_jax_drivers_flags():
    args = tdriver.parse_args(["--variant", "7b", "--steps", "3", "--batch-size", "8",
                               "--seq-len", "1024", "--lr", "2e-4", "--lora-rank",
                               "16", "--lora-alpha", "32", "--accum-steps", "2",
                               "--segment-ids", "--corpus", "c.txt", "--fsdp", "1"])
    cfg = tdriver.make_config(args, 2048)
    assert (cfg.hidden_size, cfg.num_layers, cfg.lora_rank, cfg.lora_alpha) == \
        (4096, 32, 16, 32.0)
    assert cfg.param_dtype == torch.bfloat16
    with pytest.raises(SystemExit, match="exceeds model vocab"):
        tdriver.make_config(args, 40000)

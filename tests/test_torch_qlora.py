"""The int8 frozen base in the port (``LlamaConfig.base_quant="int8"``,
``llama_io.quantize_base_int8``, the Llama driver's ``--base-quant
int8``) against the JAX package on the CPU, at ``LlamaConfig.tiny``
(LoRA rank 4 on wq/wv, f32 compute), inputs made from a seed with numpy:

- ``quantize_base_int8`` of a dense state dict: **bitwise** JAX's int8
  kernels and scales (carried across by ``params_from_flax``, which reads
  JAX's ``base_q8``/``base_scale``);
- the tiny int8 model from JAX's int8 init: the logits and the adapters'
  gradients against JAX's ``base_quant="int8"`` model;
- the port's own init (JAX's shared step q0, ±127), a train step that
  moves only the adapters, a checkpoint round trip of the int8 leaves,
  ``llama_rules``' int8 entries, and JAX's refusals (``lora_rank`` 0,
  MoE, export and ``merge_lora`` of an int8 state dict);
- the driver through the port's cli with ``--base-quant int8
  --fused-head-loss``, and on 2-rank gloo gangs with ``--base-quant int8``
  at ``fsdp=2`` (FSDP2 takes the int8 params) and at ``tensor=2``
  (``DTensor`` splits of them): the losses one rank's on the same
  batches; ``--fused-head-loss`` at ``fsdp=2`` refused naming its ROADMAP
  item.

Tolerances: f32 through 4 layers, the same dequantised weights, summed
in another order (XLA's and torch's matmuls): the logits at 1e-4, each
gradient at 1e-4 of its largest element (``test_torch_llama``'s)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.models import llama_io as jllama_io
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.parallel.sharding import P
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses

from test_torch_deadline import per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_llama_lora.py"
RANK, B, S = 4, 2, 64
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _nonzero_b(tree, seed=1):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (rng.normal(0, 0.05, np.shape(v)).astype(np.float32) if k == "lora_b"
                    else walk(v) if isinstance(v, dict) else np.asarray(v))
                for k, v in node.items()}

    return walk(tree)


def _jax_tree(**kw):
    model = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(lora_rank=RANK, **kw))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": jnp.zeros((B, S), jnp.int32)})
    return _nonzero_b(jax.tree.map(np.asarray, params["params"]))


def _batch():
    rng = np.random.default_rng(3)
    mask = np.ones((B, S), np.float32)
    mask[0, 40:] = 0
    return {"input_ids": rng.integers(0, 512, (B, S)).astype(np.int32), "loss_mask": mask}


@pytest.mark.parametrize("scan", [True, False])
def test_quantize_base_int8_is_jax_bitwise(scan):
    dense = _jax_tree(scan_layers=scan)
    want = tllama_io.params_from_flax(jllama_io.quantize_base_int8(dense),
                                      tllama.LlamaConfig.tiny(lora_rank=RANK))
    got = tllama_io.quantize_base_int8(
        tllama_io.params_from_flax(dense, tllama.LlamaConfig.tiny(lora_rank=RANK)))
    assert got.keys() == want.keys()
    q8 = [n for n in got if n.endswith(".base_q8")]
    assert len(q8) == 4 * 7 and not any(n.endswith(".weight") and "layers." in n
                                        and "norm" not in n for n in got)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert all(got[n].dtype == torch.int8 and got[n].abs().max() == 127 for n in q8)


def _int8_port(tree, **kw):
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK, base_quant="int8", **kw)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama_io.params_from_flax(tree, cfg))
    return model


def test_int8_model_matches_jax():
    """JAX's int8 init (its qinit draw and shared scale) carried across:
    the logits, and from nonzero B the adapters' gradients; the int8 base
    takes none."""
    tree = _jax_tree(base_quant="int8")
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(lora_rank=RANK,
                                                             base_quant="int8"))
    want = np.asarray(jmodel.apply({"params": tree}, jb))
    model = _int8_port(tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)

    def jloss(params):
        return jlosses.causal_lm(jmodel.apply({"params": params}, jb), jb)[0]

    # JAX's gradient of the adapters alone (the int8 leaves take none)
    jgrads = jax.grad(lambda lp: jloss(_merge(tree, lp)))(_lora_only(tree))
    jflat = tllama_io.params_from_flax(_merge(tree, jax.tree.map(np.asarray, jgrads)),
                                       tllama.LlamaConfig.tiny(lora_rank=RANK,
                                                               base_quant="int8"))
    for n, p in model.named_parameters():
        p.requires_grad_(tllama.lora_trainable(n))
    model.train()
    tlosses.causal_lm(model(tb), tb)[0].backward()
    checked = 0
    for n, p in model.named_parameters():
        if not tllama.lora_trainable(n):
            assert p.grad is None, n
            continue
        w = jflat[n].numpy()
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=n)
        checked += 1
    assert checked == 16


def _lora_only(tree):
    return {k: (_lora_only(v) if isinstance(v, dict) else v) for k, v in tree.items()
            if isinstance(v, dict) or k.startswith("lora_")}


def _merge(tree, lora):
    return {k: (_merge(v, lora.get(k, {})) if isinstance(v, dict)
                else lora.get(k, v) if k.startswith("lora_") else v)
            for k, v in tree.items()}


def test_port_init_train_step_and_checkpoint(tmp_path):
    """The port's own init rounds the dense draw at JAX's q0 = 4/√in/127
    and clips at ±127; a LoRA step through the Trainer moves the adapters
    only; the checkpoint holds the int8 leaves and restores them bitwise."""
    from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.train import optim

    model = tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK, base_quant="int8")
    wq = model.layers[0].attention.wq
    assert wq.base_q8.dtype == torch.int8 and not wq.base_q8.requires_grad
    assert not hasattr(wq, "weight") and wq.base is wq.base_q8
    q0 = 4.0 / np.sqrt(128) / 127.0
    assert torch.all(wq.base_scale == torch.tensor(q0, dtype=torch.float32))
    assert int(wq.base_q8.abs().max()) <= 127 and int(wq.base_q8.abs().max()) > 20
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rows = [{"input_ids": r} for r in _batch()["input_ids"]] * 4
    tx = optim.masked(optim.adamw(1e-2), tllama.lora_trainable)
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        ckpt = Checkpointer(tmp_path / "ckpt", async_save=False)
        trainer = Trainer(spark, model, tlosses.causal_lm, tx,
                          trainable=tllama.lora_trainable, checkpointer=ckpt)
        state, summary = trainer.fit(PartitionedDataset.parallelize(rows, 1), batch_size=B,
                                     steps=2, checkpoint_every=2)
        assert np.isfinite(summary["loss"])
        for n, p in state.params.items():
            moved = not torch.equal(p, before[n])
            assert moved == (tllama.lora_trainable(n) and "lora_b" in n) or \
                (moved and "lora_a" in n), n
        again = Trainer(spark, tllama.llama_tiny(device="cpu", seed=5, lora_rank=RANK,
                                                 base_quant="int8"),
                        tlosses.causal_lm, tx, trainable=tllama.lora_trainable,
                        checkpointer=ckpt)
        restored, _ = again.restore()
        for n, p in state.params.items():
            assert restored.params[n].dtype == p.dtype and torch.equal(restored.params[n], p), n
        ckpt.close()


def test_llama_rules_take_the_int8_layout():
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK, base_quant="int8")
    rules = tllama.llama_rules(cfg, fsdp=False)

    class _M:
        shape = {"data": 1, "fsdp": 1, "pipe": 1, "expert": 1, "seq": 1, "tensor": 2}

    want = {"layers/0/attention/wq/base_q8": P("tensor", None),
            "layers/0/attention/wq/base_scale": P("tensor"),
            "layers/0/attention/wo/base_q8": P(None, "tensor"),
            "layers/0/attention/wo/base_scale": P(None),
            "layers/0/mlp/up/base_q8": P("tensor", None),
            "layers/0/mlp/up/base_scale": P("tensor"),
            "layers/0/mlp/down/base_q8": P(None, "tensor"),
            "layers/0/mlp/down/base_scale": P(None)}
    for path, spec in want.items():
        shape = (128, 128) if path.endswith("q8") else (128,)
        assert tuple(rules.spec_for(path, shape, _M())) == tuple(spec), path


@pytest.mark.parametrize("fields,error,match", [
    (dict(lora_rank=0), ValueError, "requires lora_rank > 0"),
    (dict(base_quant="int4"), ValueError, "unknown base_quant"),
    (dict(moe_experts=4), NotImplementedError, "no int8 form")])
def test_model_keeps_jaxs_int8_refusals(fields, error, match):
    kw = dict(lora_rank=RANK, base_quant="int8")
    kw.update(fields)
    with pytest.raises(error, match=match):
        tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**kw), device="cpu")


def test_int8_state_dicts_are_neither_exported_nor_merged(tmp_path):
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK, base_quant="int8")
    sd = tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK,
                           base_quant="int8").state_dict()
    with pytest.raises(NotImplementedError, match="export the dense state dict"):
        tllama_io.export_llama_safetensors(sd, cfg, str(tmp_path / "x.safetensors"))
    with pytest.raises(NotImplementedError, match="merge on the dense"):
        tllama_io.merge_lora(sd, cfg)


# -- the driver --------------------------------------------------------------------------


def _driver(tmp_path, n: int, *flags) -> dict:
    res = run_gang(["--master", f"local[{n}]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(tmp_path), str(DRIVER), "--variant", "tiny",
                    "--steps", "3", "--batch-size", "4", "--seq-len", "64",
                    "--lora-rank", "4", "--log-every", "1", "--source-partitions", "2",
                    *flags], env={"OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads([x for x in res.stdout.splitlines() if x.startswith('{"train"')][-1])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _driver(tmp_path_factory.mktemp("one"), 1, "--base-quant", "int8")


def test_driver_takes_the_int8_base_and_the_fused_head(tmp_path, one_rank):
    rec = _driver(tmp_path, 1, "--base-quant", "int8", "--fused-head-loss")
    assert rec["base_quant"] == "int8" and rec["fused_head_loss"] is True
    assert rec["step"] == 3 and np.isfinite(rec["train"]["loss"])
    assert rec["param_bytes"] == rec["by_rank"][0]["param_bytes_reckoned"]
    np.testing.assert_allclose(rec["train"]["loss"], one_rank["train"]["loss"], rtol=1e-5)


@pytest.mark.parametrize("layout", [["--fsdp", "-1"], ["--tensor", "2"]])
def test_int8_base_on_a_gang_is_one_ranks(tmp_path, one_rank, layout):
    """FSDP2 and ``DTensor`` take the int8 params: at ``fsdp=2`` the base
    is sharded, at ``tensor=2`` split, and the losses are one rank's on the
    same batches (f32, summation order)."""
    rec = _driver(tmp_path, 2, "--base-quant", "int8", *layout)
    assert rec["sharded_params"] > 0 and rec["replicas_checked"]
    assert rec["by_rank"][0]["param_bytes"] == rec["by_rank"][0]["param_bytes_reckoned"]
    np.testing.assert_allclose(rec["train"]["loss"], one_rank["train"]["loss"], rtol=1e-5)


def test_fused_head_beside_a_sharded_head_is_refused(tmp_path):
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(tmp_path), str(DRIVER), "--variant", "tiny",
                    "--steps", "2", "--batch-size", "4", "--seq-len", "64",
                    "--lora-rank", "4", "--fused-head-loss"],
                   env={"OMP_NUM_THREADS": "1"})
    assert res.returncode != 0
    assert "fused_head_loss with the head's weight sharded" in res.stderr
    assert "ROADMAP Queue 1 item 5" in res.stderr

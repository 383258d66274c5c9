"""The fused head loss in the port (``train/fused_ce.py``,
``losses.causal_lm_fused``, ``LlamaConfig.fused_head_loss``) against the
JAX package on the CPU, inputs made from a seed with numpy:

- ``chunked_softmax_xent`` against JAX's: the per-token losses and both
  gradients (``dh``, ``dW``), with f32 and bf16 hidden states, a prime
  vocabulary (257: the last chunk short, and past it none), a vocabulary
  that divides, duplicate labels, ``num_chunks`` 1 and 16;
- ``causal_lm_fused`` on the tiny Llama with ``fused_head_loss=True``
  against the port's ``causal_lm`` on the same model unfused: the loss,
  the metrics and the adapters' gradients; and JAX's fused model's loss;
- ``predict`` of a fused model: the logits, as JAX's predict step makes
  them; the losses' refusals of each other's outputs;
- the FLOPs the port counts (``metrics.counting_flops``): the chunked
  head's 2·N·H·V a product, the backward's recompute of each chunk's
  logits included.

Tolerances: f32 values differ by summation order only (1e-5 relative);
bf16 hidden states make the same exact products in both (f32
accumulation), and ``dh`` is rounded to bf16 at the end, so it may differ
by one bf16 ulp (2**-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.train import fused_ce as jfused
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import metrics
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.train import fused_ce as tfused
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses

from test_torch_deadline import per_test

N, H = 24, 32
#: f32: summation order only
F32_RTOL = 1e-5
#: a bf16 dh: one bf16 ulp of the tensor's largest element
BF16_DH_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _inputs(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, H)).astype(np.float32)
    k = (rng.standard_normal((H, vocab)) * 0.3).astype(np.float32)  # JAX's [H, V]
    labels = rng.integers(0, vocab, N).astype(np.int32)
    labels[1] = labels[0]  # duplicates: their dW columns sum
    labels[2] = labels[0]
    labels[3] = vocab - 1  # the last (padded) chunk's last real column
    g = rng.standard_normal(N).astype(np.float32)
    return h, k, labels, g


def _jax(h, k, labels, g, dtype, chunks):
    def f(h_, k_):
        return jnp.sum(jfused.chunked_softmax_xent(h_.astype(dtype), k_, labels,
                                                   num_chunks=chunks) * g)

    loss = jfused.chunked_softmax_xent(jnp.asarray(h).astype(dtype), jnp.asarray(k),
                                       jnp.asarray(labels), num_chunks=chunks)
    dh, dk = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(k))
    return np.asarray(loss), np.asarray(dh, np.float32), np.asarray(dk)


@pytest.mark.parametrize("vocab", [257, 512])
@pytest.mark.parametrize("chunks", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_softmax_xent_matches_jax(vocab, chunks, dtype):
    h, k, labels, g = _inputs(vocab)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want_loss, want_dh, want_dk = _jax(h, k, labels, g, jdt, chunks)
    th = torch.tensor(h).to(tdt).requires_grad_(True)
    tw = torch.tensor(np.ascontiguousarray(k.T)).requires_grad_(True)  # [V, H]
    loss = tfused.chunked_softmax_xent(th, tw, torch.tensor(labels), num_chunks=chunks)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    (loss * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=F32_RTOL,
                               atol=F32_RTOL)
    assert th.grad.dtype == tdt and tw.grad.dtype == torch.float32
    dh = th.grad.float().numpy()
    tol = F32_RTOL if dtype == "float32" else BF16_DH_RTOL
    np.testing.assert_allclose(dh, want_dh, rtol=0, atol=tol * np.abs(want_dh).max())
    np.testing.assert_allclose(tw.grad.numpy().T, want_dk, rtol=0,
                               atol=F32_RTOL * np.abs(want_dk).max())


def test_chunked_softmax_xent_is_the_plain_cross_entropy():
    """Against the plain path (logits made, ``F.cross_entropy``), which
    JAX's ``causal_lm`` computes too; a frozen weight takes no dW and the
    chunks never exceed ⌈V/num_chunks⌉ columns."""
    h, k, labels, g = _inputs(257, seed=3)
    th = torch.tensor(h).requires_grad_(True)
    w = torch.tensor(np.ascontiguousarray(k.T))
    got = tfused.chunked_softmax_xent(th, w, torch.tensor(labels).long(), num_chunks=7)
    ref_h = torch.tensor(h).requires_grad_(True)
    want = torch.nn.functional.cross_entropy(ref_h @ w.T, torch.tensor(labels).long(),
                                             reduction="none")
    torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_RTOL)
    (got * torch.tensor(g)).sum().backward()
    (want * torch.tensor(g)).sum().backward()
    torch.testing.assert_close(th.grad, ref_h.grad, rtol=F32_RTOL, atol=F32_RTOL)
    assert tfused._slices(257, 16)[-1] == (255, 257) and len(tfused._slices(17, 16)) == 9
    assert tfused._chunk_geometry(257, 16) == (16, 17)


def test_shapes_are_checked():
    w = torch.zeros(10, H)
    with pytest.raises(ValueError, match="weight must be"):
        tfused.chunked_softmax_xent(torch.zeros(3, H + 1), w, torch.zeros(3).long())
    with pytest.raises(ValueError, match="labels shape"):
        tfused.chunked_softmax_xent(torch.zeros(3, H), w, torch.zeros(4).long())


# -- the model and the loss ------------------------------------------------------------


RANK, B, S = 4, 2, 64


def _tree():
    model = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(lora_rank=RANK))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": jnp.zeros((B, S), jnp.int32)})
    rng = np.random.default_rng(1)

    def walk(node):
        return {k: (rng.normal(0, 0.05, np.shape(v)).astype(np.float32) if k == "lora_b"
                    else walk(v) if isinstance(v, dict) else np.asarray(v))
                for k, v in node.items()}

    return walk(jax.tree.map(np.asarray, params["params"]))


def _batch():
    rng = np.random.default_rng(2)
    mask = np.ones((B, S), np.float32)
    mask[1, 50:] = 0
    return {"input_ids": rng.integers(0, 512, (B, S)).astype(np.int32), "loss_mask": mask}


def _port(tree, **kw):
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK, **kw)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama_io.params_from_flax(tree, cfg))
    for n, p in model.named_parameters():
        p.requires_grad_(tllama.lora_trainable(n))
    return model.train()


def test_causal_lm_fused_is_causal_lm_on_the_same_model():
    tree, batch = _tree(), _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, out = {}, {}
    for fused in (False, True):
        model = _port(tree, fused_head_loss=fused)
        outputs = model(tb)
        if fused:
            assert tfused.is_fused_output(outputs) and set(outputs) == {"hidden", "lm_head"}
            assert outputs["lm_head"] is model.lm_head.weight
            loss, m = tlosses.causal_lm_fused(outputs, tb)
        else:
            loss, m = tlosses.causal_lm(outputs, tb)
        loss.backward()
        out[fused] = {k: float(v.detach()) for k, v in m.items()}
        grads[fused] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    assert out[True].keys() == out[False].keys() == {"loss", "perplexity", "weight"}
    for k in out[False]:
        np.testing.assert_allclose(out[True][k], out[False][k], rtol=F32_RTOL)
    assert grads[True].keys() == grads[False].keys() and len(grads[True]) == 16
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))
    # JAX's fused model and loss on the same tree and batch
    jmodel = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(lora_rank=RANK,
                                                             fused_head_loss=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jlosses.causal_lm_fused(jmodel.apply({"params": tree}, jb, train=True), jb)[0]
    np.testing.assert_allclose(out[True]["loss"], float(jloss), rtol=F32_RTOL)


def test_the_losses_refuse_each_others_outputs():
    tree, batch = _tree(), _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        fused = _port(tree, fused_head_loss=True)(tb)
        logits = _port(tree)(tb)
    with pytest.raises(TypeError, match="causal_lm_fused"):
        tlosses.causal_lm(fused, tb)
    with pytest.raises(TypeError, match="fused_head_loss=True"):
        tlosses.causal_lm_fused(logits, tb)


def test_moe_model_returns_its_aux_beside_the_fused_head():
    model = tllama.llama_tiny(device="cpu", seed=0, lora_rank=RANK, fused_head_loss=True,
                              moe_experts=4).train()
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = model(tb)
    assert set(out) == {"hidden", "lm_head", "moe_aux", "moe_dropped_frac"}
    loss, m = tlosses.causal_lm_fused(out, tb)
    assert "moe_aux" in m and torch.isfinite(loss)
    assert set(model.eval()(tb)) == {"hidden", "lm_head"}


def test_predict_materializes_the_logits():
    """``Trainer.predict`` of a fused model yields the unfused model's
    logits (JAX's predict step materializes them the same way)."""
    from distributeddeeplearningspark_tpu_torch import Session, Trainer
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
    from distributeddeeplearningspark_tpu_torch.train import optim

    tree, batch = _tree(), _batch()
    rows = [{"input_ids": batch["input_ids"][i]} for i in range(B)]
    outs = {}
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate() as spark:
        for fused in (False, True):
            trainer = Trainer(spark, _port(tree, fused_head_loss=fused),
                              tlosses.causal_lm_fused if fused else tlosses.causal_lm,
                              optim.adamw(1e-3))
            trainer.init()
            outs[fused] = np.stack(list(trainer.predict(
                PartitionedDataset.parallelize(rows, 1), batch_size=B)))
    assert outs[True].shape == (B, S, 512) and outs[True].dtype == np.float32
    np.testing.assert_array_equal(outs[True], outs[False])
    want = jfused.materialize_logits({"hidden": jnp.ones((1, H)),
                                      "lm_head": jnp.full((H, 5), 0.5)})
    got = tfused.materialize_logits({"hidden": torch.ones(1, H),
                                     "lm_head": torch.full((5, H), 0.5)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frozen", [True, False])
def test_counted_flops_take_the_recompute(frozen):
    """The port's FLOP count of the fused loss's forward and backward: the
    forward's chunked logits (2·N·H·V), the backward's recompute of them
    and ``dh`` (2·N·H·V each), and ``dW`` where the head trains; the label
    logits and the softmax are elementwise."""
    v = 257
    h, k, labels, _ = _inputs(v)
    th = torch.tensor(h).requires_grad_(True)
    tw = torch.tensor(np.ascontiguousarray(k.T)).requires_grad_(not frozen)
    with metrics.counting_flops() as counted:
        tfused.chunked_softmax_xent(th, tw, torch.tensor(labels), num_chunks=16).sum().backward()
    assert counted["flops"] == (3 if frozen else 4) * 2 * N * H * v

"""The MoE FFN (``models/moe.py``) and the MoE Llama against the JAX package,
on the CPU.

- ``MoEMLP`` against the flax ``MoEMLP`` on the same weights (the flax
  init, converted), in f32: the output, the load-balance loss, the dropped
  share, the gradients of x and of every param, and the routing itself —
  each (token, round)'s expert and its kept/dropped verdict against the
  flax module's dispatch, read off a copy of its routing loop that the
  module's own output is checked to follow.
- The cases of the JAX package's ``tests/test_moe.py``: E = 1 is the dense
  SwiGLU, a tight capacity drops to zero rows, the ``top_k`` bounds,
  ``group_size`` = S is the identity, groups are invariant at ample
  capacity, ``group_size`` must divide B·S, small groups only drop more
  (above the capacity floor) and the floor below it.
- The tiny MoE Llama: the forward's dict in training and plain logits in
  eval against JAX's, the flax tree carried into the port, and a full
  fine-tune (experts and router training) of 5 AdamW steps through the
  port's ``Trainer`` against the JAX ``Trainer`` on one device: losses,
  ``moe_aux`` and ``moe_dropped_frac`` each step, then ``evaluate`` and
  ``predict`` on plain logits.
- The config's refusals and the model FLOPs a token, as JAX counts them.

The expert-parallel gangs are ``test_torch_ep.py``'s. f32 throughout: each
tolerance is summation order, and says so."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import metrics as jmetrics
from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.models import moe as jmoe
from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch import metrics as tmetrics
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.models import moe as tmoe
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import per_test

H, I = 16, 32
# one MoE layer's output and loss terms: the same f32 products summed in
# another order (XLA's einsums over [S, E, C] against the port's gathers)
ATOL = 1e-5
# gradients, per tensor against its largest element
GRAD_RTOL = 1e-4
# the Llama fine-tune's logged losses over 5 AdamW steps (4 layers)
LOSS_RTOL = 1e-4
B, S, STEPS, PARTS = 4, 32, 5, 2


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _x(b=2, s=8, h=H, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (b, s, h)).astype(np.float32)


def _port(params, *, e=4, k=2, cf=1.25, group=0):
    """The port's module holding the flax ``params``."""
    tm = tmoe.MoEMLP(H, I, e, top_k=k, capacity_factor=cf, group_size=group,
                     dtype=torch.float32, device="cpu")
    tm.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in params.items()})
    return tm


def _pair(x, *, e=4, k=2, cf=1.25, group=0, seed=0):
    """The flax module and its params, and the port's module holding them."""
    jm = jmoe.MoEMLP(H, I, num_experts=e, top_k=k, capacity_factor=cf,
                     group_size=group, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x)["params"])
    return jm, params, _port(params, e=e, k=k, cf=cf, group=group)


def _flax_routing(params, x, *, e, k, cf):
    """The flax module's routing loop (its ``__call__``'s, copied): the
    dispatch ``[b, s, e, c]`` and the normalised combine."""
    b, s, _ = x.shape
    cap = max(1, int(cf * s * k / e))
    probs = jax.nn.softmax(jnp.einsum("bsh,he->bse", x, params["router"]), -1)
    remaining, claimed = probs, jnp.zeros((b, e), jnp.int32)
    dispatch = jnp.zeros((b, s, e, cap))
    combine = jnp.zeros((b, s, e, cap))
    gate_sum = jnp.zeros((b, s))
    for _ in range(k):
        idx = jnp.argmax(remaining, -1)
        onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
        pos = (jnp.cumsum(onehot, axis=1) - 1) + claimed[:, None, :]
        keep = (onehot > 0) & (pos < cap)
        slot = jnp.where(keep[..., None], jax.nn.one_hot(pos, cap), 0.0)
        kept_gate = jnp.sum(probs * onehot, -1) * keep.any(-1)
        dispatch = dispatch + slot
        combine = combine + slot * kept_gate[:, :, None, None]
        gate_sum = gate_sum + kept_gate
        claimed = claimed + jnp.sum(onehot, 1)
        remaining = remaining * (1 - onehot)
    return np.asarray(dispatch), combine / jnp.maximum(gate_sum, 1e-9)[..., None, None]


def _port_dispatch(tm, x, b, s, *, e, k, cf):
    """The port's routing of ``x`` in ``b`` groups of ``s`` tokens as a
    ``[b, s, e, c]`` dispatch: each kept slot of the gather the module runs
    last, read by recording ``torch.gather``'s index into the expert
    outputs."""
    cap = max(1, int(cf * s * k / e))
    seen = {}
    orig = torch.Tensor.gather

    def recording(self, dim, index, *a, **kw):
        if index.dim() == 3 and index.shape[1] == s * k:
            seen["slot"] = index[..., 0].clone()
        return orig(self, dim, index, *a, **kw)

    torch.Tensor.gather = recording
    try:
        tm(torch.from_numpy(x))
    finally:
        torch.Tensor.gather = orig
    slot = seen["slot"].view(b, s, k).numpy()
    out = np.zeros((b, s, e, cap))
    for bi, si, ki in zip(*np.nonzero(slot < e * cap)):
        ex, c = divmod(int(slot[bi, si, ki]), cap)
        out[bi, si, ex, c] += 1
    return out


CASES = {
    "e4-top2": dict(e=4, k=2, cf=1.25),
    "e4-top2-tight": dict(e=4, k=2, cf=0.5),
    "e8-top1": dict(e=8, k=1, cf=1.0),
    "e4-top4": dict(e=4, k=4, cf=2.0),
    "e4-top2-group4": dict(e=4, k=2, cf=1.25, group=4),
}


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_terms_and_routing_match_jax(case):
    kw = CASES[case]
    x = _x(b=2, s=16, seed=1)
    jm, params, tm = _pair(x, e=kw["e"], k=kw["k"], cf=kw["cf"],
                           group=kw.get("group", 0), seed=1)
    jy, (jaux, jdrop) = jm.apply({"params": params}, x)
    ty, (taux, tdrop) = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(tdrop) == float(jdrop)
    # the routing, exactly: the grouped case routes the regrouped tokens
    xr = x.reshape(-1, kw["group"], H) if kw.get("group") else x
    dispatch, combine = _flax_routing(params, jnp.asarray(xr), e=kw["e"], k=kw["k"],
                                      cf=kw["cf"])
    # the copy of the loop is the module's: its combine gives the module's y
    ye = jnp.einsum("bsec,bsh->bech", dispatch, xr)
    act = (jax.nn.silu(jnp.einsum("bech,ehi->beci", ye, params["w_gate"]))
           * jnp.einsum("bech,ehi->beci", ye, params["w_up"]))
    y_copy = jnp.einsum("bsec,bech->bsh", combine,
                        jnp.einsum("beci,eih->bech", act, params["w_down"]))
    np.testing.assert_allclose(np.asarray(y_copy).reshape(x.shape), np.asarray(jy),
                               atol=ATOL)
    got = _port_dispatch(tm, x, *xr.shape[:2], e=kw["e"], k=kw["k"], cf=kw["cf"])
    np.testing.assert_array_equal(got, dispatch)
    assert 0.0 <= float(tdrop) <= 1.0


@pytest.mark.parametrize("case", ["e4-top2", "e4-top2-tight", "e4-top2-group4"])
def test_gradients_match_jax(case):
    """The gradients of ``sum(y · cot) + aux`` with respect to x and to each
    param (the router's through the gates and the aux)."""
    kw = CASES[case]
    x = _x(b=2, s=16, seed=2)
    cot = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)
    jm, params, tm = _pair(x, e=kw["e"], k=kw["k"], cf=kw["cf"],
                           group=kw.get("group", 0), seed=2)

    def jloss(p, xx):
        y, (aux, _) = jm.apply({"params": p}, xx)
        return jnp.sum(y * cot) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, (aux, _) = tm(tx)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    pairs = [("x", tx.grad, jgx)] + [(n, p.grad, jgp[n]) for n, p in tm.named_parameters()]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= GRAD_RTOL, (name, err)


# -- the JAX package's cases ------------------------------------------------------------


def test_single_expert_matches_dense_swiglu():
    x = _x(seed=1)
    _, params, tm = _pair(x, e=1, k=1, cf=2.0, seed=1)
    y, (aux, dropped) = tm(torch.from_numpy(x))
    assert float(dropped) == 0.0
    g = x @ params["w_gate"][0]
    u = x @ params["w_up"][0]
    want = (g / (1 + np.exp(-g)) * u) @ params["w_down"][0]
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(aux) - 1.0) < 1e-5


def test_capacity_drop_falls_through():
    x = _x(b=1, s=16, seed=2)
    _, _, tm = _pair(x, e=2, k=1, cf=0.07, seed=2)  # cap = 1
    y, (_, dropped) = tm(torch.from_numpy(x))
    zero_rows = int((y.detach().abs().amax(-1)[0] < 1e-7).sum())
    assert zero_rows >= 16 - 2
    assert float(dropped) >= (16 - 2) / 16


def test_top_k_bounds_checked():
    tm = tmoe.MoEMLP(H, I, 2, top_k=3, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tm(torch.from_numpy(_x()))


def test_group_size_equal_to_seq_is_identity():
    x = _x(b=2, s=8, seed=3)
    _, params, base = _pair(x, e=4, k=2, seed=3)
    grouped = _port(params, e=4, k=2, group=8)
    y0, (a0, d0) = base(torch.from_numpy(x))
    y1, (a1, d1) = grouped(torch.from_numpy(x))
    assert torch.equal(y0, y1) and float(a0) == float(a1) and float(d0) == float(d1)


def test_group_size_invariant_when_capacity_ample():
    x = _x(b=2, s=8, seed=4)
    _, params, _ = _pair(x, e=1, k=1, cf=2.0, seed=4)
    outs = []
    for g in (0, 2, 4, 16):
        y, (_, dropped) = _port(params, e=1, k=1, cf=2.0, group=g)(torch.from_numpy(x))
        assert float(dropped) == 0.0
        outs.append(y.detach().numpy())
    for y in outs[1:]:
        np.testing.assert_allclose(y, outs[0], atol=1e-5, rtol=1e-5)


def test_group_size_must_divide_tokens():
    tm = tmoe.MoEMLP(H, I, 2, group_size=5, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="group_size"):
        tm(torch.from_numpy(_x(b=2, s=8)))


def test_small_groups_can_only_drop_more():
    x = _x(b=1, s=16, seed=5)
    kw = dict(e=2, k=1, cf=0.5, seed=5)
    assert kw["cf"] * 4 * kw["k"] / kw["e"] >= 1
    _, params, base = _pair(x, **kw)
    grouped = _port(params, e=2, k=1, cf=0.5, group=4)
    _, (_, d_seq) = base(torch.from_numpy(x))
    _, (_, d_grp) = grouped(torch.from_numpy(x))
    assert float(d_grp) >= float(d_seq) - 1e-9


def test_capacity_floor_below_regime_boundary():
    x = _x(b=1, s=16, seed=6)
    kw = dict(e=4, k=1, cf=0.5, seed=6)
    _, params, base = _pair(x, **kw)
    grouped = _port(params, e=4, k=1, cf=0.5, group=2)
    _, (_, d_seq) = base(torch.from_numpy(x))
    _, (_, d_grp) = grouped(torch.from_numpy(x))
    assert 0.0 <= float(d_grp) <= 1.0 and float(d_seq) > 0.0


# -- the MoE Llama ------------------------------------------------------------------------


def _jcfg(**kw):
    return jllama.LlamaConfig.tiny(moe_experts=4, moe_top_k=2, intermediate_size=64, **kw)


def _tcfg(**kw):
    return tllama.LlamaConfig.tiny(moe_experts=4, moe_top_k=2, intermediate_size=64, **kw)


def _examples(n: int = 16, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, S).astype(np.int32),
             "loss_mask": np.ones(S, np.float32)} for _ in range(n)]


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_llama_forward_matches_jax(scan):
    """The flax tree (stacked or unrolled) carried into the port: in
    training the dict, in eval plain logits, each JAX's."""
    batch = {"input_ids": np.stack([e["input_ids"] for e in _examples(2)])}
    jm = jllama.LlamaForCausalLM(_jcfg(scan_layers=scan))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), batch)["params"])
    model = tllama.LlamaForCausalLM(_tcfg(), device="cpu")
    model.load_state_dict(tllama_io.params_from_flax(params, _tcfg()))
    jout = jm.apply({"params": params}, batch, train=True)
    model.train()
    tout = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tout) == {"logits", "moe_aux", "moe_dropped_frac"} == set(jout)
    np.testing.assert_allclose(tout["logits"].detach().numpy(),
                               np.asarray(jout["logits"]), atol=1e-4)
    for k in ("moe_aux", "moe_dropped_frac"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5)
    model.eval()
    with torch.no_grad():
        logits = model({k: torch.from_numpy(v) for k, v in batch.items()})
    jlogits = jm.apply({"params": params}, batch, train=False)
    assert isinstance(logits, torch.Tensor) and not isinstance(jlogits, dict)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)


def _jax_fit():
    """The JAX Trainer's full fine-tune on one device: its init as a port
    state dict, each step's logged metrics, and ``evaluate``'s."""
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim

    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    tx = joptim.with_grad_clip(joptim.adamw(joptim.warmup_cosine(1e-2, 1, STEPS)), 1.0)
    jt = JTrainer(jspark, jllama.LlamaForCausalLM(_jcfg()), jlosses.causal_lm, tx)
    jds = JDataset.parallelize(_examples(), num_slices=PARTS)
    jt.init(jt._sample_batch(jds, B))
    init = tllama_io.params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(jt.state.params)), _tcfg())
    logged: list = []
    jt.fit(jds.repeat(), batch_size=B, steps=STEPS, log_every=1,
           callbacks=[lambda s, m: logged.append(
               {k: float(m[k]) for k in ("loss", "moe_aux", "moe_dropped_frac")})])
    ev = jt.evaluate(JDataset.parallelize(_examples(6, seed=5), num_slices=PARTS),
                     batch_size=B)
    jspark.stop()
    return init, logged, float(ev["loss"])


def test_llama_fit_matches_the_jax_trainer():
    """5 AdamW steps of the full fine-tune (the bank and the router train,
    so the aux moves them) through ``Trainer.fit``: each step's loss,
    ``moe_aux`` and ``moe_dropped_frac`` JAX's; ``evaluate`` on plain
    logits (the loss without the aux) JAX's; ``predict`` gives logits."""
    init, want, want_eval = _jax_fit()
    spark = Session.builder.master("local[1]").appName("moe").config(
        DEVICE_CONF, "cpu").getOrCreate()
    try:
        model = tllama.LlamaForCausalLM(_tcfg(), device="cpu")
        model.load_state_dict(init)
        tx = optim.with_grad_clip(optim.adamw(optim.warmup_cosine(1e-2, 1, STEPS)), 1.0)
        trainer = Trainer(spark, model, losses.causal_lm, tx,
                          rules=tllama.llama_rules(model.cfg))
        logged: list = []
        trainer.fit(PartitionedDataset.parallelize(_examples(), PARTS).repeat(),
                    batch_size=B, steps=STEPS, log_every=1,
                    callbacks=[lambda s, m: logged.append(
                        {k: m[k] for k in ("loss", "moe_aux", "moe_dropped_frac")})])
        ev = trainer.evaluate(PartitionedDataset.parallelize(_examples(6, seed=5), PARTS),
                              batch_size=B)
        preds = list(trainer.predict(
            PartitionedDataset.parallelize(_examples(2, seed=7), 1), batch_size=2))
    finally:
        spark.stop()
    for k in ("loss", "moe_aux"):
        np.testing.assert_allclose([m[k] for m in logged], [m[k] for m in want],
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose([m["moe_dropped_frac"] for m in logged],
                               [m["moe_dropped_frac"] for m in want], atol=1e-6)
    assert logged[-1]["loss"] < logged[0]["loss"]
    np.testing.assert_allclose(float(ev["loss"]), want_eval, rtol=LOSS_RTOL)
    assert "moe_aux" not in ev
    assert len(preds) == 2 and np.shape(preds[0]) == (S, 512)


def test_llama_rules_shard_the_bank_as_jax():
    """``llama_rules``' expert entries over the port's names: the bank's
    experts over ``expert`` and its FFN dim over ``tensor``, the router
    replicated; the auto-FSDP pass takes the bank's hidden dim."""
    from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
    from distributeddeeplearningspark_tpu_torch.parallel.sharding import P

    cfg = _tcfg()
    model = tllama.LlamaForCausalLM(cfg, device="meta")
    shape = tmesh.MeshSpec(data=1, fsdp=2, expert=2, tensor=2).shape(8)
    specs = tllama.llama_rules(cfg, fsdp_min_size=1).tree_specs(
        {n: tuple(p.shape) for n, p in model.named_parameters()}, tmesh.Mesh(shape))
    assert specs["layers.0.moe.w_gate"] == P("expert", "fsdp", "tensor")
    assert specs["layers.0.moe.w_up"] == P("expert", "fsdp", "tensor")
    assert specs["layers.0.moe.w_down"] == P("expert", "tensor", "fsdp")
    assert specs["layers.0.moe.router"] == P("fsdp", None)


@pytest.mark.parametrize("fields,match", [
    (dict(base_quant="int8", lora_rank=4), "no int8 form"),
    (dict(attention_impl="ring"), "Queue 1 item 6"),
    (dict(attention_impl="ulysses"), "Queue 1 item 6")])
def test_model_refuses_moe_where_the_port_cannot(fields, match):
    with pytest.raises(NotImplementedError, match=match):
        tllama.LlamaForCausalLM(_tcfg(**fields), device="cpu")


def test_moe_flops_match_jax():
    for name in ("llama2_7b", "tiny"):
        j = dataclasses.replace(getattr(jllama.LlamaConfig, name)(lora_rank=16),
                                moe_experts=8)
        t = dataclasses.replace(getattr(tllama.LlamaConfig, name)(lora_rank=16),
                                moe_experts=8)
        for frozen in (True, False):
            assert tmetrics.llama_model_flops_per_token(t, 1024, frozen_base=frozen) == \
                jmetrics.llama_model_flops_per_token(j, 1024, frozen_base=frozen)

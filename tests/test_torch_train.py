"""The port's training pieces against the JAX package: the optimizer and
schedule (optax), the MLM loss, and a few train steps of a tiny BERT
(same weights through ``params_from_flax``, same numpy batches), with the
attention on the plain path and on the flash path (the JAX Pallas kernels in
interpret mode). Also the seeded dropout. f32 throughout; each test states
its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu.models import bert as jbert
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu.train import step as jstep
from distributeddeeplearningspark_tpu.train.state import TrainState as JState
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.models.bert_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.train import step as tstep
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import bounded, per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (5,), (3, 4, 2), ()]
    return [rng.normal(0, scale, s).astype(np.float32) for s in shapes]


# -- schedules and the optimizer chain against optax -------------------------


@pytest.mark.parametrize("warmup,total,end", [(3, 10, 0.0), (0, 5, 0.0),
                                              (4, 4, 1e-5), (2, 20, 1e-4)])
def test_warmup_linear_matches_optax(warmup, total, end):
    """f32 schedule values, read at counts 0..total+2, equal optax's."""
    want = joptim.warmup_linear(1e-3, warmup, total, end)
    got = toptim.warmup_linear(1e-3, warmup, total, end)
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7,
                                   atol=0)
    if warmup:
        assert got(0) == 0.0  # the first update of a warmup has lr 0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Clipping active (norm over max_norm) and idle; no epsilon."""
    grads = _tree(1, scale=3.0)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    tx = toptim.clip_by_global_norm(max_norm)
    got, _ = tx.update([torch.from_numpy(g.copy()) for g in grads],
                       tx.init([]), [])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads))
    assert (norm > max_norm) == (max_norm == 0.5)


@pytest.mark.parametrize("grad_scale,max_norm,lr", [
    (5.0, 1.0, "warmup"),      # clipping active at every update, lr 0 first
    (0.1, 1.0, "warmup"),      # clipping idle
    (1.0, 1e3, 3e-3),          # a constant lr
])
def test_adamw_chain_matches_optax(grad_scale, max_norm, lr):
    """with_grad_clip(adamw(lr)) over 5 updates on a random tree: params
    against optax at 1e-6, both Adam moments at 1e-5 relative (f32: the
    clip factor and the bias corrections round in another order, and a
    moment keeps that rounding of every update it has seen)."""
    jlr = joptim.warmup_linear(1e-2, 2, 5) if lr == "warmup" else lr
    tlr = toptim.warmup_linear(1e-2, 2, 5) if lr == "warmup" else lr
    jtx = joptim.with_grad_clip(joptim.adamw(jlr), max_norm)
    ttx = toptim.with_grad_clip(toptim.adamw(tlr), max_norm)
    params = _tree(2)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(5):
        g = _tree(10 + i, scale=grad_scale)
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update([torch.from_numpy(x.copy()) for x in g],
                                  tstate, tp)
        torch._foreach_add_(tp, tupd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        if i == 0 and lr == "warmup":
            for a, p in zip(tp, params):  # lr 0: the first update is a no-op
                np.testing.assert_array_equal(a.numpy(), p)
    adam_j = jstate[1][0]
    adam_t = tstate[1][0]
    assert adam_t.count == int(adam_j.count) == 5
    for a, b in zip(adam_t.mu + adam_t.nu, list(adam_j.mu) + list(adam_j.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)


def _adam_two_temporaries(updates, state, b1=0.9, b2=0.999, eps=1e-8):
    """The earlier ``scale_by_adam`` update: ``denom`` and ``out`` built as
    two whole new lists."""
    mu, nu = [m.clone() for m in state.mu], [n.clone() for n in state.nu]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, updates, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, updates, updates, value=1.0 - b2)
    c = (state.count + 1).float()
    denom = torch._foreach_div(nu, 1.0 - torch.pow(b2, c))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    out = torch._foreach_div(mu, 1.0 - torch.pow(b1, c))
    torch._foreach_div_(out, denom)
    return out, mu, nu, denom


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_update_in_the_gradients_memory_is_bitwise_the_old(dtype):
    """``scale_by_adam`` with the denominator in the spent gradients' memory
    (one param-sized temporary, the update) against the two-list formula:
    every update and both moments bitwise, over 4 updates of random tensors
    with gradients near zero among them."""
    g = torch.Generator().manual_seed(0)
    shapes = [(33, 7), (5,), (4, 3, 2)]
    params = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    tx = toptim.scale_by_adam()
    state = tx.init(params)
    for i in range(4):
        grads = [(torch.randn(s, generator=g) * 10.0 ** -(3 * (i % 2))).to(dtype)
                 for s in shapes]
        want, mu, nu, denom = _adam_two_temporaries([x.clone() for x in grads], state)
        got, state = tx.update(grads, state, params)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        # the denominator lies in the gradients' memory
        for a, b in zip([*got, *state.mu, *state.nu, *grads], [*want, *mu, *nu, *denom]):
            assert a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits)), i


@pytest.mark.parametrize("eval_mask", [False, True])
def test_masked_lm_matches_jax(eval_mask):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (4, 6, 11)).astype(np.float32)
    batch = {"mlm_labels": rng.integers(0, 11, (4, 6)).astype(np.int32),
             "mlm_weights": (rng.random((4, 6)) < 0.5).astype(np.float32)}
    if eval_mask:
        batch["eval_mask"] = np.array([1, 1, 0, 1], np.float32)
    jl, jm = jlosses.masked_lm(jnp.asarray(logits),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tlosses.masked_lm(torch.from_numpy(logits),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == {"loss", "mlm_accuracy", "weight"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# -- a tiny BERT trained step by step against the JAX step -------------------

B, S, P, STEPS = 4, 128, 20, 5
LR = toptim.warmup_linear(2e-3, 2, STEPS)


@pytest.mark.parametrize("masks", [(), ("loss_mask",), ("eval_mask",),
                                   ("loss_mask", "eval_mask")])
def test_causal_lm_matches_jax(masks):
    """Next-token CE with the shifted loss_mask, padded eval rows weighing
    nothing: loss, perplexity and weight."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (3, 9, 17)).astype(np.float32)
    batch = {"input_ids": rng.integers(0, 17, (3, 9)).astype(np.int32)}
    if "loss_mask" in masks:
        batch["loss_mask"] = (rng.random((3, 9)) < 0.7).astype(np.float32)
    if "eval_mask" in masks:
        batch["eval_mask"] = np.array([1, 0, 1], np.float32)
    jl, jm = jlosses.causal_lm(jnp.asarray(logits),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tlosses.causal_lm(torch.from_numpy(logits),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == {"loss", "perplexity", "weight"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)


def _mlm_batches(vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        am = np.ones((B, S), np.int32)
        am[1, 100:] = 0
        am[3, 60:] = 0
        out.append({
            "input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "attention_mask": am,
            "mlm_positions": np.sort(rng.integers(0, 60, (B, P)), 1).astype(np.int32),
            "mlm_labels": rng.integers(0, vocab, (B, P)).astype(np.int32),
            "mlm_weights": (rng.random((B, P)) < 0.8).astype(np.float32),
        })
    return out


@pytest.fixture(scope="module")
@bounded()
def tiny_init():
    cfg = jbert.BertConfig.tiny(num_layers=2, dropout_rate=0.0)
    batch = {k: jnp.asarray(v) for k, v in _mlm_batches(cfg.vocab_size)[0].items()}
    params = jbert.BertForMLM(cfg).init(jax.random.PRNGKey(0), batch)["params"]
    return jax.tree.map(np.asarray, params)


def _jax_run(params, impl):
    cfg = jbert.BertConfig.tiny(num_layers=2, dropout_rate=0.0,
                                attention_impl=impl)
    model = jbert.BertForMLM(cfg)
    tx = joptim.with_grad_clip(joptim.adamw(joptim.warmup_linear(2e-3, 2, STEPS)), 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    state = JState.create(params=jp, opt_state=tx.init(jp))
    step = jax.jit(jstep.make_train_step(model.apply, tx, jlosses.masked_lm))
    losses, norms = [], []
    for b in _mlm_batches(cfg.vocab_size):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _port_run(params, impl):
    cfg = tbert.BertConfig.tiny(num_layers=2, dropout_rate=0.0,
                                attention_impl=impl)
    model = tbert.BertForMLM(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    tx = toptim.with_grad_clip(toptim.adamw(LR), 1.0)
    named = dict(model.named_parameters())
    state = TrainState(step=0, params=named, opt_state=tx.init(list(named.values())),
                       generator=torch.Generator().manual_seed(0))
    step = tstep.make_train_step(model, tx, tlosses.masked_lm)
    losses, norms = [], []
    for b in _mlm_batches(cfg.vocab_size):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert state.step == STEPS
    return losses, norms, model.state_dict()


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_tiny_bert_train_steps_match_jax(tiny_init, impl):
    """Loss and grad norm per step at 1e-4, final params elementwise.

    Adam divides each gradient by its own running RMS, so an element whose
    gradient is ~0 (f32 noise of another summation order) takes a full
    lr-sized step of arbitrary sign: the limit per element is therefore the
    sum of the lr over the steps (the most such an element can move), and
    all but 0.1% of elements must agree to 1e-5."""
    jl, jn, jparams = _jax_run(tiny_init, impl)
    tl, tn, tparams = _port_run(tiny_init, impl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert tl[-1] < tl[0]
    want = params_from_flax(jparams)
    lr_sum = sum(LR(i) for i in range(STEPS))
    diffs = np.concatenate([(tparams[k] - want[k]).abs().numpy().ravel()
                            for k in want])
    assert diffs.max() <= lr_sum
    assert np.mean(diffs > 1e-5) < 1e-3


# -- dropout ------------------------------------------------------------------


def test_dropout_is_seeded_and_drops_at_the_rate():
    x = torch.ones(200_000)
    a = tbert.dropout(x, 0.1, torch.Generator().manual_seed(7), True)
    b = tbert.dropout(x, 0.1, torch.Generator().manual_seed(7), True)
    c = tbert.dropout(x, 0.1, torch.Generator().manual_seed(8), True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    dropped = float((a == 0).float().mean())
    assert abs(dropped - 0.1) < 0.005  # ~7 sigma of a binomial at n=2e5
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert tbert.dropout(x, 0.1, None, False) is x
    with pytest.raises(ValueError, match="Generator"):
        tbert.dropout(x, 0.1, None, True)


def test_bert_train_mode_dropout_follows_the_generator():
    model = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=1), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _mlm_batches(1024)[0].items()}
    model.train()
    out = [model(batch, generator=torch.Generator().manual_seed(s))
           for s in (1, 1, 2)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    model.eval()
    with torch.no_grad():
        e1, e2 = model(batch), model(batch)
    assert torch.equal(e1, e2)

"""The port's BERT MLM against the flax model: weights from flax ``init``
carried across by ``params_from_flax``, the same numpy batch through both,
f32 (``BertConfig.tiny()``), logits held at 1e-4 in every head mode. The
JAX side runs once with ``attention_impl="xla"`` and once with ``"flash"``
(the Pallas kernel in interpret mode); the port runs the same impl."""

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import bert as jbert
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.models.bert_io import params_from_flax
from test_torch_deadline import bounded, per_test

ATOL = 1e-4
B, S = 2, 64


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _batch(mode: str, vocab: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    am = np.zeros((B, S), np.int32)
    am[0, :S] = 1
    am[1, :37] = 1
    batch = {
        "input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
        "attention_mask": am,
        "token_type_ids": (np.arange(S)[None, :] >= 20).astype(np.int32)
        .repeat(B, 0),
    }
    if mode == "mlm_positions":
        batch["mlm_positions"] = rng.integers(0, S, (B, 9)).astype(np.int32)
    if mode == "segment_ids":
        segs = np.zeros((B, S), np.int32)
        segs[0, 25:] = 1
        segs[1, 12:] = 1
        segs[1, 30:] = 2
        batch["segment_ids"] = segs
    return batch


@pytest.fixture(scope="module")
@bounded()
def flax_params():
    cfg = jbert.BertConfig.tiny()
    batch = _batch("full", cfg.vocab_size)
    variables = jbert.BertForMLM(cfg).init(
        jax.random.PRNGKey(0), {k: jax.numpy.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(np.asarray, variables["params"])
    # a nonzero decoder bias, so the test sees it carried across
    params["mlm_bias"] = np.random.default_rng(3).normal(
        0, 0.5, params["mlm_bias"].shape).astype(np.float32)
    return params


def _port_model(flax_params, impl):
    model = tbert.BertForMLM(tbert.BertConfig.tiny(attention_impl=impl),
                             device="cpu").eval()
    missing = model.load_state_dict(params_from_flax(flax_params), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return model


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["full", "mlm_positions", "segment_ids"])
def test_port_logits_match_flax(flax_params, mode, impl):
    cfg = jbert.BertConfig.tiny(attention_impl=impl)
    batch = _batch(mode, cfg.vocab_size, seed=1)
    want = np.asarray(jbert.BertForMLM(cfg).apply(
        {"params": flax_params},
        {k: jax.numpy.asarray(v) for k, v in batch.items()}, train=False))
    model = _port_model(flax_params, impl)
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_params_from_flax_covers_the_state_dict(flax_params):
    sd = params_from_flax(flax_params)
    model = tbert.BertForMLM(tbert.BertConfig.tiny(), device="cpu")
    assert set(sd) == set(model.state_dict())
    n_flax = sum(np.asarray(x).size for x in jax.tree.leaves(flax_params))
    assert sum(t.numel() for t in sd.values()) == n_flax
    assert all(t.dtype == torch.float32 for t in sd.values())
    q = flax_params["encoder"]["layer_0"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        sd["encoder.layers.0.attention.query.weight"].numpy(),
        q.reshape(q.shape[0], -1).T)


def test_bf16_activations_keep_f32_params_and_logits():
    model = tbert.BertForMLM(tbert.BertConfig.tiny(dtype=torch.bfloat16),
                             device="cpu").eval()
    model.init_weights(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _batch("full", 1024).items()}
    with torch.inference_mode():
        out = model(batch)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_init_weights_is_seeded():
    def make(seed):
        m = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=1), device="cpu")
        return m.init_weights(torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.token_embeddings.weight"],
                           c["encoder.token_embeddings.weight"])


def test_rejects_sequence_longer_than_positions():
    model = tbert.BertForMLM(tbert.BertConfig.tiny(max_position=32),
                             device="cpu").eval()
    with pytest.raises(ValueError, match="max_position"):
        model({"input_ids": torch.zeros(1, 33, dtype=torch.int32)})

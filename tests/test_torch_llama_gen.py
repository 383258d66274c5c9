"""KV-cached Llama decode and ``llama_gen.generate`` in the port against the
JAX package on the CPU, at ``LlamaConfig.tiny`` (4 layers, 128 wide, GQA
4/2, f32), the flax weights carried across by ``params_from_flax``:

- decode logits (a prefill of 8, then 4 single tokens) against JAX's
  ``decode_model`` at rtol = atol = 2e-4 (the tolerance of JAX's own
  ``test_decode_logits_match_teacher_forcing``): the plain model, LoRA with
  a nonzero B, and the int8 base; and against the port's own training
  forward;
- greedy ``generate`` and its eos freezing equal to JAX's token for token;
- the kept sets of temperature, top-k and top-p sampling equal to JAX's
  (the two random streams differ, so each side's set is read from its
  draws over 4,096 keys, on logits built so that every kept token has at
  least 5% of the mass);
- the refusals of JAX's ``generate`` and decode mode, in its words."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.models import llama_gen as jgen
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_gen as tgen
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from test_torch_deadline import bounded, per_test

#: JAX's own decode-vs-teacher-forcing tolerance (f32, summation order)
DECODE_TOL = 2e-4
VARIANTS = {"base": {}, "lora": {"lora_rank": 4},
            "int8": {"lora_rank": 4, "base_quant": "int8"}}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(scope="module")
@bounded()
def models():
    """Per variant: (JAX config, JAX params, port model on the CPU). LoRA's
    B is made nonzero, so the adapters act in every comparison."""
    out = {}
    for name, kw in VARIANTS.items():
        jcfg = jllama.LlamaConfig.tiny(**kw)
        params = jllama.LlamaForCausalLM(jcfg).init(
            jax.random.PRNGKey(0), {"input_ids": np.zeros((2, 12), np.int32)},
            train=False)["params"]
        if kw.get("lora_rank"):
            rng = np.random.default_rng(5)
            params = jax.tree_util.tree_map_with_path(
                lambda p, x: (x + rng.normal(0, 0.05, x.shape).astype(x.dtype)
                              if "lora_b" in jax.tree_util.keystr(p) else x), params)
        tcfg = tllama.LlamaConfig.tiny(**kw)
        model = tllama.LlamaForCausalLM(tcfg, device="cpu")
        model.load_state_dict(tllama_io.params_from_flax(jax.device_get(params), tcfg))
        out[name] = (jcfg, params, model.eval())
    return out


def _ids(rows=2, length=12, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (rows, length)).astype(np.int32)


def _jax_decode_logits(jcfg, params, ids):
    dm = jgen.decode_model(jcfg, ids.shape[1])
    lo, mut = dm.apply({"params": params}, {"input_ids": ids[:, :8]}, train=False,
                       mutable=["cache"])
    out, cache = [np.asarray(lo)], mut["cache"]
    for i in range(8, ids.shape[1]):
        lo, mut = dm.apply({"params": params, "cache": cache},
                           {"input_ids": ids[:, i:i + 1]}, train=False, mutable=["cache"])
        cache = mut["cache"]
        out.append(np.asarray(lo))
    return np.concatenate(out, axis=1)


def _port_decode_logits(model, ids):
    with torch.inference_mode():
        cache = tllama.KVCache.zeros(model.cfg, ids.shape[0], max_cache_len=ids.shape[1])
        lo, cache = model({"input_ids": torch.from_numpy(ids[:, :8]).long()}, cache=cache)
        out = [lo]
        for i in range(8, ids.shape[1]):
            lo, cache = model({"input_ids": torch.from_numpy(ids[:, i:i + 1]).long()},
                              cache=cache)
            out.append(lo)
    assert cache.index.tolist() == [ids.shape[1]] * ids.shape[0]
    return torch.cat(out, dim=1).numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_logits_match_jax_decode(models, variant):
    jcfg, params, model = models[variant]
    ids = _ids()
    np.testing.assert_allclose(_port_decode_logits(model, ids),
                               _jax_decode_logits(jcfg, params, ids),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_the_ports_training_forward(models, variant):
    """Prefill + per-token decode reproduce the full forward's logits: the
    cache holds the K/V the training path recomputes (the int8 base's
    rounding cancels in this self-comparison)."""
    _, _, model = models[variant]
    ids = _ids(seed=3)
    with torch.inference_mode():
        full = model({"input_ids": torch.from_numpy(ids).long()}).numpy()
    np.testing.assert_allclose(_port_decode_logits(model, ids), full,
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("variant,cache_len", [("base", None), ("lora", 32),
                                               ("int8", None)])
def test_greedy_generate_equals_jax(models, variant, cache_len):
    jcfg, params, model = models[variant]
    prompt = _ids(length=8, seed=0)
    want = np.asarray(jgen.generate(params, jnp.asarray(prompt), cfg=jcfg,
                                    max_new_tokens=6, max_cache_len=cache_len))
    got = tgen.generate(model, prompt, max_new_tokens=6, max_cache_len=cache_len)
    assert got.shape == (2, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_freezes_rows_as_jax_does(models):
    """A row that emits eos pads from then on, the other keeps generating:
    the same tokens as JAX's."""
    jcfg, params, model = models["base"]
    prompt = _ids(length=8, seed=0)
    ref = np.asarray(jgen.generate(params, jnp.asarray(prompt), cfg=jcfg,
                                   max_new_tokens=5))
    eos = int(ref[0, 1])
    want = np.asarray(jgen.generate(params, jnp.asarray(prompt), cfg=jcfg,
                                    max_new_tokens=5, eos_id=eos, pad_id=0))
    got = tgen.generate(model, prompt, max_new_tokens=5, eos_id=eos, pad_id=0).numpy()
    np.testing.assert_array_equal(got, want)
    hit = np.flatnonzero(got[0] == eos)
    assert hit.size and (got[0, hit[0] + 1:] == 0).all(), got


def _sampling_logits() -> np.ndarray:
    """[2, 64] f32: eight leading tokens 0.15 apart (each keeps at least 5%
    of the mass under every truncation below), the rest at -20; the rows
    hold them at different ids."""
    out = np.full((2, 64), -20.0, np.float32)
    lead = 3.0 - 0.15 * np.arange(8, dtype=np.float32)
    out[0, [5, 9, 1, 40, 33, 17, 60, 2]] = lead
    out[1, [63, 0, 22, 7, 31, 48, 12, 3]] = lead
    return out


def _kept(draws: np.ndarray) -> list[set]:
    return [set(draws[:, r].tolist()) for r in range(draws.shape[1])]


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 8, 1.0), (0.5, 6, 1.0), (1.0, 0, 0.6), (1.3, 8, 0.75), (1.0, 5, 0.9)])
def test_sampling_kept_sets_equal_jax(temperature, top_k, top_p):
    logits = _sampling_logits()
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jdraw = np.asarray(jax.vmap(lambda k: jgen._sample(
        jnp.asarray(logits), k, temperature=temperature, top_k=top_k,
        top_p=top_p))(keys))
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits).repeat(4096, 1)
    tdraw = tgen._sample(t, gen, temperature=temperature, top_k=top_k,
                         top_p=top_p).view(4096, 2).numpy()
    assert _kept(tdraw) == _kept(jdraw)
    assert all(len(s) >= 2 for s in _kept(jdraw))


def test_greedy_sample_ties_go_to_the_lowest_id():
    logits = np.zeros((1, 16), np.float32)
    logits[0, [3, 9]] = 1.0
    want = int(np.asarray(jgen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                       temperature=0.0, top_k=0))[0])
    got = int(tgen._sample(torch.from_numpy(logits), None, temperature=0.0, top_k=0)[0])
    assert got == want == 3


def test_sampled_generate_stays_in_each_steps_top_k(models):
    """Temperature 0.8, top_k 40: every token lies in the top 40 of its
    step's logits (read back by teacher forcing over prompt + output), and
    a seed reproduces the run."""
    _, _, model = models["lora"]
    prompt = _ids(length=8, seed=2)
    out = tgen.generate(model, prompt, max_new_tokens=8, temperature=0.8, top_k=40,
                        seed=3)
    again = tgen.generate(model, prompt, max_new_tokens=8, temperature=0.8, top_k=40,
                          seed=3)
    assert torch.equal(out, again)
    seq = torch.cat([torch.from_numpy(prompt).long(), out.long()], dim=1)
    with torch.inference_mode():
        logits = model({"input_ids": seq})
    top = torch.topk(logits[:, 7:-1], 40, dim=-1).indices
    assert (top == out.long()[..., None]).any(-1).all()


def test_decode_config_builds_and_makes_its_cache(models):
    """``cfg.decode`` (JAX's ``decode_model``) runs without a cache given:
    one of ``max_cache_len`` is made, and the logits equal the cached call's."""
    jcfg, params, model = models["base"]
    ids = _ids(length=8)
    twin = tgen.decode_model(model.cfg, 16, device="cpu")
    twin.load_state_dict(model.state_dict())
    with torch.inference_mode():
        lo, cache = twin({"input_ids": torch.from_numpy(ids).long()})
    assert cache.max_len == 16 and cache.index.tolist() == [8, 8]
    dm = jgen.decode_model(jcfg, 16)
    want, _ = dm.apply({"params": params}, {"input_ids": ids}, train=False,
                       mutable=["cache"])
    np.testing.assert_allclose(lo.numpy(), np.asarray(want), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


@pytest.mark.parametrize("case,words", [
    ("max_position", "max_position"), ("cache_len", "max_cache_len"),
    ("mask", "equal-length prompts"), ("segments", "segment_ids")])
def test_refusals_in_jax_words(models, case, words):
    jcfg, params, model = models["base"]
    prompt = _ids(length=8)
    if case == "max_position":
        with pytest.raises(ValueError, match=words):
            jgen.generate(params, jnp.asarray(prompt), cfg=jcfg,
                          max_new_tokens=jcfg.max_position + 1)
        with pytest.raises(ValueError, match=words):
            tgen.generate(model, prompt, max_new_tokens=model.cfg.max_position + 1)
        return
    if case == "cache_len":
        with pytest.raises(ValueError, match=words):
            jgen.generate(params, jnp.asarray(prompt), cfg=jcfg, max_new_tokens=8,
                          max_cache_len=10)
        with pytest.raises(ValueError, match=words):
            tgen.generate(model, prompt, max_new_tokens=8, max_cache_len=10)
        return
    key = "attention_mask" if case == "mask" else "segment_ids"
    with pytest.raises(ValueError, match=words):
        jgen.decode_model(jcfg, 16).apply(
            {"params": params}, {"input_ids": prompt, key: np.ones_like(prompt)},
            train=False, mutable=["cache"])
    with pytest.raises(ValueError, match=words), torch.inference_mode():
        t = torch.from_numpy(prompt).long()
        model({"input_ids": t, key: torch.ones_like(t)},
              cache=tllama.KVCache.zeros(model.cfg, 2, max_cache_len=16))

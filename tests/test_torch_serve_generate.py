"""The port's ``ContinuousGenerator`` on the CPU against the JAX package,
at the nano Llama of JAX's ``tests/test_serve.py`` and
``tests/test_serve_fleet.py`` (2 layers, 64 wide, GQA 4/2, f32), the flax
weights carried across by ``params_from_flax``:

- every request's tokens equal JAX's ``generate`` on its prompt alone,
  with more requests than slots (mid-flight joins), in the fixed-slot pool
  and in the paged arena;
- the prefill's signatures bounded by the prompt-bucket ladder; a
  ``swap_params`` mid-flight; oversized requests refused and shedding
  typed; eos freeing a slot;
- the paged arena equal to the dense pool, prefix reuse equal to it,
  deferral under page pressure, a swap flushing the prefix cache, a
  failing prefill returning its pages;
- the request span tree tiling ``[submit, done]``, read back by the JAX
  package's ``dlstatus``."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import status as jstatus
from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.models import llama_gen as jgen
from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.serve import (
    ContinuousGenerator,
    EngineStoppedError,
    OverloadedError,
)
from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib
from test_torch_deadline import bounded, per_test

NANO = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_position=64)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _unbind_telemetry():
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
@bounded()
def nano():
    """(port config, port params, JAX rollout of a prompt, prompts, rng)."""
    jcfg = jllama.LlamaConfig(**NANO, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**NANO, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in (5, 7, 6, 4)]
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": prompts[0][None]}, train=False)["params"]
    tparams = tllama_io.params_from_flax(jax.device_get(params), tcfg)
    memo: dict = {}

    def ref(prompt, n):
        """JAX's greedy ``generate`` on the prompt alone."""
        key = (prompt.tobytes(), n)
        if key not in memo:
            memo[key] = np.asarray(jgen.generate(
                params, jnp.asarray(prompt[None]), cfg=jcfg, max_new_tokens=n))[0]
        return memo[key]

    return tcfg, tparams, ref, prompts, rng


def _gen(nano, **kw):
    cfg, params = nano[0], nano[1]
    kw.setdefault("slots", 2)
    kw.setdefault("max_cache_len", 32)
    return ContinuousGenerator(cfg, params, device="cpu", **kw)


def _scaled(params, by):
    return {k: v * by if v.is_floating_point() else v for k, v in params.items()}


@pytest.mark.parametrize("page_size", [None, 8])
def test_tokens_equal_jax_generate_with_midflight_joins(nano, page_size):
    """4 requests over 2 slots: each output is JAX's ``generate`` on its
    prompt alone (so admission at differing positions is clean), the pool
    ran full and joined mid-flight, and tokens streamed in order."""
    _, _, ref, prompts, _ = nano
    streamed: list[int] = []
    gen = _gen(nano, prompt_buckets=(8, 16), page_size=page_size)
    with gen:
        futs = [gen.submit(p, 6, stream=(streamed.append if i == 0 else None))
                for i, p in enumerate(prompts)]
        res = [f.result(120) for f in futs]
    for p, r in zip(prompts, res):
        np.testing.assert_array_equal(r, ref(p, 6))
    assert streamed == list(res[0])
    st = gen.stats()
    assert st["completed"] == 4 and st["admitted"] == 4
    assert st["max_active"] == 2
    assert st["queue_depth"] == 0 and st["active"] == 0


def test_prefill_signatures_bounded_by_the_bucket_ladder(nano):
    """Prompts of lengths 4..7 share bucket 8: one prefill signature."""
    _, _, ref, prompts, _ = nano
    gen = _gen(nano, prompt_buckets=(8,))
    with gen:
        for p in prompts:
            np.testing.assert_array_equal(gen.generate(p, 3), ref(p, 3))
    assert len(gen._prefill._sig_compiles) == 1
    assert not any(r["recompile"] for r in gen._prefill.records)
    assert len(gen._step._sig_compiles) == 1


def test_swap_params_midflight(nano):
    """A swap mid-sequence completes the request (the tokens after it come
    from the new params; nothing drops or restarts)."""
    _, params, _, prompts, _ = nano
    gen = _gen(nano, max_cache_len=64)
    seen = threading.Event()
    with gen:
        fut = gen.submit(prompts[0], 24, stream=lambda _: seen.set())
        assert seen.wait(60), "no token streamed"
        gen.swap_params(_scaled(params, 1.01))
        out = fut.result(120)
    assert out.shape == (24,)
    assert gen.stats()["reloads"] == 1 and gen.params_version == 1


def test_oversized_refused_and_shedding_typed(nano):
    _, _, _, prompts, _ = nano
    gen = _gen(nano, max_cache_len=16, prompt_buckets=(8,), max_queue=1)
    with pytest.raises(ValueError, match="max_cache_len"):
        gen.submit(prompts[0], 16)
    with pytest.raises(ValueError, match="prompt bucket"):
        gen.submit(np.arange(9, dtype=np.int32), 2)
    fut = gen.submit(prompts[0], 2)           # queued (not started)
    with pytest.raises(OverloadedError):
        gen.submit(prompts[1], 2)
    gen.stop(drain=False)
    with pytest.raises(EngineStoppedError):
        fut.result(10)
    with pytest.raises(EngineStoppedError):
        gen.submit(prompts[1], 2)


def test_eos_frees_the_slot_early(nano):
    """eos mid-sequence completes the request (eos included) before
    max_new_tokens."""
    _, _, ref, prompts, _ = nano
    full = ref(prompts[0], 8)
    cut = next(i for i in range(1, len(full)) if full[i] not in full[:i])
    gen = _gen(nano, slots=1, eos_id=int(full[cut]))
    with gen:
        out = gen.generate(prompts[0], 8)
    np.testing.assert_array_equal(out, full[:cut + 1])


def test_paged_arena_equals_the_dense_pool(nano):
    """The same requests through the dense pool and the paged arena give
    the same tokens; every page comes back."""
    _, _, _, prompts, _ = nano
    dense = _gen(nano, prompt_buckets=(8, 16))
    with dense:
        want = [dense.generate(p, 6) for p in prompts]
    paged = _gen(nano, prompt_buckets=(8, 16), page_size=8)
    with paged:
        futs = [paged.submit(p, 6) for p in prompts]
        got = [f.result(120) for f in futs]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    st = paged.stats()
    assert st["completed"] == 4
    assert st["kv_pages_used"] == 0 and st["kv_page_allocs"] > 0


def test_prefix_reuse_equals_dense(nano):
    """A shared 16-token system prompt: requests 2..4 hit the cache, reuse
    16 tokens each, and still give the dense pool's (and JAX's) tokens."""
    _, _, ref, _, rng = nano
    system = rng.integers(0, 128, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 128, (4,)).astype(np.int32)])
               for _ in range(4)]
    paged = _gen(nano, max_cache_len=64, prompt_buckets=(8, 16, 24, 32), page_size=8)
    with paged:
        out = [paged.generate(p, 5) for p in prompts]
    dense = _gen(nano, max_cache_len=64, prompt_buckets=(8, 16, 24, 32))
    with dense:
        want = [dense.generate(p, 5) for p in prompts]
    for p, a, b in zip(prompts, out, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref(p, 5))
    st = paged.stats()
    assert st["prefix_hits"] == 3 and st["prefix_misses"] == 1
    assert st["prefix_tokens_saved"] == 48
    assert st["prefix_entries"] == 2


def test_admission_defers_under_page_pressure(nano):
    """An arena of about one long sequence: requests admit one at a time
    (deferred, not failed), all complete, every page comes back."""
    _, _, ref, _, rng = nano
    prompts = [rng.integers(0, 128, (9,)).astype(np.int32) for _ in range(3)]
    gen = _gen(nano, slots=3, prompt_buckets=(16,), page_size=8, kv_pages=6,
               prefix_cache=False)
    with gen:
        futs = [gen.submit(p, 12) for p in prompts]
        res = [f.result(120) for f in futs]
    for p, r in zip(prompts, res):
        np.testing.assert_array_equal(r, ref(p, 12))
    st = gen.stats()
    assert st["completed"] == 3 and st["deferred"] >= 1
    assert st["kv_pages_used"] == 0


def test_swap_flushes_the_prefix_cache(nano):
    _, params, _, _, rng = nano
    system = rng.integers(0, 128, (16,)).astype(np.int32)

    def mk():
        return np.concatenate([system, rng.integers(0, 128, (4,)).astype(np.int32)])

    gen = _gen(nano, max_cache_len=64, prompt_buckets=(8, 16, 24, 32), page_size=8)
    with gen:
        gen.generate(mk(), 3)
        gen.generate(mk(), 3)
        assert gen.stats()["prefix_hits"] == 1
        gen.swap_params(_scaled(params, 1.01))
        gen.generate(mk(), 3)                 # post-swap: stale entries flushed
        st = gen.stats()
    assert st["prefix_hits"] == 1 and st["prefix_misses"] == 2
    assert st["reloads"] == 1


def test_a_failing_prefill_returns_its_pages(nano, monkeypatch):
    """A prefill that raises fails ITS future; the pages it took go back
    and the generator serves the next request."""
    _, _, ref, prompts, _ = nano
    gen = _gen(nano, prompt_buckets=(8, 16), page_size=8, prefix_cache=False)
    real = gen._prefill._fn
    calls = [0]

    def poisoned(*args):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("poisoned prompt")
        return real(*args)

    monkeypatch.setattr(gen._prefill, "_fn", poisoned)
    with gen:
        bad = gen.submit(prompts[0], 4)
        with pytest.raises(RuntimeError, match="poisoned"):
            bad.result(60)
        assert gen.stats()["kv_pages_used"] == 0
        np.testing.assert_array_equal(gen.generate(prompts[1], 4), ref(prompts[1], 4))
    assert gen.stats()["kv_pages_used"] == 0


def test_span_tree_tiles_the_request_and_dlstatus_reads_it(nano, tmp_path):
    _, _, _, prompts, _ = nano
    gen = _gen(nano, prompt_buckets=(8, 16), page_size=8, workdir=str(tmp_path),
               name="nano", gauge_interval_s=0.0)
    with gen:
        futs = [gen.submit(p, 5) for p in prompts]
        for f in futs:
            f.result(120)
    telemetry.reset()
    events = telemetry.read_events(tmp_path)
    reqs = [e for e in events if e.get("kind") == "request"]
    assert len(reqs) == 4 and {e["outcome"] for e in reqs} == {"ok"}
    spans = trace_lib.spans_of(events)
    roots = [s for s in spans if s["name"] == "request"]
    assert len(roots) == 4
    for root in roots:
        kids = sorted((s for s in spans if s.get("parent_id") == root["span_id"]),
                      key=lambda s: s["t0"])
        assert [s["name"] for s in kids] == ["queue", "admission", "prefill",
                                            "decode", "stream"]
        assert kids[0]["t0"] == root["t0"] and kids[-1]["t1"] == root["t1"]
        for a, b in zip(kids, kids[1:]):
            assert a["t1"] == b["t0"]
    assert any(e.get("kind") == "serve" for e in events)
    rep = jstatus.report(str(tmp_path))
    assert rep["serving"]["ok"] == 4
    fs = jstatus.report(str(tmp_path), fleet_serve=True)["fleet_serve"]
    assert fs["totals"]["ok"] == 4


def test_export_params_and_numpy_swap_round_trip(nano):
    """The peer warm-up export: numpy leaves (bf16 as f32, exactly) that a
    swap takes back in each param's own dtype."""
    cfg, params, ref, prompts, _ = nano
    half = {k: v.to(torch.bfloat16) if k == "lm_head.weight" else v
            for k, v in params.items()}
    gen = _gen(nano)
    gen.swap_params(half, version=7)
    exported, version = gen.export_params()
    assert version == 7
    assert all(isinstance(v, np.ndarray) for v in exported.values())
    assert exported["lm_head.weight"].dtype == np.float32
    other = _gen(nano)
    other.swap_params(exported, version=version)
    assert other._params["lm_head.weight"].dtype == torch.float32
    np.testing.assert_array_equal(other._params["lm_head.weight"].numpy(),
                                  half["lm_head.weight"].float().numpy())
    with other:
        assert other.generate(prompts[0], 3).shape == (3,)


def test_params_must_match_the_model(nano):
    cfg, params, _, _, _ = nano
    with pytest.raises(ValueError, match="missing"):
        ContinuousGenerator(cfg, {k: v for k, v in params.items()
                                  if k != "lm_head.weight"}, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        _gen(nano, prompt_buckets=(8, 12), page_size=8)

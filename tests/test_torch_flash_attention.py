"""The port's flash attention forward (K1) and attention dispatch, held
against the JAX package: the Pallas kernel in interpret mode, its XLA path
and its ``_pick_impl`` rule. Inputs are made with numpy from a seed; f32
throughout, so the tolerance (2e-5, the JAX package's own flash tests')
covers summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.ops import attention as jattn
from distributeddeeplearningspark_tpu.ops import flash_attention as jfa
from distributeddeeplearningspark_tpu_torch.ops import attention as tattn
from distributeddeeplearningspark_tpu_torch.ops import flash_attention as tfa
from test_torch_deadline import per_test

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _qkv(b=2, s=128, h=2, d=32, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda hh: rng.normal(0, 1, (b, s, hh, d)).astype(np.float32)  # noqa: E731
    return mk(h), mk(hkv or h), mk(hkv or h)


def _pad_mask(b, s, valid):
    am = np.zeros((b, s), np.int32)
    for i, n in enumerate(np.broadcast_to(valid, (b,))):
        am[i, :n] = 1
    return am


def _seg_ids(b, s, boundaries):
    out = np.zeros((b, s), np.int32)
    for i, starts in enumerate(boundaries):
        for d, st in enumerate(starts):
            out[i, st:] = d
    return out


def _t(x):
    return torch.from_numpy(np.asarray(x))


# (name, qkv kwargs, flash kwargs factory) — the forward cases of
# tests/test_flash_attention.py
def _cases():
    padded_segs = _seg_ids(2, 128, [[0, 30], [0, 77]])
    padded_segs[:, 100:] = -1
    # ids that are not sorted: q tile 0 (id 7) shares no id with key tile 1
    # (id 3), and every id with key tile 2 (id 7)
    unsorted = np.full((2, 384), 7, np.int32)
    unsorted[:, 128:256] = 3
    unsorted[1, 300:] = 1
    return {
        "none": (dict(), dict()),
        "causal": (dict(), dict(causal=True)),
        "mask_bs": (dict(), dict(mask=_pad_mask(2, 128, 80))),
        "mask_b11s": (dict(), dict(
            mask=_pad_mask(2, 128, 80)[:, None, None, :] > 0)),
        "fully_masked_key_block": (dict(b=1, s=64, h=1, d=16, seed=9),
                                   dict(mask=_pad_mask(1, 64, 32))),
        "gqa": (dict(h=4, hkv=2, seed=11), dict()),
        "gqa_causal": (dict(h=4, hkv=2, seed=11), dict(causal=True)),
        "gqa_mask_causal": (dict(s=64, h=4, hkv=2, d=16, seed=17),
                            dict(mask=_pad_mask(2, 64, 48), causal=True)),
        "segments": (dict(seed=7), dict(
            segment_ids=_seg_ids(2, 128, [[0, 40, 90], [0, 64]]))),
        "segments_mask": (dict(seed=9), dict(
            mask=_pad_mask(2, 128, 100)[:, None, None, :] > 0,
            segment_ids=padded_segs)),
        "gqa_segments": (dict(h=4, hkv=2, seed=10), dict(
            segment_ids=_seg_ids(2, 128, [[0, 50], [0]]))),
        "ragged_lengths_fully_masked_row": (dict(b=3, s=64, h=2, d=16, seed=4),
                                            dict(mask=_pad_mask(3, 64, [64, 17, 0]))),
        # the edges of the CUDA kernel's tiling (128-row q tiles, 128-key
        # tiles skipped when no key is allowed, the per-element test only in
        # partly masked and causal diagonal tiles), at sizes the JAX block
        # rule admits with 64-blocks. S not a multiple of 128: the last
        # tile's rows past S
        "ragged_s320": (dict(b=2, s=320, h=2, d=32, seed=21), dict()),
        "ragged_s320_causal_padding": (dict(b=2, s=320, h=2, d=32, seed=22),
                                       dict(causal=True,
                                            mask=_pad_mask(2, 320, [300, 77]))),
        # every key past the first 128 (or 5) is padding: whole key tiles empty
        "padding_empties_key_tiles": (dict(b=3, s=384, h=2, d=32, seed=23),
                                      dict(mask=_pad_mask(3, 384, [128, 5, 384]))),
        # documents on tile boundaries: tile id ranges that do not overlap
        "segments_disjoint_tile_ranges": (
            dict(b=2, s=384, h=2, d=32, seed=24),
            dict(segment_ids=_seg_ids(2, 384, [[0, 128, 256], [0, 256]]))),
        "segments_unsorted_ids": (dict(b=2, s=384, h=2, d=32, seed=25),
                                  dict(segment_ids=unsorted)),
        "causal_padding_gqa_d128": (dict(b=2, s=256, h=4, hkv=2, d=128, seed=26),
                                    dict(causal=True,
                                         mask=_pad_mask(2, 256, [256, 140]))),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_jax_pallas(name):
    qkv_kw, kw = CASES[name]
    q, k, v = _qkv(**qkv_kw)
    s = q.shape[1]
    blk = min(64, s // 2)  # several q and k blocks on the JAX side
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=blk, block_k=blk, interpret=True,
        **{key: jnp.asarray(val) if key != "causal" else val
           for key, val in kw.items()}))
    tkw = {key: _t(val) if key != "causal" else val for key, val in kw.items()}
    got = tfa.flash_attention(_t(q), _t(k), _t(v), **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["none", "causal", "mask_bs", "gqa_mask_causal",
                                  "segments_mask",
                                  "ragged_lengths_fully_masked_row",
                                  "ragged_s320", "ragged_s320_causal_padding",
                                  "padding_empties_key_tiles",
                                  "segments_disjoint_tile_ranges",
                                  "segments_unsorted_ids",
                                  "causal_padding_gqa_d128"])
def test_flash_fwd_lse_matches_jax(name):
    """o and LSE of the wrapper (CPU → the plain version) against the JAX
    ``_flash_fwd`` in interpret mode, fully masked rows included."""
    qkv_kw, kw = CASES[name]
    q, k, v = _qkv(**qkv_kw)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    blk = min(64, s // 2)
    mask = kw.get("mask")
    kv_mask = None if mask is None else np.asarray(
        tfa.as_kv_mask(_t(mask), b, s))
    segs = kw.get("segment_ids")
    flat = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, d))  # noqa: E731
    o_j, lse_j = jfa._flash_fwd(
        flat(q), flat(k), flat(v),
        None if kv_mask is None else jnp.asarray(kv_mask),
        scale=d ** -0.5, causal=kw.get("causal", False), group=h // hkv,
        block_q=blk, block_k=blk, interpret=True,
        q_segs=None if segs is None else jnp.asarray(segs),
        kv_segs=None if segs is None else jnp.asarray(segs))
    o_t, lse_t = tfa.flash_fwd(
        _t(q), _t(k), _t(v), scale=d ** -0.5, causal=kw.get("causal", False),
        kv_mask=None if kv_mask is None else _t(kv_mask),
        q_segs=None if segs is None else _t(segs),
        kv_segs=None if segs is None else _t(segs))
    o_j = np.asarray(o_j).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=ATOL, rtol=ATOL)
    assert lse_t.shape == (b * h, s) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=ATOL)


def test_fully_masked_row_emits_zero_and_mask_value():
    q, k, v = _qkv(b=2, s=64, h=2, d=16, seed=3)
    o, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), scale=0.25,
                           kv_mask=_t(_pad_mask(2, 64, [64, 0])))
    assert torch.all(o[1] == 0)
    assert torch.all(lse.view(2, 2, 64)[1] == tfa.MASK_VALUE)
    assert torch.isfinite(o).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_impl_matches_xla_impl(name):
    """The two impls the dispatch picks between agree on every row that
    attends to at least one key; a fully masked row is O = 0 under flash
    (the xla path averages v over it instead)."""
    qkv_kw, kw = CASES[name]
    q, k, v = map(_t, _qkv(**qkv_kw))
    tkw = {key: _t(val) if key != "causal" else val for key, val in kw.items()}
    got = tattn.dot_product_attention(q, k, v, impl="flash", **tkw)
    xkw = dict(tkw)
    if "mask" in xkw:  # the xla path takes a bool [B, H, Sq, Sk]-broadcastable mask
        xkw["mask"] = tfa.as_kv_mask(xkw["mask"], q.shape[0], q.shape[1]
                                     )[:, None, None, :] != 0
    want = tattn.dot_product_attention(q, k, v, impl="xla", **xkw)
    _, lse = tfa.flash_fwd(q, k, v, **tfa.flash_operands(q, k, v, **tkw))
    b, s, h, _ = q.shape
    live = (lse.view(b, h, s) != tfa.MASK_VALUE).permute(0, 2, 1)  # [B,S,H]
    torch.testing.assert_close(got[live], want[live], atol=ATOL, rtol=ATOL)
    assert torch.all(got[~live] == 0)


def _rejects():
    q, k, v = _qkv(s=64)
    q2, k2, v2 = _qkv(b=1, s=64, h=4, hkv=3, d=16)
    return {
        "query_varying_mask": ((q, k, v), dict(mask=np.ones((2, 1, 64, 64), bool)),
                               NotImplementedError, "key-only"),
        "bias": ((q, k, v), dict(bias=np.zeros((2, 2, 64, 64), np.float32)),
                 NotImplementedError, "bias"),
        "bad_head_ratio": ((q2, k2, v2), dict(), ValueError, "multiple"),
        "kv_shape_mismatch": ((q, k, v[:, :32]), dict(), ValueError, "k/v"),
        "qk_shape_mismatch": ((q, k[:, :32], v[:, :32]), dict(), ValueError,
                              "mismatch"),
        "segment_ids_shape": ((q, k, v),
                              dict(segment_ids=np.zeros((2, 32), np.int32)),
                              ValueError, "segment_ids"),
        "mask_key_dim": ((q, k, v), dict(mask=np.ones((2, 32), np.int32)),
                         ValueError, "key dim"),
    }


REJECTS = _rejects()


@pytest.mark.parametrize("name", sorted(REJECTS))
def test_flash_rejects_like_jax(name):
    (q, k, v), kw, exc, match = REJECTS[name]
    with pytest.raises(exc, match=match):
        jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True,
                            **{key: jnp.asarray(val) for key, val in kw.items()})
    with pytest.raises(exc, match=match):
        tfa.flash_attention(*map(_t, (q, k, v)),
                            **{key: _t(val) for key, val in kw.items()})


# -- the XLA path and the dispatch rule --------------------------------------

XLA_CASES = {
    "none": (dict(), dict()),
    "causal": (dict(), dict(causal=True)),
    "mask": (dict(), dict(mask=_pad_mask(2, 128, 80)[:, None, None, :] > 0)),
    "fully_masked_row": (dict(b=2, s=64), dict(
        mask=_pad_mask(2, 64, [64, 0])[:, None, None, :] > 0)),
    "bias_scale": (dict(seed=5), dict(
        bias=np.random.default_rng(1).normal(0, 1, (2, 2, 128, 128)).astype(
            np.float32), scale=0.3)),
}


@pytest.mark.parametrize("name", sorted(XLA_CASES))
def test_xla_attention_matches_jax(name):
    qkv_kw, kw = XLA_CASES[name]
    q, k, v = _qkv(**qkv_kw)
    full = {**dict(bias=None, mask=None, causal=False, scale=None), **kw}
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in full.items()}
    tkw = {key: _t(val) if isinstance(val, np.ndarray) else val
           for key, val in full.items()}
    want = np.asarray(jattn._xla_attention(*map(jnp.asarray, (q, k, v)), **jkw))
    got = tattn._xla_attention(*map(_t, (q, k, v)), **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dot_product_attention_gqa_segments_matches_jax(impl):
    q, k, v = _qkv(h=4, hkv=2, seed=21)
    segs = _seg_ids(2, 128, [[0, 50], [0, 9]])
    mask = _pad_mask(2, 128, [128, 120])[:, None, None, :] > 0
    want = np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask),
        segment_ids=jnp.asarray(segs), impl="xla"))
    got = tattn.dot_product_attention(*map(_t, (q, k, v)), mask=_t(mask),
                                      segment_ids=_t(segs), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


class _CudaLike:
    """A stand-in for a CUDA tensor: only the attributes _pick_impl reads."""

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape = shape
        self.dtype = dtype
        self.device = torch.device("cuda")


PICK_CASES = {
    "bert": ((2, 512, 12, 64), (2, 512, 12, 64), None, (2, 1, 1, 512)),
    "bert_bs_mask": ((2, 512, 12, 64), (2, 512, 12, 64), None, (2, 512)),
    "gqa_long": ((1, 8192, 8, 128), (1, 8192, 2, 128), None, None),
    "query_varying_mask": ((2, 512, 12, 64), (2, 512, 12, 64), None,
                           (2, 1, 512, 512)),
    "bias": ((2, 512, 12, 64), (2, 512, 12, 64), (2, 12, 512, 512), None),
    "short_seq": ((2, 256, 12, 64), (2, 256, 12, 64), None, None),
    "seq_not_block_multiple": ((2, 768, 12, 64), (2, 768, 12, 64), None, None),
    "head_dim_not_8": ((2, 512, 12, 60), (2, 512, 12, 60), None, None),
    "rank5_mask": ((2, 512, 12, 64), (2, 512, 12, 64), None, (2, 1, 1, 1, 512)),
}


@pytest.mark.parametrize("min_seq", [None, "100000"])
@pytest.mark.parametrize("name", sorted(PICK_CASES))
def test_pick_impl_matches_jax_rule(name, min_seq, monkeypatch):
    """With "on TPU" read as "on CUDA", the port picks what the JAX rule
    picks; off CUDA it picks xla, as the JAX rule does off TPU."""
    if min_seq is not None:
        monkeypatch.setenv("DLS_FLASH_MIN_SEQ", min_seq)
    qs, ks, bias_s, mask_s = PICK_CASES[name]
    jbias = None if bias_s is None else jnp.zeros(bias_s)
    jmask = None if mask_s is None else jnp.ones(mask_s, bool)
    tbias = None if bias_s is None else torch.zeros(bias_s)
    tmask = None if mask_s is None else torch.ones(mask_s, dtype=torch.bool)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jattn._pick_impl(jnp.zeros(qs), jnp.zeros(ks), jbias, jmask)
    got = tattn._pick_impl(_CudaLike(qs), _CudaLike(ks), tbias, tmask)
    assert got == want
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert jattn._pick_impl(jnp.zeros(qs), jnp.zeros(ks), jbias, jmask) == "xla"
    assert tattn._pick_impl(torch.zeros(1).expand(qs),
                            torch.zeros(1).expand(ks), tbias, tmask) == "xla"


# inputs the JAX rule sends to its Pallas kernel (which takes q's dtype and
# any head dim that is a multiple of 8) but the CUDA kernels refuse (bf16,
# head dim in KERNEL_HEAD_DIMS): here the port deliberately picks xla
REFUSED_CASES = {
    "f32_bert": ((2, 512, 12, 64), (2, 512, 12, 64), torch.float32),
    "f32_gqa_d128": ((1, 1024, 8, 128), (1, 1024, 2, 128), torch.float32),
    "bf16_d32": ((2, 512, 24, 32), (2, 512, 24, 32), torch.bfloat16),
    "bf16_d96": ((2, 512, 8, 96), (2, 512, 8, 96), torch.bfloat16),
    "bf16_d256": ((2, 512, 4, 256), (2, 512, 4, 256), torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(REFUSED_CASES))
def test_pick_impl_declines_what_the_cuda_kernel_refuses(name, monkeypatch):
    """A deliberate difference from the JAX rule: "auto" must not hand the
    CUDA kernel a dtype or head dim whose call it would refuse."""
    qs, ks, dtype = REFUSED_CASES[name]
    mask_s = (qs[0], 1, 1, qs[1])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    assert jattn._pick_impl(jnp.zeros(qs, jdt), jnp.zeros(ks, jdt), None,
                            jnp.ones(mask_s, bool)) == "flash"
    assert tattn._pick_impl(_CudaLike(qs, dtype), _CudaLike(ks, dtype), None,
                            torch.ones(mask_s, dtype=torch.bool)) == "xla"
    # the same shape in bf16 at a kernel head dim takes the kernel
    d_ok = qs[-1] if qs[-1] in tfa.KERNEL_HEAD_DIMS else 64
    assert tattn._pick_impl(_CudaLike(qs[:-1] + (d_ok,)),
                            _CudaLike(ks[:-1] + (d_ok,)), None, None) == "flash"


@pytest.mark.parametrize("dtype,d,exc", [(torch.float32, 64, TypeError),
                                         (torch.float16, 128, TypeError),
                                         (torch.bfloat16, 32, ValueError),
                                         (torch.bfloat16, 96, ValueError)])
def test_kernel_operand_check_refuses_what_the_gate_declines(dtype, d, exc):
    """The wrappers keep raising on what their kernels refuse: the gate
    decides, the wrapper never falls back."""
    q = torch.zeros(1, 128, 2, d, dtype=dtype)
    with pytest.raises(exc):
        tfa._check_cuda_operands(q, q, q, (None, None, None))


def test_padding_mask_matches_jax():
    am = _pad_mask(3, 16, [16, 5, 0])
    np.testing.assert_array_equal(tattn.padding_mask(_t(am)).numpy(),
                                  np.asarray(jattn.padding_mask(jnp.asarray(am))))


def test_expand_gqa_matches_jax():
    q, k, v = _qkv(b=1, s=8, h=6, hkv=2, d=4)
    jk, jv = jattn._expand_gqa(*map(jnp.asarray, (q, k, v)))
    tk, tv = tattn._expand_gqa(*map(_t, (q, k, v)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape", [(64,), (2, 64), (2, 1, 1, 64), (2, 1, 64),
                                   (2, 4, 64, 64), (2, 1, 64, 64),
                                   (1, 1, 1, 1, 64)])
def test_key_only_mask_matches_jax(shape):
    assert tattn._key_only_mask(torch.ones(shape), 64) == \
        jattn._key_only_mask(jnp.ones(shape), 64)


def test_cuda_wrapper_raises_without_kernel_inputs():
    """The CUDA path takes no CPU fallback: a non-CPU, non-CUDA tensor raises
    rather than silently running the plain version."""
    q = torch.zeros(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(q, q, q, scale=1.0)


# -- the backward (K2/K3): autograd through _FlashAttention ------------------


def _dout(shape, seed=99):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_jax_pallas(name):
    """Gradients of the port's flash_attention (the autograd Function; on the
    CPU its plain backward) against jax.grad of the JAX flash_attention with
    its Pallas backward in interpret mode, f32 at 2e-5."""
    qkv_kw, kw = CASES[name]
    q, k, v = _qkv(**qkv_kw)
    do = _dout(q.shape)
    jkw = {key: jnp.asarray(val) if key != "causal" else val
           for key, val in kw.items()}

    def objective(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=64, block_k=64,
                                interpret=True, **jkw)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(objective, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tkw = {key: _t(val) if key != "causal" else val for key, val in kw.items()}
    out = tfa.flash_attention(tq, tk, tv, **tkw)
    (out * _t(do)).sum().backward()
    for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("name", ["none", "causal", "mask_bs", "gqa_mask_causal",
                                  "segments_mask", "gqa_segments",
                                  "ragged_lengths_fully_masked_row",
                                  # the edges of K2's and K3's tiling
                                  "ragged_s320", "ragged_s320_causal_padding",
                                  "padding_empties_key_tiles",
                                  "segments_disjoint_tile_ranges",
                                  "segments_unsorted_ids",
                                  "causal_padding_gqa_d128"])
def test_backward_reference_matches_jax_flash_bwd(name):
    """flash_attention_backward_reference (K2/K3's plain version) against
    the JAX ``_flash_bwd`` in interpret mode on the same o, LSE and dO; the
    wrapper ``flash_bwd`` and the per-kernel wrappers take it on CPU."""
    qkv_kw, kw = CASES[name]
    q, k, v = _qkv(**qkv_kw)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    blk = min(64, s // 2)
    mask = kw.get("mask")
    kv_mask = None if mask is None else np.asarray(tfa.as_kv_mask(_t(mask), b, s))
    segs = kw.get("segment_ids")
    causal = kw.get("causal", False)
    flat = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, d))  # noqa: E731
    jm = None if kv_mask is None else jnp.asarray(kv_mask)
    js = None if segs is None else jnp.asarray(segs)
    o_j, lse_j = jfa._flash_fwd(flat(q), flat(k), flat(v), jm, scale=d ** -0.5,
                                causal=causal, group=h // hkv, block_q=blk,
                                block_k=blk, interpret=True, q_segs=js, kv_segs=js)
    do = _dout(q.shape, seed=5)
    res = (flat(q), flat(k), flat(v), jm, o_j, lse_j, js, js)
    want = jfa._flash_bwd(res, flat(do), scale=d ** -0.5, causal=causal,
                          group=h // hkv, block_q=blk, block_k=blk,
                          interpret=True)
    unflat = lambda x, heads: np.asarray(x).reshape(b, heads, s, d).transpose(0, 2, 1, 3)  # noqa: E731
    o_t = _t(unflat(o_j, h).copy())
    lse_t = _t(np.asarray(lse_j).copy())
    tkw = dict(kv_mask=None if kv_mask is None else _t(kv_mask),
               q_segs=None if segs is None else _t(segs),
               kv_segs=None if segs is None else _t(segs),
               scale=d ** -0.5, causal=causal)
    ref = tfa.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), o_t, lse_t, _t(do), **tkw)
    for got, exp, heads in zip(ref, want, (h, hkv, hkv)):
        np.testing.assert_allclose(got.numpy(), unflat(exp, heads), atol=ATOL,
                                   rtol=ATOL)
        assert torch.isfinite(got).all()
    wrapped = tfa.flash_bwd(_t(q), _t(k), _t(v), o_t, lse_t, _t(do), **tkw)
    delta = tfa._delta(o_t, _t(do))
    dq = tfa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse_t, delta, **tkw)
    dk, dv = tfa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse_t, delta, **tkw)
    for got, exp in zip((*wrapped, dq, dk, dv), (*ref, *ref)):
        torch.testing.assert_close(got, exp, atol=ATOL, rtol=ATOL)
    if name == "ragged_lengths_fully_masked_row":
        assert torch.all(ref[0][2] == 0)  # the row that attends to nothing


def test_fully_masked_row_gets_zero_dq():
    """P is zeroed by the mask, not the exponent: with LSE = -1e30 a fully
    masked row's exp(s - LSE) would be 1."""
    q, k, v = map(_t, _qkv(b=2, s=64, h=2, d=16, seed=3))
    for t in (q, k, v):
        t.requires_grad_()
    out = tfa.flash_attention(q, k, v, mask=_t(_pad_mask(2, 64, [64, 0])))
    out.sum().backward()
    assert torch.all(q.grad[1] == 0) and torch.all(k.grad[1] == 0)
    assert torch.all(v.grad[1] == 0)
    assert torch.isfinite(q.grad).all() and q.grad[0].abs().sum() > 0


def _packed_saves(fn):
    """How many tensors autograd packs for backward while ``fn`` runs."""
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, len(packed)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_inference_saves_nothing_and_has_no_grad_fn(mode):
    q, k, v = (_t(x).requires_grad_() for x in _qkv(s=64))
    ctx = torch.inference_mode if mode == "inference_mode" else torch.no_grad
    with ctx():
        out, saved = _packed_saves(lambda: tfa.flash_attention(q, k, v))
    assert out.grad_fn is None and saved == 0


def test_grad_mode_records_the_flash_function():
    q, k, v = (_t(x).requires_grad_() for x in _qkv(s=64))
    out, saved = _packed_saves(lambda: tfa.flash_attention(q, k, v, causal=True))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert saved >= 5  # q, k, v, o, lse


@pytest.mark.parametrize("name", ["causal", "mask_b11s", "gqa_segments"])
def test_flash_and_xla_impls_agree_on_gradients(name):
    """Both dispatch paths are differentiable and agree (no fully masked
    rows in these cases, where the two paths differ by design)."""
    qkv_kw, kw = CASES[name]
    grads = {}
    for impl in ("flash", "xla"):
        q, k, v = (_t(x).requires_grad_() for x in _qkv(**qkv_kw))
        tkw = {key: _t(val) if key != "causal" else val for key, val in kw.items()}
        if impl == "xla" and "mask" in tkw:
            tkw["mask"] = tfa.as_kv_mask(tkw["mask"], q.shape[0], q.shape[1]
                                         )[:, None, None, :] != 0
        out = tattn.dot_product_attention(q, k, v, impl=impl, **tkw)
        (out * _t(_dout(out.shape))).sum().backward()
        grads[impl] = (q.grad, k.grad, v.grad)
    for a, b in zip(grads["flash"], grads["xla"]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=ATOL)


def test_backward_wrapper_refuses_other_devices():
    q = torch.zeros(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_bwd(q, q, q, q, torch.zeros(1, 64, device="meta"), q, scale=1.0)

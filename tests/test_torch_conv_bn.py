"""K4's plain path and ``Conv1x1BN`` of the port against the JAX package.

The JAX ``matmul_stats`` runs its Pallas kernel in interpret mode on the
CPU, as ``tests/test_conv_bn.py`` runs it; the port's wrapper takes its
plain version for CPU tensors. Inputs come from numpy with a seed.
Tolerances: f32 on both sides differs only in summation order (1e-5
relative on Y; the column sums over up to 1024 rows 1e-5 of Σ|y|); bf16
rounds Y once from an f32 accumulator on both sides, so Y may differ by one
bf16 step (2⁻⁸ relative) where the two sums land on either side of a
rounding boundary, and the f32 stats stay within 1e-5 of Σ|y|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.ops import conv_bn as jconv
from distributeddeeplearningspark_tpu_torch.ops import conv_bn as tconv

# (M, K, N, JAX block sizes): several row blocks and K steps, one block,
# and ragged widths the gate admits (K, N not multiples of 8)
SHAPES = [
    (64, 32, 128, (32, 64, 32)),
    (64, 64, 128, (32, 64, 32)),
    (8, 16, 16, (512, 512, 512)),
    (1024, 40, 72, (512, 512, 512)),
    (256, 16, 16, (512, 512, 512)),
    (48, 13, 24, (512, 512, 512)),
]


def _xw(m, k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (m, k)).astype(dtype),
            rng.normal(0, 0.1, (k, n)).astype(dtype))


@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_stats_plain_matches_the_pallas_kernel(m, k, n, blocks, dtype):
    x, w = _xw(m, k, n, seed=m + k + n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    jy, js1, js2 = jconv.matmul_stats(jx, jw, *blocks)
    ty, ts1, ts2 = tconv.matmul_stats(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(w).to(tdt))
    assert ty.dtype == tdt and ts1.dtype == ts2.dtype == torch.float32
    y_ref = np.asarray(jy.astype(jnp.float32))
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(ty.float().numpy(), y_ref, rtol=rtol, atol=1e-6)
    y32 = np.asarray(jnp.dot(jx.astype(jnp.float32), jw.astype(jnp.float32)))
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1),
                               atol=1e-5 * np.abs(y32).sum(0).max())
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=1e-5,
                               atol=1e-5 * (y32 * y32).sum(0).max())


def test_matmul_stats_gradients_match_the_custom_vjp():
    """A loss using y, mean and var, as tests/test_conv_bn.py's: the stats
    cotangents exercise the dY + ds1 + 2·Y·ds2 fold."""
    x, w = _xw(32, 16, 32, seed=2)
    m = x.shape[0]

    def loss_of(y, s1, s2, sqrt, total):
        mean = s1 / m
        var = s2 / m - mean * mean
        return total(y ** 2) * 0.01 + total(mean ** 2) + total(sqrt(var + 1e-5))

    gj = jax.grad(lambda a, b: loss_of(*jconv.matmul_stats(a, b, 16, 16, 16),
                                       jnp.sqrt, jnp.sum),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss_of(*tconv.fused_matmul_stats(tx, tw), torch.sqrt, torch.sum).backward()
    for got, want in ((tx.grad, gj[0]), (tw.grad, gj[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_matmul_stats_backward_without_stats_cotangents():
    """Only y used: ds1/ds2 arrive as None and the backward is y's."""
    x, w = _xw(16, 8, 8, seed=3)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tconv.fused_matmul_stats(tx, tw)[0].sum().backward()
    ones = np.ones((16, 8), np.float32)
    np.testing.assert_allclose(tx.grad.numpy(), ones @ w.T, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), x.T @ ones, rtol=1e-5)


def test_bad_shapes_are_refused():
    x, w = (torch.from_numpy(a) for a in _xw(30, 16, 32, seed=0))
    with pytest.raises(ValueError, match="divisible by 8"):
        tconv.matmul_stats(x, w)
    with pytest.raises(ValueError, match="mismatch"):
        tconv.matmul_stats(torch.zeros(8, 16), torch.zeros(8, 32))
    with pytest.raises(ValueError, match="divisible by blocks"):
        tconv.matmul_stats(torch.zeros(1000, 16), torch.zeros(16, 32))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tconv.matmul_stats(torch.zeros(8, 16, device="meta"),
                           torch.zeros(16, 32, device="meta"))


def _resnet50_conv_bn_shapes(batch: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every Conv1x1BN call of a fused ResNet-50 forward at
    224²: v1.5 puts the stride on the 3×3, so a block's first 1×1 runs at
    its input's resolution."""
    shapes, cin, res = [], 64, 56
    for stage, blocks in enumerate((3, 4, 6, 3)):
        filters = 64 * 2 ** stage
        for block in range(blocks):
            out_res = res // 2 if stage > 0 and block == 0 else res
            shapes.append((batch * res * res, cin, filters))
            shapes.append((batch * out_res * out_res, filters, 4 * filters))
            cin, res = 4 * filters, out_res
    return shapes


@pytest.mark.parametrize("batch,fused", [(32, 15), (128, 27), (256, 27)])
def test_can_fuse_is_the_jax_gate_over_resnet50(batch, fused):
    shapes = _resnet50_conv_bn_shapes(batch)
    assert len(shapes) == 32
    got = [tconv.can_fuse(*s) for s in shapes]
    assert got == [jconv.can_fuse(*s) for s in shapes]
    assert sum(got) == fused


@pytest.mark.parametrize("m,k,n", [(8, 3, 5), (520, 16, 16), (1536, 1024, 512),
                                   (1024, 600, 64), (4096, 512, 700)])
def test_can_fuse_matches_jax_on_edge_shapes(m, k, n):
    assert tconv.can_fuse(m, k, n) == jconv.can_fuse(m, k, n)


def test_rows_are_a_view_of_channels_last():
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    rows = tconv.channels_last_rows(x)
    assert rows.shape == (32, 8) and rows.data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="channels_last"):
        tconv.channels_last_rows(torch.randn(2, 8, 4, 4))


def _modules(cin, cout, dtype, fused, seed):
    """The JAX Conv1x1BN's variables (scale and bias made nonzero) and a
    port module carrying the same."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jconv.Conv1x1BN(cout, dtype=jdt, fused=fused)
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), np.zeros((1, 2, 2, cin), np.float32),
        train=False))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    v["params"]["bias"] = rng.normal(0, 0.5, cout).astype(np.float32)
    v["batch_stats"]["mean"] = rng.normal(0, 0.1, cout).astype(np.float32)
    v["batch_stats"]["var"] = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    tm = tconv.Conv1x1BN(cin, cout, dtype=getattr(torch, dtype), fused=fused)
    tm.load_state_dict({
        "kernel": torch.from_numpy(v["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "scale": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "var": torch.from_numpy(v["batch_stats"]["var"])})
    return jm, v, tm


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy → NCHW channels_last tensor (the same bytes)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# f32: summation order; bf16: the output rounds y·g + b in bf16 once (the
# port) or with XLA's excess precision (JAX), one or two bf16 steps on
# values of a few units
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("fused", [True, False])
def test_conv1x1bn_matches_the_jax_module(dtype, tol, fused):
    jm, v, tm = _modules(16, 32, dtype, fused, seed=4)
    x = np.random.default_rng(5).normal(1.0, 2.0, (2, 8, 8, 16)).astype(np.float32)
    for train in (True, False):
        want, up = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
        tm.train(train)
        got = tm(_nchw(x))
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().detach().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"train={train}")
        if train:
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    getattr(tm, k).numpy(), np.asarray(up["batch_stats"][k]),
                    rtol=1e-5, atol=1e-5 if dtype == "float32" else 1e-3,
                    err_msg=k)
            tm.load_state_dict({**tm.state_dict(),
                                "mean": torch.from_numpy(v["batch_stats"]["mean"]),
                                "var": torch.from_numpy(v["batch_stats"]["var"])})


@pytest.mark.parametrize("fused", [True, False])
def test_conv1x1bn_gradients_match_the_jax_module(fused):
    jm, v, tm = _modules(16, 32, "float32", fused, seed=6)
    x = np.random.default_rng(7).normal(0, 1, (2, 4, 4, 16)).astype(np.float32)
    w_out = np.random.default_rng(8).normal(0, 1, (2, 4, 4, 32)).astype(np.float32)

    def jloss(params, xx):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w_out)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    tx = _nchw(x.copy()).requires_grad_()
    tm.train()
    (tm(tx).permute(0, 2, 3, 1) * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tm.kernel.grad.numpy(),
        np.asarray(gp["kernel"]).transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(gp[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_conv1x1bn_takes_the_kernel_path_only_where_the_gate_admits(monkeypatch):
    calls = []
    plain = tconv.matmul_stats
    monkeypatch.setattr(tconv, "matmul_stats",
                        lambda x, w: calls.append(tuple(x.shape) + (w.shape[1],))
                        or plain(x, w))
    mod = tconv.Conv1x1BN(16, 8)
    x = torch.randn(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    mod.train()
    mod(x)                                  # M = 32: admitted
    mod(x[:, :, :3, :3].contiguous(memory_format=torch.channels_last))  # M = 18
    mod.eval()
    mod(x)
    mod.train()
    mod.fused = False
    mod(x)
    assert calls == [(32, 16, 8)]


@pytest.mark.parametrize("dtype,fuses", [(torch.bfloat16, True),
                                         (torch.float32, False)])
def test_conv1x1bn_off_the_cpu_fuses_only_bf16(dtype, fuses, monkeypatch):
    """Off the CPU (here the meta device standing in for the card) an f32
    module takes the unfused chain, since K4 takes bf16 only; a bf16 one
    takes the kernel path. On the CPU both fuse (the tests above)."""
    calls = []

    def fused(x, w):
        assert fuses, "an f32 module must not reach K4's path off the CPU"
        calls.append(x.dtype)
        m, n = x.shape[0], w.shape[1]
        return (torch.empty(m, n, dtype=x.dtype, device=x.device),
                torch.empty(n, device=x.device), torch.empty(n, device=x.device))

    monkeypatch.setattr(tconv, "fused_matmul_stats", fused)
    mod = tconv.Conv1x1BN(16, 8, dtype=dtype, device="meta")
    x = torch.empty(2, 16, 4, 4, device="meta").contiguous(
        memory_format=torch.channels_last)
    mod.train()
    out = mod(x)
    assert out.shape == (2, 8, 4, 4) and out.dtype == dtype
    assert calls == ([dtype] if fuses else [])

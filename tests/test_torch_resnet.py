"""The port's ResNet against the JAX package's, on tiny models.

A bottleneck ResNet with stage sizes (1, 1), width 16, 10 classes, on a
batch of 8 images of 32×32 — small enough for the CPU, and every one of its
1×1 conv→BN pairs is admitted by the K4 gate (M = 512 and 128) — in the
fused (``Conv1x1BN``) and unfused layouts, and a ``BasicBlock`` (ResNet-18/34)
model of the same stages at width 8. The JAX model's variables, with every BatchNorm scale set to
nonzero numpy values (so that the zero-gamma last BN does not make its
gradients trivially 0) and nonzero running statistics, are carried across
by ``params_from_flax``. The JAX fused path runs its Pallas kernel in
interpret mode. Tolerances: f32 on both sides differs in summation order
(convolutions by other algorithms), 1e-4 relative to each tensor's largest
value; bf16 logits differ by where each framework rounds activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.models import resnet as jresnet
from distributeddeeplearningspark_tpu.ops import conv_bn as jconv
from distributeddeeplearningspark_tpu_torch.models import resnet as tresnet
from distributeddeeplearningspark_tpu_torch.models.resnet_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.ops import conv_bn as tconv
from test_torch_deadline import bounded, per_test

BATCH, SIZE, CLASSES = 8, 32, 10
F32_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _close(got, want, rtol=F32_RTOL, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-6),
                               err_msg=msg)


def _variables(jm, seed):
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, jax.jit(
        lambda img: jm.init(jax.random.PRNGKey(seed), {"image": img},
                            train=False))(np.zeros((1, SIZE, SIZE, 3), np.float32)))

    def nonzero(path, leaf):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return leaf

    return {k: jax.tree_util.tree_map_with_path(nonzero, t) for k, t in v.items()}


def _case(kind: str, dtype: str = "float32"):
    """(JAX results, port model) for one tiny model: logits in train and
    eval mode, the batch_stats after the train forward, parameter
    gradients of sum(logits·R) as a port state dict (f32 only), and the
    number of matmul_stats calls in one JAX train forward."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    if kind == "basic":
        kw = dict(stage_sizes=(1, 1), num_classes=CLASSES, width=8)
        jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, dtype=jdt, **kw)
        tm = tresnet.ResNet(block_cls=tresnet.BasicBlock, dtype=tdt,
                            device="cpu", **kw)
    else:
        kw = dict(stage_sizes=(1, 1), num_classes=CLASSES, width=16,
                  fused_conv_bn=kind == "fused")
        jm = jresnet.ResNet(block_cls=jresnet.BottleneckBlock, dtype=jdt, **kw)
        tm = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, dtype=tdt,
                            device="cpu", **kw)
    v = _variables(jm, seed=1)
    rng = np.random.default_rng(2)
    img = rng.normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    r = rng.normal(0, 1, (BATCH, CLASSES)).astype(np.float32)
    calls = []
    plain = jconv.matmul_stats
    jconv.matmul_stats = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        train_out, updated = jax.jit(lambda v, x: jm.apply(
            v, {"image": x}, train=True, mutable=["batch_stats"]))(v, img)
    finally:
        jconv.matmul_stats = plain
    eval_out = jax.jit(lambda v, x: jm.apply(v, {"image": x}, train=False))(v, img)
    tm.load_state_dict(params_from_flax(v["params"], v["batch_stats"]))
    want = dict(
        train=np.asarray(train_out), eval=np.asarray(eval_out),
        stats=params_from_flax(v["params"], jax.tree.map(np.asarray, updated)),
        calls=len(calls), img=img, r=r)
    if dtype == "float32":
        grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, {"image": img},
            train=True, mutable=["batch_stats"])[0] * r)))(v["params"])
        want["grads"] = params_from_flax(jax.tree.map(np.asarray, grads),
                                         v["batch_stats"])
    return want, tm


@pytest.fixture(scope="module", params=["fused", "unfused", "basic"])
@bounded()
def built(request):
    want, tm = _case(request.param)
    return request.param, want, tm, {k: v.clone() for k, v in tm.state_dict().items()}


@pytest.fixture
def case(built):
    """The module's model, back at the carried-across weights."""
    kind, want, tm, initial = built
    tm.load_state_dict(initial)
    return kind, want, tm


def test_logits_in_train_and_eval_mode(case, built):
    kind, want, tm = case
    img = torch.from_numpy(want["img"])
    tm.train()
    _close(tm({"image": img}).detach(), want["train"], msg=f"{kind} train")
    tm.load_state_dict(built[3])
    tm.eval()
    _close(tm({"image": img}).detach(), want["eval"], msg=f"{kind} eval")


def test_batch_stats_after_a_train_forward(case):
    kind, want, tm = case
    tm.train()
    with torch.no_grad():
        tm({"image": torch.from_numpy(want["img"])})
    got = tm.state_dict()
    names = [k for k in want["stats"] if k.endswith((".mean", ".var"))]
    assert len(names) == 2 * sum(1 for m in tm.modules()
                                 if isinstance(m, (tresnet.BatchNorm,
                                                   tconv.Conv1x1BN)))
    for k in names:
        _close(got[k], want["stats"][k], msg=f"{kind} {k}")


def test_every_parameter_gradient(case):
    kind, want, tm = case
    tm.train()
    tm.zero_grad(set_to_none=True)
    (tm({"image": torch.from_numpy(want["img"])})
     * torch.from_numpy(want["r"])).sum().backward()
    params = dict(tm.named_parameters())
    assert set(params) == {k for k in want["grads"]
                           if not k.endswith((".mean", ".var"))}
    for name, p in params.items():
        ref = want["grads"][name]
        assert float(ref.abs().max()) > 0, f"{name}: trivial reference gradient"
        _close(p.grad, ref, rtol=5e-4, msg=f"{kind} {name}")


def test_kernel_calls_equal_the_jax_fused_layers(case, monkeypatch):
    kind, want, tm = case
    calls = []
    plain = tconv.matmul_stats
    monkeypatch.setattr(tconv, "matmul_stats",
                        lambda x, w: calls.append(1) or plain(x, w))
    tm.train()
    with torch.no_grad():
        tm({"image": torch.from_numpy(want["img"])})
    assert len(calls) == want["calls"] == (4 if kind == "fused" else 0)


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_bf16_logits(kind):
    """bf16 activations on both sides: the logits agree to bf16 rounding
    compounded over 3 blocks (2e-2 of the largest logit)."""
    want, tm = _case(kind, "bfloat16")
    img = torch.from_numpy(want["img"])
    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    for train in (True, False):
        tm.load_state_dict(initial)
        tm.train(train)
        _close(tm({"image": img}).detach(), want["train" if train else "eval"],
               rtol=2e-2, msg=f"train={train}")


def test_resnet50_is_the_jax_resnet50():
    """Same parameter and buffer counts as the JAX ResNet-50 (from its
    shapes alone), 32 Conv1x1BN layers, channels-last activations."""
    model = tresnet.resnet50(device="cpu", seed=0)
    shapes = jax.eval_shape(
        lambda x: jresnet.ResNet50(fused_conv_bn=True).init(
            jax.random.PRNGKey(0), {"image": x}, train=False),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))  # shapes: any size
    count = lambda t: sum(int(np.prod(s.shape)) for s in jax.tree.leaves(t))  # noqa: E731
    assert sum(p.numel() for p in model.parameters()) == count(shapes["params"])
    assert sum(b.numel() for b in model.buffers()) == count(shapes["batch_stats"])
    assert len(model.conv_bn_layers()) == 32
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # zero-gamma on each block's last BN
    assert all(not b.conv_bn_3.scale.detach().any() for b in model.blocks)
    # lecun-normal kernels, truncated at ±2σ
    w = model.blocks[5].conv_2.weight.detach()
    std = (1 / (128 * 9)) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.02


def test_resnet18_stages():
    model = tresnet.ResNet18(num_classes=CLASSES, width=8, device="cpu")
    assert [type(b).__name__ for b in model.blocks] == ["BasicBlock"] * 8
    assert model.head.in_features == 64


def test_fused_conv_bn_needs_bottlenecks():
    with pytest.raises(ValueError, match="BottleneckBlock"):
        tresnet.ResNet18(fused_conv_bn=True, device="cpu")


def test_resnet50_raises_without_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tresnet.resnet50()

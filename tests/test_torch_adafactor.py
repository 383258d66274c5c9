"""The optimizers the port writes out where the JAX package calls optax:
``optim.adafactor``, ``lars`` and ``lamb`` against the JAX package's
(``optax`` 0.2.6's) on the CPU. ``adafactor``: 5 steps from the same params and
gradients, made from a seed with numpy, for tensors it factors (two dims
of at least ``min_dim_size_to_factor``, 3-D included) and tensors it
keeps whole (vectors, a matrix with a short dim, a small square), with
and without weight decay, with a schedule, and under ``masked`` through
the port's train step (JAX's ``multi_transform`` with ``set_to_zero``:
the masked-off params take no update and no state). Its refusal of
shards and ZeRO slices, whose factored moments and RMS scalings a slice
alone cannot give.

Tolerance: f32, the same operations summed in another order (means over
rows and columns); the params after 5 steps at 1e-5 relative, 1e-7
absolute."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.train import step as tstep
from distributeddeeplearningspark_tpu_torch.train.state import TrainState

from test_torch_deadline import per_test

RTOL, ATOL, STEPS = 1e-5, 1e-7, 5
SHAPES = {"big": (256, 130), "cube": (130, 200, 3), "square": (64, 64),
          "short": (300, 8), "vec": (7,), "wide": (128, 129)}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed):
    rng = np.random.default_rng(100 + seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("schedule", [False, True])
def test_adafactor_matches_optax(weight_decay, schedule):
    lr_j = optax.linear_schedule(1e-2, 1e-3, STEPS) if schedule else 1e-2
    lr_t = toptim.linear_schedule(1e-2, 1e-3, STEPS) if schedule else 1e-2
    jtx = joptim.adafactor(lr_j, weight_decay=weight_decay)
    ttx = toptim.adafactor(lr_t, weight_decay=weight_decay)
    names = list(SHAPES)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = [torch.tensor(_params()[k]) for k in names]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(STEPS):
        g = _grads(step)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([torch.tensor(g[k]) for k in names], ts, tp)
        torch._foreach_add_(tp, tu)
    for k, t in zip(names, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the state: factored tensors keep row and column means, the rest whole
    factored = {k for k, s in SHAPES.items()
                if len(s) > 1 and sorted(s)[-2] >= 128}
    assert factored == {"big", "cube", "wide"}
    state = ts[0]
    for k, vr, vc, v in zip(names, state.v_row, state.v_col, state.v):
        jvr = np.asarray(js[0].v_row[k])
        jvc = np.asarray(js[0].v_col[k])
        jv = np.asarray(js[0].v[k])
        assert (tuple(vr.shape), tuple(vc.shape), tuple(v.shape)) == \
            (jvr.shape, jvc.shape, jv.shape), k
        np.testing.assert_allclose(vr.numpy(), jvr, rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(vc.numpy(), jvc, rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(v.numpy(), jv, rtol=RTOL, err_msg=k)
    assert int(state.count) == int(js[0].count) == STEPS


class _Fixed(torch.nn.Module):
    """Params whose loss is Σ p·G: the gradient of each is the batch's G."""

    def __init__(self, params: dict[str, np.ndarray]):
        super().__init__()
        self.w = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                         for k, v in params.items()})

    def forward(self, batch, generator=None):
        return sum((p * batch[k]).sum() for k, p in self.w.items())


def test_adafactor_under_masked_is_jaxs():
    """``masked(adafactor, trainable)`` through the port's train step
    against JAX's ``masked``: the trainable params (factored and whole) as
    optax moves them, the others untouched and without state."""
    trainable = lambda path: "big" in path or "vec" in path  # noqa: E731
    jtx = joptim.masked(joptim.adafactor(1e-2, weight_decay=1e-2), trainable)
    ttx = toptim.masked(toptim.adafactor(1e-2, weight_decay=1e-2), trainable)
    model = _Fixed(_params())
    step = tstep.make_train_step(model, ttx, lambda out, b: (out, {"loss": out}))
    names = tstep.optimizer_params(dict(model.named_parameters()), ttx)
    assert names == ["w.big", "w.vec"]
    params = dict(model.named_parameters())
    state = TrainState(step=0, params=params, opt_state=ttx.init([params[n] for n in names]),
                       generator=torch.Generator().manual_seed(0))
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    js = jtx.init(jp)
    for s in range(STEPS):
        g = _grads(s)
        state, _ = step(state, {k: torch.tensor(v) for k, v in g.items()})
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
    for k in SHAPES:
        got = state.params[f"w.{k}"].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=RTOL, atol=ATOL, err_msg=k)
        if not trainable(k):
            np.testing.assert_array_equal(got, _params()[k])
    assert len(state.opt_state[0].v) == 2


def test_adafactor_refuses_shards_and_zero_slices():
    tx = toptim.adafactor(1e-2)
    p = [torch.zeros(256, 130)]
    state = tx.init(p)
    for grads in (toptim.Shards([torch.ones(128, 130)], [0.5]),
                  toptim.Slices([torch.ones(128, 130)], [0.5], whole=[torch.ones(256, 130)])):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            tx.update(grads, state, [torch.zeros(128, 130)])


# -- lars and lamb: optax's, as the JAX package calls them ---------------------

#: f32 norms summed in another order move a trust ratio by an ulp, which
#: scales a whole tensor: 1e-6 relative to each element and to the tensor's
#: largest element (elements near 0 carry the tensor's rounding)
LAYERWISE_RTOL = 1e-6
#: conv kernels (OIHW in the port; a norm does not see the layout), a dense
#: kernel, a BatchNorm scale and a bias (1-D: masked out of LARS's decay and
#: trust ratio), and a zero-initialised kernel (a zero norm: trust ratio 1)
LAYERWISE_SHAPES = {"conv": (16, 8, 3, 3), "dense": (32, 10), "scale": (16,),
                    "bias": (10,), "zero": (8, 8)}


def _layerwise_params():
    rng = np.random.default_rng(3)
    out = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
           for k, s in LAYERWISE_SHAPES.items()}
    out["zero"][:] = 0.0
    return out


def _layerwise_grads(step):
    rng = np.random.default_rng(200 + step)
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in LAYERWISE_SHAPES.items()}
    if step == 0:
        out["bias"][:] = 0.0  # a zero update norm
    return out


@pytest.mark.parametrize("name", ["lars", "lamb"])
@pytest.mark.parametrize("schedule", [False, True])
def test_layerwise_optimizers_match_optax(name, schedule):
    """5 updates of the port's ``lars``/``lamb`` against the JAX package's
    (optax's) from the same params and gradients, to 1e-6 relative in f32,
    the momentum trace and Adam's moments included."""
    lr_j = optax.linear_schedule(0.5, 0.05, STEPS) if schedule else 0.3
    lr_t = toptim.linear_schedule(0.5, 0.05, STEPS) if schedule else 0.3
    kw = dict(weight_decay=1e-2)
    jtx, ttx = getattr(joptim, name)(lr_j, **kw), getattr(toptim, name)(lr_t, **kw)
    names = list(LAYERWISE_SHAPES)
    jp = {k: jnp.asarray(v) for k, v in _layerwise_params().items()}
    tp = [torch.tensor(_layerwise_params()[k]) for k in names]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(STEPS):
        g = _layerwise_grads(step)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([torch.tensor(g[k]) for k in names], ts, tp)
        torch._foreach_add_(tp, tu)
    for k, t in zip(names, tp):
        want = np.asarray(jp[k])
        np.testing.assert_allclose(t.numpy(), want, rtol=LAYERWISE_RTOL,
                                   atol=LAYERWISE_RTOL * np.abs(want).max(),
                                   err_msg=k)
        if name == "lars" and k in ("scale", "bias"):
            # masked out of decay and trust ratio: plain momentum SGD
            assert not np.array_equal(t.numpy(), _layerwise_params()[k]), k


def test_lars_masks_one_dim_params_from_decay_and_trust_ratio():
    """One LARS step on a 1-D param is momentum SGD at lr, with no decay and
    no trust ratio; a kernel's step is scaled by 1e-3·‖p‖/‖g + wd·p‖."""
    tx = toptim.lars(0.1, momentum=0.9, weight_decay=1e-4)
    p = [torch.full((4,), 2.0), torch.full((2, 2), 2.0)]
    g = [torch.ones(4), torch.ones(2, 2)]
    u, _ = tx.update([x.clone() for x in g], tx.init(p), p)
    torch.testing.assert_close(u[0], torch.full((4,), -0.1), rtol=0, atol=0)
    d = 1.0 + 1e-4 * 2.0
    want = -0.1 * d * 1e-3 * 4.0 / (2.0 * d)
    torch.testing.assert_close(u[1], torch.full((2, 2), want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_layerwise_optimizers_refuse_shards_and_zero_slices(name):
    tx = getattr(toptim, name)(1e-2)
    p = [torch.zeros(256, 130)]
    state = tx.init(p)
    for grads in (toptim.Shards([torch.ones(128, 130)], [0.5]),
                  toptim.Slices([torch.ones(128, 130)], [0.5],
                                whole=[torch.ones(256, 130)])):
        with pytest.raises(NotImplementedError,
                           match=f"{name} over shards.*ROADMAP Queue 1 item 3"):
            tx.update(grads, state, [torch.zeros(128, 130)])

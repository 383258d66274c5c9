"""The port's DLRM slice on the CPU against the JAX package: the models'
forwards from the same (flax-initialised) weights, the interaction's
triangle order, the CTR loss, StreamingAUC, and the Criteo sources,
byte for byte. Inputs come from numpy seeds."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import metrics as jmetrics
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.models import dlrm as jdlrm
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import metrics as tmetrics
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.models import dlrm as tdlrm
from distributeddeeplearningspark_tpu_torch.models.dlrm_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from test_torch_deadline import per_test

VOCABS = (50, 30, 20, 40)
# f32 models: the same math, sums in another order
F32_TOL = 1e-5
# bf16 MLPs: the two frameworks round the bf16 matmuls and bias adds at
# other points; held to the logits' scale
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _batch(n=8, seed=0, vocabs=VOCABS):
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.exponential(1.0, (n, 13)).astype(np.float32) - 0.3,
        "sparse": np.stack([rng.integers(0, v, n) for v in vocabs],
                           axis=1).astype(np.int32),
        "label": rng.integers(0, 2, (n,)).astype(np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_fused_flat_ids_match_jax():
    sparse = _batch()["sparse"]
    want = np.asarray(jdlrm.fused_flat_ids(VOCABS, jnp.asarray(sparse)))
    got = tdlrm.fused_flat_ids(VOCABS, torch.from_numpy(sparse))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 5, 27])
def test_triangle_order_is_the_jax_order(n):
    li, lj = torch.tril_indices(n, n, -1)
    ji, jj = jnp.tril_indices(n, k=-1)
    np.testing.assert_array_equal(li.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(lj.numpy(), np.asarray(jj))


def test_dot_interaction_matches_jax():
    rng = np.random.default_rng(1)
    bottom = rng.normal(0, 1, (3, 8)).astype(np.float32)
    emb = rng.normal(0, 1, (3, 5, 8)).astype(np.float32)
    want = np.asarray(jdlrm.dot_interaction(jnp.asarray(bottom), jnp.asarray(emb)))
    got = tdlrm.dot_interaction(torch.from_numpy(bottom), torch.from_numpy(emb))
    assert got.shape == (3, 8 + 6 * 5 // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def _models(kind, jdtype, tdtype):
    if kind == "dlrm":
        return (jdlrm.DLRM(vocab_sizes=VOCABS, embed_dim=16, bottom_mlp=(32, 16),
                           top_mlp=(32, 1), dtype=jdtype),
                tdlrm.DLRM(VOCABS, 16, (32, 16), (32, 1), dtype=tdtype, device="cpu"))
    return (jdlrm.WideAndDeep(vocab_sizes=VOCABS, embed_dim=8, deep_mlp=(16, 1),
                              dtype=jdtype),
            tdlrm.WideAndDeep(VOCABS, 8, (16, 1), dtype=tdtype, device="cpu"))


@pytest.mark.parametrize("kind", ["dlrm", "widedeep"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_from_the_same_weights(kind, dtype):
    jmodel, tmodel = _models(kind, getattr(jnp, dtype), getattr(torch, dtype))
    batch = _batch(8, seed=2)
    params = jmodel.init(jax.random.PRNGKey(3), batch, train=False)["params"]
    want = np.asarray(jmodel.apply({"params": params}, batch, train=False))
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(_t(batch))
    assert got.shape == (8,) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["dlrm", "widedeep"])
def test_overrides_skip_the_lookup(kind):
    _, model = _models(kind, jnp.float32, torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = _t(_batch(4, seed=4))
    flat = tdlrm.fused_flat_ids(VOCABS, batch["sparse"])
    with torch.no_grad():
        want = model(batch)
        overrides = {s.name: dict(model.named_parameters())[s.param_path][flat]
                     for s in tdlrm.sparse_embed_specs(model)}
        got = model(batch, overrides=overrides)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        zeroed = model(batch, overrides={"embedding": torch.zeros_like(
            overrides["embedding"])})
    assert not torch.equal(zeroed, want)


def test_sparse_embed_specs_name_the_tables():
    _, dlrm = _models("dlrm", jnp.float32, torch.float32)
    _, wd = _models("widedeep", jnp.float32, torch.float32)
    (spec,) = tdlrm.sparse_embed_specs(dlrm, lr=0.5)
    assert (spec.name, spec.param_path, spec.lr) == (
        "embedding", "embedding.embedding_table", 0.5)
    assert tdlrm.sparse_embed_specs(dlrm)[0].lr == 1e-2
    names = dict(wd.named_parameters())
    specs = tdlrm.sparse_embed_specs(wd)
    assert [s.name for s in specs] == ["embedding", "wide_table"]
    assert all(s.param_path in names for s in specs)
    sparse = _t(_batch(2))["sparse"]
    assert torch.equal(specs[1].ids_fn({"sparse": sparse}),
                       tdlrm.fused_flat_ids(VOCABS, sparse))


def test_bottom_mlp_must_end_at_embed_dim():
    with pytest.raises(ValueError, match="embed_dim"):
        tdlrm.DLRM(VOCABS, 16, (32, 8), (32, 1), device="cpu")


def test_dlrm_constructor_is_config_4():
    defaults = inspect.signature(tdlrm.dlrm).parameters
    assert defaults["vocab_sizes"].default == (100_000,) * 26
    assert defaults["device"].default == "cuda"
    model = tdlrm.dlrm(vocab_sizes=(10,) * 26, device="cpu", seed=1)
    assert model.embedding.embedding_table.shape == (260, 64)
    assert [model.bottom_mlp.dense_0.in_features,
            *(getattr(model.bottom_mlp, f"dense_{i}").out_features for i in range(3))
            ] == [13, 512, 256, 64]
    assert [getattr(model.top_mlp, f"dense_{i}").out_features
            for i in range(3)] == [512, 256, 1]
    assert model.top_mlp.dense_0.in_features == 64 + 27 * 26 // 2
    assert model.dtype == torch.bfloat16
    again = tdlrm.dlrm(vocab_sizes=(10,) * 26, device="cpu", seed=1)
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n


def test_init_follows_flax():
    model = tdlrm.dlrm(vocab_sizes=(1000,) * 26, device="cpu", seed=0)
    table = model.embedding.embedding_table.detach()
    assert abs(float(table.std()) - 1 / 8) < 2e-3 and table.dtype == torch.float32
    for name, p in model.state_dict().items():
        if name.endswith(".weight"):
            std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std, name
        elif name.endswith(".bias"):
            assert not p.any(), name


@pytest.mark.parametrize("masked", [False, True])
def test_binary_xent_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (16,)).astype(np.float32)
    batch = {"label": rng.integers(0, 2, (16,)).astype(np.int32)}
    if masked:
        batch["eval_mask"] = (np.arange(16) < 11).astype(np.float32)
    jloss, jm = jlosses.binary_xent(jnp.asarray(logits),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm = tlosses.binary_xent(torch.from_numpy(logits), _t(batch))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# -- StreamingAUC -------------------------------------------------------------


@pytest.mark.parametrize("bins", [16, 4096])
def test_streaming_auc_matches_jax(bins):
    rng = np.random.default_rng(bins)
    labels = (rng.random(5000) < 0.25).astype(np.int32)
    scores = np.clip(0.35 * labels + rng.normal(0.3, 0.2, 5000), -0.1, 1.1)
    j, t = jmetrics.StreamingAUC(bins), tmetrics.StreamingAUC(bins)
    for lo in range(0, 5000, 777):
        j.update(scores[lo:lo + 777], labels[lo:lo + 777])
        t.update(scores[lo:lo + 777], labels[lo:lo + 777])
    assert t.compute() == j.compute() and 0.5 < t.compute() < 1.0


def test_streaming_auc_edge_cases():
    y = np.array([0, 0, 1, 1])
    for scores, want in (([0.1, 0.2, 0.8, 0.9], 1.0), ([0.9, 0.8, 0.2, 0.1], 0.0),
                         ([0.5] * 4, 0.5)):
        auc = tmetrics.StreamingAUC()
        auc.update(scores, y)
        assert auc.compute() == want
    single = tmetrics.StreamingAUC()
    single.update([0.5, 0.6], [1, 1])
    assert np.isnan(single.compute())
    with pytest.raises(ValueError, match="scores"):
        single.update([0.5, 0.6], [1])


def test_auc_from_predictions_matches_jax():
    rng = np.random.default_rng(9)
    pairs = [(rng.random(7), rng.integers(0, 2, 7)) for _ in range(40)]
    examples = [({"label": np.int32(i % 2)}, np.float32(0.2 + 0.5 * (i % 2)))
                for i in range(10)]
    for stream, kw in ((pairs, dict(chunk=50)), (pairs, dict(max_examples=9)),
                       (examples, {})):
        assert tmetrics.auc_from_predictions(iter(stream), **kw) == \
            jmetrics.auc_from_predictions(iter(stream), **kw)


# -- Criteo sources, byte for byte ---------------------------------------------


def _assert_same_examples(tds, jds):
    assert tds.num_partitions == jds.num_partitions
    for i in range(jds.num_partitions):
        want, got = list(jds.iter_partition(i)), list(tds.iter_partition(i))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                gk, wk = np.asarray(g[k]), np.asarray(w[k])
                assert gk.dtype == wk.dtype and gk.tobytes() == wk.tobytes(), k


@pytest.mark.parametrize("seed,vocabs,parts", [(0, (100,) * 26, 4),
                                                (777, VOCABS, 3)])
def test_synthetic_criteo_is_byte_identical(seed, vocabs, parts):
    kw = dict(vocab_sizes=vocabs, num_partitions=parts, seed=seed)
    _assert_same_examples(tsources.synthetic_criteo(60, **kw),
                          jsources.synthetic_criteo(60, **kw))


def _write_tsv(path, rows, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            dense = ["" if rng.random() < 0.2 else str(int(rng.integers(0, 10**6)))
                     for _ in range(13)]
            cats = ["" if rng.random() < 0.1 else f"{int(rng.integers(0, 2**32)):08x}"
                    for _ in range(26)]
            cols = [str(int(rng.integers(0, 2)))] + dense + cats
            if i % 97 == 5:
                cols = cols[:20]  # a short row: the missing columns are empty
            f.write("\t".join(cols) + "\n")


@pytest.mark.parametrize("rows,parts", [(40, 4), (6000, 3)])
def test_criteo_tsv_is_byte_identical(tmp_path, rows, parts):
    """A small file (one partition) and one over 1 MiB (byte-split)."""
    path = tmp_path / "day_0.tsv"
    _write_tsv(path, rows)
    kw = dict(num_partitions=parts, vocab_sizes=(1000,) * 26)
    _assert_same_examples(tsources.criteo_tsv(str(path), **kw),
                          jsources.criteo_tsv(str(path), **kw))
    assert sum(1 for _ in tsources.criteo_tsv(str(tmp_path), **kw).iter_partition(0)) > 0


def test_criteo_tsv_wants_26_vocab_sizes(tmp_path):
    with pytest.raises(ValueError, match="26 vocab sizes"):
        tsources.criteo_tsv(str(tmp_path), vocab_sizes=(10,) * 3)

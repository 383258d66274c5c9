"""The port's row scatter-add (K5's wrapper) against the JAX package's
Pallas kernel and its drop boundary, run in interpret mode on the CPU as
its own tests run them. One f32 add per unique row is exact, so the
comparisons are bitwise. On the CPU the wrapper takes its plain PyTorch
version; the CUDA kernel is held to that version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.ops import scatter_rows as jsr
from distributeddeeplearningspark_tpu_torch.ops import scatter_rows as tsr
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _case(v, d, k, seed=0):
    """The JAX test's inputs: a normal table, sorted unique in-range ids,
    normal updates."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    idx = np.sort(rng.choice(v, k, replace=False)).astype(np.int32)
    upd = rng.normal(0, 1, (k, d)).astype(np.float32)
    return table, idx, upd


def _port(fn, table, idx, upd):
    t = torch.from_numpy(table.copy())
    out = fn(t, torch.from_numpy(idx), torch.from_numpy(upd))
    assert out is t
    return t.numpy()


@pytest.mark.parametrize("v,d,k", [(64, 16, 9), (128, 64, 32), (32, 8, 32)])
@pytest.mark.parametrize("jax_name", ["scatter_add_rows", "scatter_add_rows_dropping"])
def test_matches_the_pallas_kernel_bitwise(v, d, k, jax_name):
    """The one port wrapper against both JAX contracts: the raw kernel and
    the drop boundary."""
    table, idx, upd = _case(v, d, k, seed=v)
    want = np.asarray(getattr(jsr, jax_name)(jnp.asarray(table), jnp.asarray(idx),
                                             jnp.asarray(upd)))
    got = _port(tsr.scatter_add_rows, table, idx, upd)
    np.testing.assert_array_equal(got, want)
    untouched = np.setdiff1d(np.arange(v), idx)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_dropping_discards_the_sentinels_as_the_pallas_boundary_does():
    """The embed caller's padding: sentinels v+0, v+1, ... (unique, sorted,
    trailing) after the real ids."""
    v, d, k = 32, 8, 12
    table, _, upd = _case(v, d, k, seed=3)
    real = np.sort(np.random.default_rng(4).choice(v, 7, replace=False))
    idx = np.concatenate([real, v + np.arange(k - 7)]).astype(np.int32)
    want = np.asarray(jsr.scatter_add_rows_dropping(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(upd)))
    got = _port(tsr.scatter_add_rows, table, idx, upd)
    np.testing.assert_array_equal(got, want)
    ref = table.copy()
    ref[real] += upd[:7]
    np.testing.assert_array_equal(got, ref)


def test_dropping_also_drops_negative_ids():
    v, d = 16, 4
    table, _, _ = _case(v, d, 1, seed=5)
    idx = np.array([-3, 2, v + 7, -1, 9, 2 * v], np.int64)
    upd = np.random.default_rng(6).normal(0, 1, (6, d)).astype(np.float32)
    got = _port(tsr.scatter_add_rows, table, idx, upd)
    ref = table.copy()
    ref[2] += upd[1]
    ref[9] += upd[4]
    np.testing.assert_array_equal(got, ref)


def test_all_sentinels_and_no_ids_leave_the_table_alone():
    v, d = 16, 8
    table, _, _ = _case(v, d, 1, seed=7)
    for idx in (v + np.arange(5, dtype=np.int32), np.zeros(0, np.int32)):
        upd = np.ones((idx.size, d), np.float32)
        np.testing.assert_array_equal(
            _port(tsr.scatter_add_rows, table, idx, upd), table)


def test_unsorted_int64_ids():
    v, d, k = 1000, 13, 700
    rng = np.random.default_rng(8)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    idx = rng.permutation(v)[:k].astype(np.int64)
    upd = rng.normal(0, 1, (k, d)).astype(np.float32)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(idx)].add(
        jnp.asarray(upd), unique_indices=True))
    np.testing.assert_array_equal(_port(tsr.scatter_add_rows, table, idx, upd), want)


def test_in_place_with_no_copy_of_the_table():
    """With sentinels the table keeps its storage: the JAX package's
    [V+1, D] scratch-row copy is not carried over."""
    table, idx, upd = _case(64, 16, 9)
    idx = np.concatenate([idx, [64, 65]]).astype(np.int32)
    upd = np.concatenate([upd, np.ones((2, 16), np.float32)])
    t = torch.from_numpy(table.copy())
    ptr = t.data_ptr()
    out = tsr.scatter_add_rows(t, torch.from_numpy(idx), torch.from_numpy(upd))
    assert out is t and t.data_ptr() == ptr


@pytest.mark.parametrize("bad", [np.s_[:, :4], np.s_[:3], np.s_[:, 0]])
def test_bad_update_shape_rejected(bad):
    """Too narrow, too few rows, or not [K, D]."""
    table, idx, upd = _case(16, 8, 4)
    with pytest.raises(ValueError, match="updates"):
        tsr.scatter_add_rows(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(np.ascontiguousarray(upd[bad])))


def test_the_drop_boundary_name_is_the_same_function():
    assert tsr.scatter_add_rows_dropping is tsr.scatter_add_rows


def test_cpu_calls_launch_no_kernel():
    """The counter counts kernel launches only; CPU tensors take the plain
    version."""
    before = tsr.scatter_add_rows.launches
    table, idx, upd = _case(32, 8, 5)
    _port(tsr.scatter_add_rows, table, idx, upd)
    assert tsr.scatter_add_rows.launches == before


def test_a_device_other_than_cuda_or_cpu_is_refused():
    t = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsr.scatter_add_rows(t, torch.zeros(2, dtype=torch.int32, device="meta"),
                             torch.empty(2, 4, device="meta"))

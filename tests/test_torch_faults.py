"""The port's fault injection (``faults.py``) against the JAX package's, on
the same env: the spec parser and the attempt/rank/host gating case for
case with ``tests/test_chaos.py``'s (one parametrised test), the NaN batch
on the same arrays, the checkpoint tear on the port's own step directory,
and the retiring of a preemption notice."""

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import faults as jfaults
from distributeddeeplearningspark_tpu_torch import faults as tfaults
from distributeddeeplearningspark_tpu_torch.checkpoint import (
    MANIFEST_NAME,
    Checkpointer,
    verify_step_dir,
)
from test_torch_deadline import per_test

_GATING_ENV = ("DLS_FAULT", "DLS_RESTART", "DLS_FAULT_ALL_ATTEMPTS",
               "DLS_PROCESS_ID", "DLS_HOST_ID", "DLS_FAULT_HOST",
               "DLS_FAULT_ONCE", "DLS_FAULT_RANK")


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# (env, accessor, expected): expected is (kind, step), None, or
# (exception type, match). The sequences of test_chaos.py's
# test_fault_parse, test_fault_gating, test_die_host_fault_gating and
# test_sigterm_fault_scoping, each state of the env one case; the rank
# gate reads DLS_PROCESS_ID in the port and jax.process_index() (0 in this
# process) in the JAX package, so DLS_PROCESS_ID=0 keeps the two alike.
CASES = [
    ({}, "parse:truncate_ckpt@20", ("truncate_ckpt", 20)),
    *[({}, f"parse:{bad}", (ValueError, "DLS_FAULT"))
      for bad in ("nan", "nan@", "nan@x", "frobnicate@3", "crash@0",
                  "die_host@0", "die_host@", "die_host@x",
                  "sigterm@0", "sigterm@", "sigterm@x")],
    ({"DLS_FAULT": "nan@3"}, "get", ("nan", 3)),
    ({"DLS_FAULT": "nan@3", "DLS_RESTART": "1"}, "get", None),
    ({"DLS_FAULT": "nan@3", "DLS_RESTART": "1", "DLS_FAULT_ALL_ATTEMPTS": "1"},
     "get", ("nan", 3)),
    ({}, "get", None),
    ({"DLS_FAULT": "die_host@7", "DLS_PROCESS_ID": "1"}, "get", ("die_host", 7)),
    ({"DLS_FAULT": "die_host@7", "DLS_PROCESS_ID": "1", "DLS_RESTART": "2"},
     "get", ("die_host", 7)),
    ({"DLS_FAULT": "die_host@7", "DLS_PROCESS_ID": "1", "DLS_RESTART": "2",
      "DLS_FAULT_ONCE": "1"}, "get", None),
    ({"DLS_FAULT": "die_host@7", "DLS_PROCESS_ID": "0", "DLS_HOST_ID": "1",
      "DLS_RESTART": "2"}, "get", ("die_host", 7)),
    ({"DLS_FAULT": "die_host@7", "DLS_PROCESS_ID": "0", "DLS_HOST_ID": "0",
      "DLS_RESTART": "2"}, "get", None),
    ({"DLS_FAULT": "die_host@7", "DLS_HOST_ID": "1", "DLS_FAULT_HOST": "frobnicate"},
     "get", (ValueError, "DLS_FAULT_HOST")),
    ({"DLS_FAULT": "die_host@7", "DLS_HOST_ID": "1", "DLS_FAULT_HOST": "-1"},
     "get", (ValueError, ">= 0")),
    ({"DLS_FAULT": "sigterm@9"}, "get", None),
    ({"DLS_FAULT": "sigterm@9"}, "sigterm_fault", ("sigterm", 9)),
    ({"DLS_FAULT": "sigterm@9", "DLS_RESTART": "1"}, "sigterm_fault", None),
    ({"DLS_FAULT": "sigterm@9", "DLS_RESTART": "1", "DLS_FAULT_ALL_ATTEMPTS": "1"},
     "sigterm_fault", ("sigterm", 9)),
    ({"DLS_FAULT": "crash@3"}, "sigterm_fault", None),
    ({"DLS_FAULT": "sigterm@9", "DLS_FAULT_HOST": "frobnicate"}, "sigterm_fault",
     (ValueError, "DLS_FAULT_HOST")),
    ({"DLS_FAULT": "die_shuffle_worker@4"}, "get", None),
    ({"DLS_FAULT": "crash@5", "DLS_FAULT_RANK": "0", "DLS_PROCESS_ID": "0"},
     "get", ("crash", 5)),
    ({"DLS_FAULT": "crash@5", "DLS_FAULT_RANK": "1", "DLS_PROCESS_ID": "0"},
     "get", None),
]


def _call(mod, accessor: str):
    if accessor.startswith("parse:"):
        return mod.parse(accessor.split(":", 1)[1])
    return getattr(mod, accessor)()


@pytest.mark.parametrize("env,accessor,expected", CASES,
                         ids=[f"{i}-{c[1]}" for i, c in enumerate(CASES)])
def test_parse_and_gating_match_jax(monkeypatch, env, accessor, expected):
    for name in _GATING_ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(expected, tuple) and isinstance(expected[0], type):
        exc, match = expected
        for mod in (jfaults, tfaults):
            with pytest.raises(exc, match=match):
                _call(mod, accessor)
        return
    got, want = _call(tfaults, accessor), _call(jfaults, accessor)
    as_pair = lambda f: None if f is None else (f.kind, f.step)  # noqa: E731
    assert as_pair(got) == as_pair(want) == expected


def test_kinds_and_this_host_match_jax(monkeypatch):
    assert tfaults.KINDS == jfaults.KINDS
    for env in ({}, {"DLS_PROCESS_ID": "3"}, {"DLS_PROCESS_ID": "3", "DLS_HOST_ID": "5"}):
        monkeypatch.delenv("DLS_PROCESS_ID", raising=False)
        monkeypatch.delenv("DLS_HOST_ID", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tfaults.this_host() == jfaults.this_host()


def test_nan_batch_poisons_the_floating_leaves_as_jax_does():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(4, 3)).astype(np.float32),
             "half": rng.normal(size=(4,)).astype(np.float16),
             "label": np.arange(4, dtype=np.int32),
             "ids": np.arange(4, dtype=np.int64)}
    want = {k: np.asarray(v) for k, v in jfaults.nan_batch(batch).items()}
    got = tfaults.nan_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    got_np = tfaults.nan_batch(batch)
    for k in batch:
        assert got[k].dtype == torch.from_numpy(batch[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(got_np[k], want[k], err_msg=k)
    assert np.isnan(want["image"]).all() and np.isnan(want["half"]).all()
    assert (want["label"] == batch["label"]).all()


def test_truncate_tears_the_newest_port_step_and_spares_the_manifest(tmp_path):
    from distributeddeeplearningspark_tpu_torch.train.state import TrainState

    ckpt = Checkpointer(tmp_path, async_save=False)
    w = torch.nn.Parameter(torch.arange(1000, dtype=torch.float32))
    state = TrainState(step=0, params={"w": w}, opt_state=(), generator=torch.Generator())
    for step in (2, 4):
        ckpt.save(step, state, data_state={"examples_seen": step})
    manifest = (tmp_path / "4" / MANIFEST_NAME).read_bytes()
    victim = tfaults.truncate_latest_checkpoint(str(tmp_path))
    assert victim == str(tmp_path / "4" / "state.pt")
    assert (tmp_path / "4" / MANIFEST_NAME).read_bytes() == manifest
    assert not verify_step_dir(str(tmp_path / "4"))[0]
    assert verify_step_dir(str(tmp_path / "2"))[0]
    assert tfaults.truncate_latest_checkpoint(str(tmp_path / "none")) is None


def test_preempt_notice_is_consumed_as_jax_does(tmp_path, monkeypatch):
    path = tmp_path / "notice.json"
    jfaults.deliver_preempt_notice(str(path), host=2, step=40)
    monkeypatch.setenv(tfaults.PREEMPT_NOTICE_ENV, str(path))
    assert tfaults.preempt_notice_path() == str(path) == jfaults.preempt_notice_path()
    tfaults.consume_preempt_notice(str(path), ordinal=3)
    assert not path.exists() and (tmp_path / "notice.json.consumed-3").exists()
    assert jfaults.read_preempt_notice(str(path)) is None
    tfaults.consume_preempt_notice(str(path), ordinal=4)  # nothing left: a no-op
    tfaults.consume_preempt_notice(None, ordinal=5)

"""Checkpoint hot reload in the port (the cases of JAX's
``tests/test_serve.py``): ``Checkpointer.restore_params`` (params alone,
no state template, verified, walking back past a corrupt step without
quarantining it), a corrupt candidate rejected then a later step
reloaded, a corrupt latest step falling back to an older verified one, a
load that keeps failing rejected after its retries, and the watcher
swapping a live engine with zero dropped requests."""

import os
import time

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import faults, telemetry
from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer, RestoreError
from distributeddeeplearningspark_tpu_torch.serve import HotReloader, InferenceEngine
from distributeddeeplearningspark_tpu_torch.serve.reload import checkpoint_params_loader
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _unbind_telemetry():
    yield
    telemetry.reset()


class _EngineDouble:
    def __init__(self):
        self.swaps = []

    def swap_params(self, params, *, version=None):
        self.swaps.append((params, version))


def _state(w: float, step: int = 0) -> TrainState:
    """A one-param state with optimizer tensors (which restore_params must
    not need)."""
    return TrainState(step=step, params={"w": torch.nn.Parameter(torch.tensor(w))},
                      opt_state={"mu": torch.full((3,), w)},
                      generator=torch.Generator().manual_seed(0))


def _save(directory, *steps_and_values):
    with Checkpointer(directory, async_save=False) as ck:
        for step, w in steps_and_values:
            ck.save(step, _state(w, step))
        ck.wait()


def test_restore_params_roundtrip_and_verification(tmp_path):
    ck_dir = tmp_path / "ck"
    _save(ck_dir, (4, 7.0))
    with Checkpointer(ck_dir, async_save=False) as ck:
        params, step = ck.restore_params()
        assert step == 4 and set(params) == {"w"}
        assert float(params["w"]) == 7.0 and params["w"].device.type == "cpu"
        assert faults.truncate_latest_checkpoint(str(ck_dir))
        with pytest.raises(RestoreError, match="failed integrity"):
            ck.restore_params(step=4)
        with pytest.raises(RestoreError, match="no intact checkpoint"):
            ck.restore_params()


def test_restore_params_walks_back_without_quarantining(tmp_path):
    ck_dir = tmp_path / "ck"
    _save(ck_dir, (1, 1.0), (2, 2.0))
    assert faults.truncate_latest_checkpoint(str(ck_dir))
    with Checkpointer(ck_dir, async_save=False) as ck:
        params, step = ck.restore_params()
    assert step == 1 and float(params["w"]) == 1.0
    assert sorted(os.listdir(ck_dir)) == ["1", "2"]      # step 2 left in place


def test_hot_reload_corrupt_candidate_rejected_then_recovers(tmp_path):
    """A torn newest step is rejected by its manifest: the old params keep
    serving, the rejection is remembered, a later intact step reloads."""
    wd = tmp_path / "ckpt"
    telemetry.configure(wd)
    _save(wd, (1, 1.0), (2, 2.0))
    assert faults.truncate_latest_checkpoint(str(wd))
    eng = _EngineDouble()
    rel = HotReloader(eng, wd, current_step=1)
    try:
        act = rel.poll()
        assert act == {"step": 2, "action": "rejected", "reason": act["reason"]}
        assert "checksum" in act["reason"] or "size" in act["reason"]
        assert eng.swaps == [] and rel.current_step == 1
        assert rel.poll() is None                        # remembered
        _save(wd, (3, 3.0))
        act = rel.poll()
        assert act["action"] == "reloaded" and act["step"] == 3
        (params, version), = eng.swaps
        assert version == 3 and float(params["w"]) == 3.0
    finally:
        rel.stop()
    telemetry.reset()
    kinds = [(e.get("event"), e.get("step")) for e in telemetry.read_events(wd)
             if e.get("kind") == "recovery"]
    assert ("reload-rejected", 2) in kinds and ("reload", 3) in kinds


def test_hot_reload_corrupt_latest_falls_back_to_older_verified(tmp_path):
    wd = tmp_path / "ckpt"
    _save(wd, (5, 5.0), (6, 6.0))
    assert faults.truncate_latest_checkpoint(str(wd))
    eng = _EngineDouble()
    rel = HotReloader(eng, wd)
    try:
        act = rel.poll()
        assert act["action"] == "reloaded" and act["step"] == 5
        assert act["fell_back_past"] == 6
        assert [v for _, v in eng.swaps] == [5]
    finally:
        rel.stop()


def test_a_load_that_keeps_failing_is_retried_then_rejected(tmp_path):
    wd = tmp_path / "ckpt"
    _save(wd, (1, 1.0))
    eng = _EngineDouble()

    def broken(step):
        raise OSError("read raced the write")

    rel = HotReloader(eng, wd, load_params=broken)
    acts = [rel.poll() for _ in range(rel.max_load_retries)]
    assert [a["action"] for a in acts] == ["retry"] * (rel.max_load_retries - 1) + [
        "rejected"]
    assert rel.poll() is None and eng.swaps == []


def test_watcher_swaps_a_live_engine(tmp_path):
    """The background watcher and a real engine: a new verified step
    changes the served results mid-traffic, none dropped."""
    wd = tmp_path / "ckpt"
    _save(wd, (1, 1.0))

    def fwd(params, batch):
        return {"y": batch["x"] * params["w"]}

    eng = InferenceEngine(fwd, {"w": torch.tensor(0.0)}, device="cpu", max_batch=4,
                          max_wait_ms=1.0, max_queue=4096)
    rel = HotReloader(eng, wd, interval_s=0.02, load_params=checkpoint_params_loader(wd))
    futs = []
    with eng, rel:
        deadline = time.monotonic() + 10
        while eng.params_version != 1 and time.monotonic() < deadline:
            futs.append(eng.submit({"x": np.float32(1.0)}))
            time.sleep(0.002)
        assert eng.params_version == 1, "watcher never reloaded step 1"
        futs.append(eng.submit({"x": np.float32(1.0)}))
        res = [float(f.result(30)["y"]) for f in futs]
    assert set(res) <= {0.0, 1.0} and res[-1] == 1.0
    assert len(res) == len(futs)

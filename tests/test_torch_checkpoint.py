"""The port's Checkpointer and resume on the CPU, mirroring
``tests/test_checkpoint.py``: the integrity manifest (which the JAX
package's ``verify_step_dir`` also accepts), verify, quarantine, the
walk-back past a corrupt step, ``RestoreError`` when every step is
corrupt, the ``data_state`` rider, retention, the async write, the
telemetry phases, and ``Trainer`` resume: 3 steps + a restore + 3 more give
the bits of 6 straight steps."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import checkpoint as jcheckpoint
from distributeddeeplearningspark_tpu_torch import Checkpointer, LeNet5, Session, Trainer
from distributeddeeplearningspark_tpu_torch import checkpoint as tcheckpoint
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.models.resnet import ResNet, BasicBlock
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture
def spark():
    s = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield s
    s.stop()
    ttele.reset()


def _examples(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32),
             "label": np.int32(i % 10)} for i in range(n)]


def _trainer(spark, ckpt=None, tx=None, seed=11, model_seed=0):
    return Trainer(spark, LeNet5(device="cpu", seed=model_seed), losses.softmax_xent,
                   tx or optim.sgd(0.1, momentum=0.9), checkpointer=ckpt, seed=seed)


def _trained_state(spark, steps=2):
    t = _trainer(spark, tx=optim.adamw(1e-3))
    ds = PartitionedDataset.parallelize(_examples(64), 2).repeat()
    state, _ = t.fit(ds, batch_size=8, steps=steps, log_every=100)
    return t, state


def _assert_states_equal(a: dict, b: dict):
    assert a["step"] == b["step"]
    for part in ("params", "mutable"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert len(a["opt_state"]) == len(b["opt_state"])
    for x, y in zip(a["opt_state"], b["opt_state"]):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(a["generator"], b["generator"])


def _copy(sd: dict) -> dict:
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else [x.clone() if isinstance(x, torch.Tensor) else x for x in v]
                if isinstance(v, list) else v.clone() if isinstance(v, torch.Tensor)
                else v) for k, v in sd.items()}


def test_roundtrip_state_and_data_state(tmp_path, spark):
    t, state = _trained_state(spark)
    want = _copy(state.state_dict())
    with Checkpointer(tmp_path / "ck") as ck:
        assert ck.latest_step() is None
        assert ck.save(2, state, data_state={"examples_seen": 16, "batch_size": 8,
                                             "epoch": 2, "source": "synthetic"})
        ck.wait()
        assert ck.latest_step() == 2 and ck.all_steps() == [2]
        for p in state.params.values():  # the live state moves on
            p.data.add_(1.0)
        state.generator.manual_seed(123)
        restored, data_state = ck.restore(state)
    assert restored is state
    _assert_states_equal(state.state_dict(), want)
    assert data_state == {"examples_seen": 16, "batch_size": 8, "epoch": 2,
                          "source": "synthetic"}


def test_async_save_writes_the_state_as_it_was(tmp_path, spark):
    """The copy to the host happens in save(): updates made while the
    background write runs do not reach the checkpoint."""
    _, state = _trained_state(spark)
    want = _copy(state.state_dict())
    ck = Checkpointer(tmp_path / "ck", async_save=True)
    ck.save(2, state)
    with torch.no_grad():
        for p in state.params.values():
            p.mul_(0.0)
    ck.wait()
    saved = torch.load(tmp_path / "ck" / "2" / tcheckpoint.STATE_FILE,
                       weights_only=True)
    _assert_states_equal(saved, want)
    ck.close()


def test_state_dict_roundtrip_keeps_buffers_and_adam_counts(tmp_path, spark):
    """A model with buffers (BatchNorm statistics) under AdamW, whose state
    holds host counts beside its moments."""
    model = ResNet(stage_sizes=(1,), block_cls=BasicBlock, num_classes=4, width=8,
                   dtype=torch.float32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    t = Trainer(spark, model, losses.softmax_xent, optim.adamw(1e-3))
    rng = np.random.default_rng(0)
    rows = [{"image": rng.normal(size=(16, 16, 3)).astype(np.float32),
             "label": np.int32(i % 4)} for i in range(16)]
    state, _ = t.fit(PartitionedDataset.parallelize(rows, 1).repeat(),
                     batch_size=8, steps=2, log_every=100)
    want = _copy(state.state_dict())
    assert want["mutable"] and 2 in want["opt_state"]
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(2, state)
        for v in state.mutable.values():
            v.fill_(7.0)
        state.opt_state = t.tx.init(list(state.params.values()))
        ck.restore(state)
    _assert_states_equal(state.state_dict(), want)


def test_manifest_written_and_verified_by_both_packages(tmp_path, spark):
    _, state = _trained_state(spark)
    with Checkpointer(tmp_path / "ck") as ck:
        ck.save(1, state, data_state={"examples_seen": 8})
        ck.save(2, state)
        ck.wait()
        for step in (1, 2):
            step_dir = str(tmp_path / "ck" / str(step))
            manifest = tcheckpoint.read_manifest(step_dir)
            assert manifest["format"] == 1 and manifest["step"] == step
            assert ck.verify(step)
            assert jcheckpoint.verify_step_dir(step_dir) == (True, "manifest verified")
        assert set(tcheckpoint.read_manifest(str(tmp_path / "ck" / "1"))["files"]) \
            == {tcheckpoint.STATE_FILE, tcheckpoint.DATA_FILE}
        assert ck.latest_verified_step() == 2
    # nothing but committed steps: the tmp dir went with the rename
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2"]


def _flip_byte(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("damage", ["flip", "truncate", "extra", "missing"])
def test_restore_walks_back_past_a_corrupt_step(tmp_path, spark, monkeypatch, damage):
    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path / "wd"))
    ttele.configure(str(tmp_path / "wd"))
    _, state = _trained_state(spark)
    want = _copy(state.state_dict())
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(1, state, data_state={"examples_seen": 8})
        for p in state.params.values():
            p.data.add_(1.0)
        ck.save(2, state, data_state={"examples_seen": 16})
        bad = tmp_path / "ck" / "2"
        if damage == "flip":
            _flip_byte(bad / tcheckpoint.STATE_FILE)
        elif damage == "truncate":
            (bad / tcheckpoint.STATE_FILE).write_bytes(
                (bad / tcheckpoint.STATE_FILE).read_bytes()[:100])
        elif damage == "extra":
            (bad / "stray.bin").write_bytes(b"x")
        else:
            (bad / tcheckpoint.DATA_FILE).unlink()
        assert not ck.verify(2)
        assert ck.latest_verified_step() == 1
        _, data_state = ck.restore(state)
        assert data_state == {"examples_seen": 8}
        assert ck.latest_step() == 1
    _assert_states_equal(state.state_dict(), want)
    assert os.path.isdir(tmp_path / "ck" / "2.corrupt-0")
    events = [json.loads(line) for line in
              (tmp_path / "wd" / "telemetry" / "events-p0.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if e["kind"] == "recovery"
            and e["event"] == "quarantine"] == [2]
    verified = [(e["step"], e["edge"]) for e in events if e["kind"] == "phase"
                and e["name"] == "checkpoint-verify"]
    assert (2, "begin") in verified and (1, "end") in verified


def test_restore_raises_when_every_step_is_corrupt(tmp_path, spark):
    _, state = _trained_state(spark)
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(1, state)
        ck.save(2, state)
        for s in (1, 2):
            _flip_byte(tmp_path / "ck" / str(s) / tcheckpoint.STATE_FILE)
        with pytest.raises(tcheckpoint.RestoreError, match="no intact checkpoint"):
            ck.restore(state)
        assert ck.all_steps() == []
    assert sorted(os.listdir(tmp_path / "ck")) == ["1.corrupt-0", "2.corrupt-0"]


def test_explicit_corrupt_step_is_not_walked_back_from(tmp_path, spark):
    _, state = _trained_state(spark)
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(1, state)
        ck.save(2, state)
        _flip_byte(tmp_path / "ck" / "2" / tcheckpoint.STATE_FILE)
        with pytest.raises(tcheckpoint.RestoreError, match="requested checkpoint step 2"):
            ck.restore(state, step=2)
        ck.restore(state, step=1)
        assert ck.all_steps() == [1, 2]  # nothing quarantined


def test_manifestless_step_restores_structurally(tmp_path, spark):
    _, state = _trained_state(spark)
    want = _copy(state.state_dict())
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(3, state)
        os.remove(tmp_path / "ck" / "3" / tcheckpoint.MANIFEST_NAME)
        assert tcheckpoint.verify_step_dir(str(tmp_path / "ck" / "3")) == (
            True, "no manifest; structurally committed")
        os.makedirs(tmp_path / "ck" / "4")  # a step dir with nothing in it
        assert not ck.verify(4)
        ck.restore(state)
        assert ck.all_steps() == [3]
    _assert_states_equal(state.state_dict(), want)


def test_retention_and_quarantine_helpers(tmp_path, spark):
    _, state = _trained_state(spark)
    with Checkpointer(tmp_path / "ck", max_to_keep=2, async_save=False) as ck:
        for s in (1, 2, 3, 4):
            ck.save(s, state)
        assert ck.all_steps() == [3, 4]
        assert tcheckpoint.latest_step_in(str(tmp_path / "ck")) == 4
        assert tcheckpoint.quarantine_step_dir(str(tmp_path / "ck"), 4).endswith(
            "4.corrupt-0")
        assert tcheckpoint.quarantine_step_dir(str(tmp_path / "ck"), 4) is None
        assert ck.all_steps() == [3]
    assert tcheckpoint.latest_step_in(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="max_to_keep"):
        Checkpointer(tmp_path / "x", max_to_keep=0)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Checkpointer(tmp_path / "empty").restore(state)


def test_checkpoint_phases_reach_telemetry(tmp_path, spark, monkeypatch):
    """fit() saves every N steps and at the end; save, wait and restore
    write their phase spans (end records with ``dur_s``) into the run's
    stream, the schema the JAX package's goodput reads."""
    from distributeddeeplearningspark_tpu import telemetry as jtele

    monkeypatch.setenv(ttele.WORKDIR_ENV, str(tmp_path / "wd"))
    ck = Checkpointer(tmp_path / "ck")
    t = _trainer(spark, ck)
    ds = PartitionedDataset.parallelize(_examples(64), 2).repeat()
    t.fit(ds, batch_size=8, steps=5, checkpoint_every=2, log_every=100)
    assert ck.all_steps() == [2, 4, 5]
    t2 = _trainer(spark, ck)
    state, data_state = t2.restore()
    assert state.step == 5 and data_state == {"examples_seen": 40, "batch_size": 8}
    ttele.reset()
    events = jtele.read_events(str(tmp_path / "wd"))
    ends = {}
    for e in events:
        if e["kind"] == "phase" and e["edge"] == "end" and e["name"] != "run":
            ends.setdefault(e["name"], []).append(e)
    assert [e["step"] for e in ends["checkpoint"]] == [2, 4, 5]
    assert len(ends["restore"]) == 1 and ends["restore"][0]["step"] == 5
    assert ends["checkpoint-wait"] and all(e["dur_s"] >= 0 for v in ends.values()
                                           for e in v)
    assert jtele.goodput(events)["checkpoint_s"] > 0


def _resume_run(spark, tmp_path, batch_size=16):
    examples = _examples(96)
    ds = lambda: PartitionedDataset.parallelize(examples, 2)  # noqa: E731
    t0 = _trainer(spark)
    state6, _ = t0.fit(ds(), batch_size=batch_size, steps=6, log_every=100)
    straight = _copy(state6.state_dict())
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        t1 = _trainer(spark, ck)
        t1.fit(ds(), batch_size=batch_size, steps=3, checkpoint_every=3, log_every=100)
        # a fresh process's view: a new model (other init), restore, go on
        t2 = _trainer(spark, ck, model_seed=5)
        state, data_state = t2.restore()
        assert state.step == 3
        state_r, _ = t2.fit(ds(), batch_size=batch_size, steps=6, log_every=100,
                            data_state=data_state)
    return straight, state_r


def test_trainer_resume_matches_uninterrupted_run(tmp_path, spark):
    """3 steps + checkpoint + restore + 3 more == 6 straight steps, bit for
    bit: params, momentum and the generator."""
    straight, resumed = _resume_run(spark, tmp_path)
    assert resumed.step == 6
    _assert_states_equal(resumed.state_dict(), straight)


def test_resume_batch_size_mismatch_rejected(spark):
    t = _trainer(spark)
    ds = PartitionedDataset.parallelize(_examples(64), 2)
    with pytest.raises(ValueError, match="batch_size mismatch"):
        t.fit(ds.repeat(), batch_size=32, steps=4, log_every=100,
              data_state={"examples_seen": 64, "batch_size": 16})


def test_resume_exhausted_feed_raises(spark):
    t = _trainer(spark)
    ds = PartitionedDataset.parallelize(_examples(32), 2)
    with pytest.raises(RuntimeError, match="fast-forward"):
        t.fit(ds, batch_size=16, steps=100, log_every=100,
              data_state={"examples_seen": 64, "batch_size": 16})


def test_fast_forward_resume_consumes_the_same_batches(spark):
    examples = _examples(96)
    t = _trainer(spark)
    ds = PartitionedDataset.parallelize(examples, 2).repeat()
    full = list(itertools.islice(t._feed(ds, 16), 6))
    skipped = list(itertools.islice(t._feed(ds, 16, skip_batches=3), 3))
    for got, want in zip(skipped, full[3:]):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k])


def test_restore_without_checkpointer_raises(spark):
    with pytest.raises(RuntimeError, match="no checkpointer"):
        _trainer(spark).restore()

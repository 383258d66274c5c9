"""The graceful preemption drain and the live handoff in the port, on the
CPU: the counterparts of the JAX package's ``tests/test_chaos.py``
``test_sigterm_drains_and_continues_from_current_step``.

- A LeNet gang of two under the port's ``Supervisor`` with
  ``DLS_FAULT=sigterm@9``: host 1's notice drains the gang at step 9
  (every rank exits 0), the attempt is classified ``graceful-shutdown``,
  the ``DRAIN`` evidence retired to ``DRAIN.consumed-0``, the gang shrunk
  at once to one process that resumes from the handoff at step 9 with no
  walk-back and no step logged twice; the JAX package's ``dlstatus``
  renders the incident; the losses equal an unfaulted port run's
  (``rel=1e-6``) and match the JAX ``Trainer`` on one device from the same
  weights and batches.
- The same drill with the notice delivered as a file
  (``deliver_preempt_notice``, ``DLS_PREEMPT_NOTICE``).
- A torn handoff: the relaunch refuses it, walks back through the
  checkpoint (a ``reshard`` event with ``walk_back``) and ends where an
  unfaulted run ends.
- A tiny Llama LoRA at ``fsdp=4`` drained and resumed at ``fsdp=3`` (the
  FSDP2 shards gathered by the live engine), held against one device.
- In one process: a drain without a checkpointer raises; a drain at one
  rank writes the handoff, then ``DRAIN``, and no checkpoint past it.
"""

import io
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import optax
import pytest

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import status
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu_torch import Checkpointer, LeNet5, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.parallel import live_reshard
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.supervisor import Supervisor
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from distributeddeeplearningspark_tpu_torch.utils.env import conf_to_env

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples"
MNIST, LLAMA = EXAMPLES / "train_mnist.py", EXAMPLES / "train_llama_lora.py"
CPU = conf_to_env({DEVICE_CONF: "cpu"})
STEPS, EVERY, DRAIN_AT, BATCH = 18, 6, 9, 32
# the driver's data: 4,096 synthetic images in 2 partitions, so one rank
# and two take the same global batches
MNIST_DATA = dict(num_examples=4096, num_partitions=2, seed=0)
# the drill's losses against an unfaulted port run: 9 steps summed over two
# ranks, then one; gloo adds the halves' gradients in another order
DRILL_RTOL = 1e-6
# against the JAX Trainer on one device: f32 convolutions summed in another
# order, compounded over 18 SGD steps (test_torch_lenet.py's FIT tolerance)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
# the tiny Llama at fsdp=4 then 3 against one device: f32 sums in another
# order (test_torch_fsdp.py's RTOL)
LLAMA_RTOL = 1e-4
LLAMA_STEPS, LLAMA_DRAIN_AT = 8, 4
LLAMA_ARGS = ["--variant", "tiny", "--seq-len", "64", "--batch-size", "12",
              "--source-partitions", "12", "--lora-rank", "4", "--log-every", "1",
              "--steps", str(LLAMA_STEPS), "--checkpoint-every", "4"]


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _no_inherited_fault(monkeypatch):
    """No fault from the environment; no telemetry binding left behind."""
    for name in ("DLS_FAULT", "DLS_RESTART", "DLS_FAULT_ALL_ATTEMPTS",
                 "DLS_TELEMETRY_DIR", "DLS_FAULT_RANK", "DLS_FAULT_HOST",
                 faults.PREEMPT_NOTICE_ENV):
        monkeypatch.delenv(name, raising=False)
    yield
    ttele.reset()


def _mnist_argv(ckpt: Path, steps: int = STEPS) -> list[str]:
    return [sys.executable, str(MNIST), "--steps", str(steps), "--batch-size", str(BATCH),
            "--log-every", "1", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", str(EVERY), "--source-partitions", "2", "--resume"]


def _supervise(argv: list[str], wd: Path, n: int, env: dict | None = None,
               max_restarts: int = 3):
    wd.mkdir(parents=True, exist_ok=True)
    ckpt = wd / "ckpt"
    return Supervisor(argv, num_processes=n, max_restarts=max_restarts,
                      restart_backoff_s=0.05, backoff_jitter=0.0, shrink_after=2,
                      env={**CPU, **(env or {})}, ckpt_dir=str(ckpt),
                      progress_path=str(ckpt), telemetry_dir=str(wd)).run()


def _events(wd: Path, kind: str, event: str | None = None) -> list[dict]:
    return [e for e in jtele.read_events(str(wd)) if e["kind"] == kind
            and (event is None or e.get("event") == event)]


def _losses(wd: Path) -> dict[int, float]:
    """Host 0's logged loss by step (every rank logs the global loss)."""
    return {int(e["step"]): float(e["metrics"]["loss"])
            for e in _events(wd, "step_metrics") if e.get("host", 0) == 0}


def _summary(result) -> list:
    return [(a.ordinal, a.returncodes, a.classification, a.num_processes)
            for a in result.attempts]


@pytest.fixture(scope="module")
@bounded()
def unfaulted(tmp_path_factory):
    """The LeNet driver at one process, no fault: its losses by step."""
    wd = tmp_path_factory.mktemp("unfaulted")
    result = _supervise(_mnist_argv(wd / "ckpt"), wd, 1, max_restarts=0)
    assert result.ok, _summary(result)
    return _losses(wd)


@pytest.fixture(scope="module")
@bounded()
def drill(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sigterm")
    result = _supervise(_mnist_argv(wd / "ckpt"), wd, 2,
                        env={"DLS_FAULT": f"sigterm@{DRAIN_AT}"})
    return wd, result


# -- the LeNet drill ----------------------------------------------------------------


def test_drill_drains_once_and_shrinks_without_backoff(drill):
    wd, result = drill
    assert result.ok, _summary(result)
    assert result.restarts == 1
    assert [a.num_processes for a in result.attempts] == [2, 1]
    assert result.attempts[0].classification == "graceful-shutdown"
    assert result.attempts[0].returncodes == [0, 0]
    assert result.attempts[1].classification == "clean"
    assert not (wd / "ckpt" / "DRAIN").exists()
    assert (wd / "ckpt" / "DRAIN.consumed-0").read_text().split() == ["1", str(DRAIN_AT)]
    assert not live_reshard.has_handoff(wd / "ckpt")  # consumed on ingest
    assert not any(e.get("edge") == "backoff" for e in _events(wd, "attempt"))


def test_drill_resumes_from_the_handoff_at_the_drained_step(drill):
    wd, _ = drill
    (gs,) = _events(wd, "recovery", "graceful_shutdown")
    assert gs["step"] == DRAIN_AT and gs["dead_host"] == 1 and gs["drained"] is True
    (geo,) = _events(wd, "recovery", "geometry_change")
    assert geo["resume"] == "live-handoff" and geo["step"] == DRAIN_AT
    assert geo["dead_host"] == 1
    assert (geo["from_processes"], geo["to_processes"]) == (2, 1)
    # no checkpoint at the drained step: the handoff is the resume point
    steps = sorted(int(d) for d in os.listdir(wd / "ckpt") if d.isdigit())
    assert steps == [6, 12, 18]


def test_drill_reshards_live_and_logs_no_step_twice(drill):
    wd, _ = drill
    rs = _events(wd, "recovery", "reshard")
    drains = [e for e in rs if e.get("reason") == "preemption-drain"]
    resumes = [e for e in rs if e.get("reason") == "preemption-resume"]
    assert len(drains) == 2 and all(e["transport"] == "collectives" for e in drains)
    assert len(resumes) == 1 and resumes[0]["transport"] == "handoff"
    assert resumes[0]["verified"] and resumes[0]["step"] == DRAIN_AT
    assert not any(e.get("walk_back") for e in rs)
    seen = [int(e["step"]) for e in _events(wd, "step_metrics") if e.get("host", 0) == 0]
    assert len(seen) == len(set(seen)) and sorted(seen) == list(range(1, STEPS + 1))


def test_dlstatus_renders_the_graceful_shutdown(drill):
    wd, _ = drill
    rep = status.report(str(wd))
    assert rep["reshard"]["live_moves"] >= 2 and rep["reshard"]["walk_back_moves"] == 0
    rendered = status.render(rep)
    assert "graceful shutdown: host 1" in rendered, rendered
    assert "checkpoint-free (live)" in rendered, rendered
    out = io.StringIO()
    with redirect_stdout(out):
        assert status.main([str(wd)]) == 0


def test_drill_losses_equal_an_unfaulted_run(drill, unfaulted):
    wd, _ = drill
    got = _losses(wd)
    assert sorted(got) == sorted(unfaulted) == list(range(1, STEPS + 1))
    assert any(s > DRAIN_AT for s in got)
    for s in got:
        assert got[s] == pytest.approx(unfaulted[s], rel=DRILL_RTOL), s


def _flax_from_port(sd: dict) -> dict:
    """The port's LeNet state dict as flax params (``lenet_io``'s inverse)."""
    out: dict = {}
    for name, t in sd.items():
        layer, what = name.split(".")
        kind, index = layer.split("_")
        key = f"{kind.capitalize()}_{index}"
        a = t.detach().numpy()
        if what == "weight":
            out.setdefault(key, {})["kernel"] = (a.transpose(2, 3, 1, 0) if kind == "conv"
                                                 else a.T)
        else:
            out.setdefault(key, {})["bias"] = a
    return out


def test_drill_losses_match_the_jax_trainer_on_one_device(drill):
    """The JAX ``Trainer`` on one device from the driver's weights (its
    ``LeNet5`` drawn from seed 0, converted) and batches, 18 steps of
    ``sgd(0.01, momentum=0.9)``."""
    wd, _ = drill
    jspark = JSession.builder.master("local[1]").getOrCreate()
    try:
        jt = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent,
                      optax.sgd(0.01, momentum=0.9))
        jds = jsources.synthetic_mnist(**MNIST_DATA)
        jt.init(jt._sample_batch(jds, BATCH))
        jt.load_pretrained(_flax_from_port(LeNet5(device="cpu").state_dict()))
        want: list = []
        jt.fit(jds.repeat(), batch_size=BATCH, steps=STEPS, log_every=1,
               callbacks=[lambda s, m: want.append(float(m["loss"]))])
    finally:
        jspark.stop()
    got = _losses(wd)
    np.testing.assert_allclose([got[s] for s in sorted(got)], want,
                               rtol=JAX_RTOL, atol=JAX_ATOL)


# -- the notice file, and a torn handoff ------------------------------------------------


def test_a_delivered_notice_drains_and_is_retired(tmp_path, unfaulted):
    notice = tmp_path / "scheduler" / "notice.json"
    faults.deliver_preempt_notice(str(notice), host=1, step=DRAIN_AT)
    assert faults.read_preempt_notice(str(notice)) == faults.PreemptNotice(1, DRAIN_AT)
    wd = tmp_path / "run"
    result = _supervise(_mnist_argv(wd / "ckpt"), wd, 2,
                        env={faults.PREEMPT_NOTICE_ENV: str(notice)})
    assert result.ok, _summary(result)
    assert [a.classification for a in result.attempts] == ["graceful-shutdown", "clean"]
    assert not notice.exists() and (tmp_path / "scheduler" / "notice.json.consumed-0").exists()
    (geo,) = _events(wd, "recovery", "geometry_change")
    assert geo["resume"] == "live-handoff" and geo["step"] == DRAIN_AT
    got = _losses(wd)
    assert sorted(got) == list(range(1, STEPS + 1))
    for s in got:
        assert got[s] == pytest.approx(unfaulted[s], rel=DRILL_RTOL), s


def test_a_torn_notice_reads_as_none(tmp_path):
    path = tmp_path / "notice.json"
    assert faults.read_preempt_notice(str(path)) is None
    path.write_text('{"host": 1')
    assert faults.read_preempt_notice(str(path)) is None
    assert faults.read_preempt_notice(None) is None  # no env, no path


def test_a_torn_handoff_walks_back_through_the_checkpoint(tmp_path, unfaulted):
    wd = tmp_path / "torn"
    first = _supervise(_mnist_argv(wd / "ckpt"), wd, 2,
                       env={"DLS_FAULT": f"sigterm@{DRAIN_AT}"}, max_restarts=0)
    assert [a.classification for a in first.attempts] == ["graceful-shutdown"]
    hd = Path(live_reshard.handoff_dir(wd / "ckpt"))
    victim = hd / live_reshard.peek_handoff(wd / "ckpt")["leaves"][0]["file"]
    victim.write_bytes(victim.read_bytes()[:-4])
    result = _supervise(_mnist_argv(wd / "ckpt"), wd, 1, max_restarts=0)
    assert result.ok, _summary(result)
    assert not live_reshard.has_handoff(wd / "ckpt")
    (walk,) = [e for e in _events(wd, "recovery", "reshard") if e.get("walk_back")]
    assert walk["transport"] == "checkpoint" and walk["reason"] == "handoff-rejected"
    assert walk["step"] == EVERY and "blake2b" in walk["error"]
    assert "walk-back=1" in status.render(status.report(str(wd)))
    got = _losses(wd)  # steps 7..9 ran twice: once before the drain
    for s in range(EVERY + 1, STEPS + 1):
        assert got[s] == pytest.approx(unfaulted[s], rel=DRILL_RTOL), s


# -- a tiny Llama, fsdp=4 → 3 ------------------------------------------------------------


@pytest.fixture(scope="module")
@bounded()
def llama(tmp_path_factory):
    """The drill at 4 ranks (host 1 doomed at step 4), then one device on
    the same batches: (drill dir, result, the one device's losses)."""
    wd = tmp_path_factory.mktemp("llama_drain")
    argv = [sys.executable, str(LLAMA), *LLAMA_ARGS, "--checkpoint-dir",
            str(wd / "ckpt"), "--resume"]
    result = _supervise(argv, wd, 4, env={"DLS_FAULT": f"sigterm@{LLAMA_DRAIN_AT}"})
    one = tmp_path_factory.mktemp("llama_one")
    res = run_gang(["--master", "local[1]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(one), str(LLAMA), *LLAMA_ARGS])
    assert res.returncode == 0, res.stderr[-4000:]
    return wd, result, _losses(one)


def test_llama_drains_at_fsdp4_and_resumes_at_fsdp3(llama):
    wd, result, _ = llama
    assert result.ok, _summary(result)
    assert [(a.classification, a.num_processes) for a in result.attempts] == [
        ("graceful-shutdown", 4), ("clean", 3)]
    rs = _events(wd, "recovery", "reshard")
    drains = [e for e in rs if e.get("reason") == "preemption-drain"]
    resumes = [e for e in rs if e.get("reason") == "preemption-resume"]
    assert len(drains) == 4 and len(resumes) == 3
    # the gathered leaves' files carry the engine's verified digests, and
    # the ingest checked them
    assert all(e["verified"] for e in resumes) and not any(e.get("walk_back") for e in rs)
    # the FSDP2 shards were gathered by the engine, under its budget
    assert all(e["leaves_moved"] > 0 and e["bytes_moved"] > 0 for e in drains)
    assert all(e["peak_inflight_bytes"] <= e["mem_budget_mb"] * 2**20 for e in drains)
    seen = [int(e["step"]) for e in _events(wd, "step_metrics") if e.get("host", 0) == 0]
    assert sorted(seen) == list(range(1, LLAMA_STEPS + 1))


def test_llama_drain_losses_match_one_device(llama):
    wd, _, one = llama
    got = _losses(wd)
    assert sorted(got) == sorted(one) == list(range(1, LLAMA_STEPS + 1))
    for s in got:
        assert got[s] == pytest.approx(one[s], rel=LLAMA_RTOL), s


# -- in one process -----------------------------------------------------------------


@pytest.fixture()
def spark():
    s = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    yield s
    s.stop()


def _lenet_trainer(spark, checkpointer=None) -> Trainer:
    return Trainer(spark, LeNet5(device="cpu"), tlosses.softmax_xent,
                   toptim.sgd(0.01, momentum=0.9), checkpointer=checkpointer)


def test_a_drain_needs_a_checkpointer(spark, monkeypatch):
    monkeypatch.setenv("DLS_FAULT", "sigterm@2")
    trainer = _lenet_trainer(spark)
    with pytest.raises(RuntimeError, match="needs a checkpointer"):
        trainer.fit(tsources.synthetic_mnist(256, num_partitions=1).repeat(),
                    batch_size=16, steps=4)
    assert trainer.preempted_at is None


def test_a_drain_commits_the_handoff_then_the_evidence(spark, monkeypatch, tmp_path):
    """At one rank: ``fit`` returns at the drained step with a handoff that
    holds the live state bitwise and ``DRAIN`` beside it, and writes no
    checkpoint past the last before the drain."""
    monkeypatch.setenv("DLS_FAULT", "sigterm@5")
    ckpt = Checkpointer(tmp_path, async_save=False)
    trainer = _lenet_trainer(spark, ckpt)
    state, _ = trainer.fit(tsources.synthetic_mnist(256, num_partitions=1).repeat(),
                           batch_size=16, steps=8, checkpoint_every=2)
    assert trainer.preempted_at == 5 and state.step == 5
    assert ckpt.all_steps() == [2, 4]
    assert (tmp_path / "DRAIN").read_text().split() == ["1", "5"]
    manifest = live_reshard.peek_handoff(tmp_path)
    assert manifest["step"] == 5
    assert manifest["data_state"] == {"examples_seen": 80, "batch_size": 16}
    want = live_reshard.tree_digest(state.state_dict())
    fresh = _lenet_trainer(spark, ckpt)
    fresh.restore_live_handoff()
    assert fresh.state.step == 5
    assert live_reshard.tree_digest(fresh.state.state_dict()) == want
    assert not live_reshard.has_handoff(tmp_path)

"""The port's own ``dlstatus`` (``status.py`` with the copied reader half:
``telemetry``'s ``read_events``/``EventCursor``/``goodput``, ``trace``,
``fleet``, ``health``, ``series``, ``anatomy``) against the JAX package's,
on the CPU.

A port run's workdir (a tiny Llama LoRA through ``fit`` with
``measure_flops`` and a profiled window, a checkpoint, then requests served
by the engine, so the stream holds ``compile``, ``memory``, laps with MFU,
``span`` and ``request`` events) is read by both: ``--json --anatomy
--traces --health --hosts`` prints the same report, with the readers'
clocks pinned (a heartbeat's age and the health engine's tick are
clock-dependent) and each reading its own copy of the workdir (``--health``
rewrites ``health.json`` there). ``--cluster`` is refused by name; the port
runs as ``python -m distributeddeeplearningspark_tpu_torch.status`` and
renders the anatomy's MFU and memory lines.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import status as jstatus
from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer
from distributeddeeplearningspark_tpu_torch import status as tstatus
from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.serve.engine import InferenceEngine
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.telemetry import health
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils.profiling import ProfileSpec

from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--json", "--anatomy", "--traces", "--health", "--hosts"]


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _stop_session():
    """The port's ``Session`` is one a process: a test's must not be the
    next test's (a worker runs file after file)."""
    yield
    if Session._active is not None:
        Session._active.stop()
    telemetry.reset()


@pytest.fixture(scope="module")
@bounded()
def run(tmp_path_factory):
    """A port run's workdir: training with the device-side events, then
    served requests."""
    wd = tmp_path_factory.mktemp("port_run")
    mp = pytest.MonkeyPatch()
    mp.setenv(telemetry.WORKDIR_ENV, str(wd))
    try:
        spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
        cfg = tllama.LlamaConfig.tiny(lora_rank=4, num_layers=2)
        model = tllama.LlamaForCausalLM(cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        ds = PartitionedDataset.parallelize(
            [{"input_ids": rng.integers(0, 512, 32).astype(np.int32)} for _ in range(8)], 2)
        ckpt = Checkpointer(str(wd / "ckpt"))
        trainer = Trainer(spark, model, losses.causal_lm,
                          optim.masked(optim.adamw(1e-3), tllama.lora_trainable),
                          trainable=tllama.lora_trainable, checkpointer=ckpt)
        trainer.fit(ds.repeat(), batch_size=4, steps=6, log_every=2, checkpoint_every=6,
                    measure_flops=True,
                    profile=ProfileSpec(str(wd / "prof"), start_step=2, num_steps=2))
        ckpt.close()
        telemetry.reset()
        with InferenceEngine(lambda p, b: {"y": b["x"] * p["w"]}, {"w": torch.tensor(2.0)},
                             device="cpu", max_batch=4, workdir=str(wd)) as eng:
            for i in range(6):
                eng.infer({"x": np.float32(i)})
        telemetry.reset()
        spark.stop()
    finally:
        mp.undo()
    return wd


def _report(mod, wd: Path, argv: list[str], capsys, monkeypatch) -> dict:
    """``mod``'s ``dlstatus`` JSON of ``wd``, the workdir's path written
    ``WD`` (each reads its own copy)."""
    monkeypatch.setattr(time, "time", lambda: 2_000_000_000.0)
    monkeypatch.setattr(time, "perf_counter", lambda: 100.0)
    assert mod.main([str(wd), *argv]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line.replace(str(wd), "WD"))


def test_port_dlstatus_equals_jax_dlstatus_on_a_port_run(run, tmp_path, capsys,
                                                        monkeypatch):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(run, mine)
    shutil.copytree(run, theirs)
    got = _report(tstatus, mine, FLAGS, capsys, monkeypatch)
    want = _report(jstatus, theirs, FLAGS, capsys, monkeypatch)
    assert got == want
    an = got["anatomy"]
    assert an["mfu"]["mfu"] > 0 and an["mfu"]["flops_per_step"] > 0
    assert an["memory"]["live_bytes"] > 0
    assert an["compile_ledger"]["compiles"] == 1
    assert got["traces"] and got["health"]
    assert got["goodput"]["checkpoint_s"] > 0 and got["goodput"]["compile_s"] > 0


def test_port_dlstatus_renders_anatomy_and_runs_as_a_module(run):
    res = subprocess.run([sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.status",
                          str(run), "--anatomy"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "device anatomy" in res.stdout and "MFU" in res.stdout
    assert "compile ledger" in res.stdout and "memory" in res.stdout


def test_cluster_is_refused_by_name(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        tstatus.main(["--cluster", str(tmp_path)])
    assert exc.value.code == 2
    assert "ROADMAP Queue 1 item 7" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="scheduler"):
        health.cluster_report(str(tmp_path))


def test_event_cursor_reads_what_read_events_reads(run):
    cur = telemetry.EventCursor(run)
    assert cur.poll() == telemetry.read_events(run)
    assert cur.poll() == [] and cur.lag_bytes() == 0
    assert telemetry.event_files(run) == telemetry.event_files(Path(run) / "telemetry")

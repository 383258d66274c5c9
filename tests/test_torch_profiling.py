"""The port's profiler (``utils/profiling.py`` over ``torch.profiler``,
``utils/kineto.py``) and ``fit``'s TensorBoard writer on the CPU, holding
the JAX package's contracts of ``tests/test_profiling.py``:

- a context-manager capture and a step window write a Chrome trace; the
  window is relative to the step the loop resumed at; ``stop`` twice and a
  disabled profiler are no-ops;
- ``fit(profile=..., measure_flops=True)`` traces its window and writes
  ``profile-trace`` phase events; a run that fails inside the window still
  writes its trace, and a later ``fit`` profiles again;
- ``op_breakdown`` of a CPU trace (the busiest thread's outermost
  ``cpu_op`` events): ops sorted by time, percentages summing to at most
  100.5; a missing directory, or one without a trace, is an error;
  ``profile_cli`` prints the budget, also as ``python -m``;
- on a device trace (Kineto's Chrome JSON, written here by hand in its
  schema: no card on the CPU) the busiest stream's kernels, copies and
  memsets by family, the mirrored ``gpu_user_annotation`` ranges skipped;
- ``fit(tensorboard_dir=...)`` leaves TensorBoard event files there.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import Session, Trainer, telemetry
from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils import kineto, profiling

from test_torch_deadline import per_test

ROOT = Path(__file__).resolve().parents[1]


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


def _matmuls(n: int = 3):
    x = torch.ones(128, 128)
    for _ in range(n):
        x = x @ x
    return x


def test_trace_context_manager_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.annotate("compute"):
            _matmuls(1)
    files = profiling.trace_files(d)
    assert files and files[0].endswith(profiling.TRACE_SUFFIX)
    names = {e.get("name") for e in kineto.load(files[0])}
    assert "compute" in names and "aten::mm" in names


def test_step_profiler_window(tmp_path):
    d = str(tmp_path / "prof")
    prof = profiling.StepProfiler(profiling.ProfileSpec(d, start_step=2, num_steps=2))
    for step in range(6):
        prof.observe(step)
        assert prof._active == (2 <= step < 4)
        with profiling.step_annotation(step):
            torch.ones(8) * step
    prof.stop()
    assert profiling.trace_files(d) == [prof.trace_path]
    names = {e.get("name") for e in kineto.load(prof.trace_path)}
    assert {"train_step#2", "train_step#3"} <= names and "train_step#4" not in names
    prof.stop()  # idempotent
    profiling.StepProfiler(None).observe(0)
    prof.join_breakdown()


def test_step_profiler_offset_is_resume_relative(tmp_path):
    d = str(tmp_path / "prof")
    prof = profiling.StepProfiler(profiling.ProfileSpec(d, start_step=2, num_steps=1),
                                  start_offset=1000)
    for step in range(1000, 1002):
        prof.observe(step)
        assert not prof._active
    prof.observe(1002)
    assert prof._active
    prof.stop()
    assert profiling.trace_files(d)


def _lenet_trainer(tmp_path=None):
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    rng = np.random.default_rng(0)
    examples = [{"image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32),
                 "label": np.int32(i % 10)} for i in range(64)]
    ds = PartitionedDataset.parallelize(examples, 2).repeat()
    return Trainer(spark, LeNet5(device="cpu"), losses.softmax_xent,
                   optim.sgd(0.01)), ds


def test_fit_with_profile_and_flops(tmp_path, monkeypatch):
    monkeypatch.setenv(telemetry.WORKDIR_ENV, str(tmp_path / "wd"))
    trainer, ds = _lenet_trainer()
    prof_dir = str(tmp_path / "prof")
    try:
        state, summary = trainer.fit(
            ds, batch_size=16, steps=8, log_every=4,
            profile=profiling.ProfileSpec(prof_dir, start_step=4, num_steps=2),
            measure_flops=True)
    finally:
        telemetry.reset()
    assert state.step == 8 and "step_time_ms" in summary
    assert len(profiling.trace_files(prof_dir)) == 1
    phases = [e for e in telemetry.read_events(tmp_path / "wd")
              if e["kind"] == "phase" and e["name"] == "profile-trace"]
    assert [(e["edge"], e.get("step")) for e in phases] == [("begin", 4), ("end", None)]
    assert trainer._train_step.flops_per_step > 0


def test_fit_crash_mid_window_still_flushes_trace(tmp_path):
    trainer, ds = _lenet_trainer()

    def boom(step, _):
        if step >= 3:
            raise RuntimeError("injected")

    prof_dir = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="injected"):
        trainer.fit(ds, batch_size=16, steps=10, log_every=100,
                    profile=profiling.ProfileSpec(prof_dir, start_step=1, num_steps=8),
                    callbacks=[boom])
    assert profiling.trace_files(prof_dir), "a failed run must still write its trace"
    # the profiler stopped: a later fit with one must not collide
    trainer.fit(ds, batch_size=16, steps=6, log_every=100,
                profile=profiling.ProfileSpec(str(tmp_path / "p2"), start_step=1,
                                              num_steps=2))
    assert profiling.trace_files(str(tmp_path / "p2"))


def test_op_breakdown_parses_cpu_trace(tmp_path):
    """No device line in a CPU trace: the busiest host thread's outermost
    ops (the fallback xplane takes to the busiest line)."""
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        _matmuls()
    rec = profiling.op_breakdown(d, top=10)
    assert "error" not in rec, rec
    assert rec["plane"].startswith("host") and rec["line"].startswith("thread")
    assert rec["event_count"] > 0
    assert rec["ops"] and len(rec["ops"]) <= 10
    total_pct = sum(o["pct"] for o in rec["ops"])
    assert 0 < total_pct <= 100.5, rec["ops"]
    assert rec["ops"] == sorted(rec["ops"], key=lambda o: -o["ms"])
    assert rec["ops"][0]["name"] == "aten::matmul" and rec["ops"][0]["count"] == 3
    assert rec["total_ms"] == pytest.approx(sum(o["ms"] for o in rec["ops"]), rel=1e-3)


def test_op_breakdown_missing_dir_and_empty_dir(tmp_path):
    assert "error" in profiling.op_breakdown(str(tmp_path / "nothing_here"))
    (tmp_path / "empty").mkdir()
    assert "no *" in profiling.op_breakdown(str(tmp_path / "empty"))["error"]


def test_profile_cli_prints_budget(tmp_path, capsys):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        _matmuls(1)
    assert profiling.profile_cli([d, "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "total" in out and "aten::" in out
    assert profiling.profile_cli([d, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ops"]
    assert profiling.profile_cli([str(tmp_path / "none")]) == 1
    res = subprocess.run([sys.executable, "-m",
                          "distributeddeeplearningspark_tpu_torch.utils.profiling",
                          d, "--json"], capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["ops"]


def _device_trace(path: Path) -> None:
    """A Chrome trace in Kineto's schema with a card's events: the compute
    stream 7 (K1, a GEMM, an elementwise kernel, a memset), a copy stream
    (a memcpy) and NCCL's stream, a host range mirrored onto the device,
    and host ops."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9, "tid": 9,
         "ts": 0, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "dls_flash_fwd_bf16_kernel",
         "pid": 0, "tid": 7, "ts": 10, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "dls_flash_fwd_bf16_kernel",
         "pid": 0, "tid": 7, "ts": 400, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x256_64x4",
         "pid": 0, "tid": 7, "ts": 700, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel",
         "pid": 0, "tid": 7, "ts": 1200, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 1300, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "pid": 0, "tid": 20, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
         "pid": 0, "tid": 30, "ts": 0, "dur": 600},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nccl:all_reduce",
         "pid": 0, "tid": 30, "ts": 0, "dur": 650},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": ev}))


def test_breakdown_reads_the_busiest_device_stream_by_family(tmp_path):
    path = tmp_path / "card.pt.trace.json"
    _device_trace(path)
    rec = kineto.parse(str(path))
    assert (rec["plane"], rec["line"], rec["event_count"]) == ("device 0", "stream 7", 5)
    assert rec["total_ms"] == pytest.approx(1.0)
    got = {o["name"]: (o["ms"], o["count"]) for o in rec["ops"]}
    assert got == {"flash": (0.5, 2), "gemm": (0.4, 1), "other": (0.1, 2)}
    assert rec["ops"][0]["top_instance"] == "dls_flash_fwd_bf16_kernel"
    by_kernel = kineto.parse(str(path), by="kernel")
    assert {o["name"] for o in by_kernel["ops"]} == {
        "dls_flash_fwd_bf16_kernel", "nvjet_tst_128x256_64x4",
        "vectorized_elementwise_kernel", "Memset (Device)"}
    every = kineto.parse(str(path), streams="all")
    fam = {o["name"]: o["ms"] for o in every["ops"]}
    # the NCCL kernel's own time, not its mirrored host range's
    assert fam["nccl"] == pytest.approx(0.6) and every["event_count"] == 7
    assert every["total_ms"] == pytest.approx(1.7)
    assert profiling.op_breakdown(str(tmp_path))["line"] == "stream 7"


@pytest.mark.parametrize("name,family", [
    ("void dls_flash_bwd_dq_kernel<128>", "flash"),
    ("dls_matmul_stats_bf16_kernel", "k4"), ("dls_scatter_add_rows_f32", "k5"),
    ("ncclDevKernel_AllGather_RING_LL", "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv"),
    ("cutlass_80_tensorop_bf16_s16816gemm", "gemm"), ("nvjet_tst_64x8", "gemm"),
    ("at::native::reduce_kernel<512, 1>", "other"),
])
def test_kernel_family(name, family):
    assert kineto.kernel_family(name) == family


def test_fit_writes_tensorboard_event_files(tmp_path, caplog):
    trainer, ds = _lenet_trainer()
    tb = tmp_path / "tb"
    with caplog.at_level(logging.WARNING):
        trainer.fit(ds, batch_size=16, steps=4, log_every=2, tensorboard_dir=str(tb))
    files = list(tb.glob("events.out.tfevents.*"))
    assert files and files[0].stat().st_size > 0
    assert "tensorboard writer unavailable" not in caplog.text
    # on rank 0 only: another rank writes none
    from distributeddeeplearningspark_tpu_torch.metrics import MetricLogger
    from distributeddeeplearningspark_tpu_torch.parallel import collectives

    orig = collectives.rank
    collectives.rank = lambda: 1
    try:
        MetricLogger(tensorboard_dir=str(tmp_path / "tb1")).close()
    finally:
        collectives.rank = orig
    assert not os.path.exists(tmp_path / "tb1")

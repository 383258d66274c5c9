"""``dlserve`` in the port (``python -m
distributeddeeplearningspark_tpu_torch.serve.cli``) on the CPU: its flag
validation against the JAX package's, a LeNet run and its JSON line, a
LeNet run under ``--watch`` that hot-reloads a step committed mid-load, a
``tinyllama`` fleet of two replica processes with a rolling reload, the
serving example ``examples/serve_mnist.py``, and the Llama driver's
``--sample-tokens``."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from distributeddeeplearningspark_tpu.serve import cli as jcli
from distributeddeeplearningspark_tpu_torch import status as tstatus
from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
from distributeddeeplearningspark_tpu_torch.serve import cli as tcli
from distributeddeeplearningspark_tpu_torch.train.state import TrainState
from test_torch_deadline import per_test

ROOT = Path(__file__).resolve().parents[1]
PKG = "distributeddeeplearningspark_tpu_torch"


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _unbind_telemetry():
    yield
    telemetry.reset()


def _env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": str(ROOT) + (os.pathsep + path if path else ""),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _run(args: list[str], timeout: float = 200.0) -> dict:
    """Run a port entry point as a process; its last JSON line."""
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads([x for x in out.stdout.splitlines() if x.startswith("{")][-1])


@pytest.mark.parametrize("argv,words", [
    (["--watch"], "--watch requires --checkpoint-dir"),
    (["--replicas", "-1"], "--replicas must be >= 0"),
    (["--model", "tinyllama"], "fleet mode"),
    (["--rolling-reload"], "need --replicas N"),
    (["--tenant-budget", "3"], "need --replicas N"),
    (["--replicas", "2", "--fault-sleep-ms", "-1"], "--fault-sleep-ms must be >= 0"),
    (["--replicas", "2", "--fault-sleep-ms", "5", "--fault-replica", "2"],
     "out of range"),
    (["--replicas", "2", "--compare-sequential"], "single-engine harness"),
])
def test_flag_validation_matches_jax(argv, words, capsys):
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        assert words in capsys.readouterr().err, cli.__name__


def test_device_flag_takes_cuda_or_cpu(capsys):
    assert tcli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--device", "tpu"])


def test_lenet_run_prints_one_json_line(tmp_path):
    rec = _run(["-m", f"{PKG}.serve.cli", "--device", "cpu", "--model", "lenet",
                "--clients", "4", "--requests-per-client", "4", "--compare-sequential",
                "--workdir", str(tmp_path)])
    ex = rec["extra"]
    assert rec["metric"] == "dlserve_requests_per_sec" and rec["value"] > 0
    assert ex["requests_ok"] == 16 and ex["requests_shed"] == 0
    assert ex["device"] == "cpu" and ex["compiled_batch_shapes"] == 6
    assert ex["batching_speedup"] > 0
    assert tstatus.report(str(tmp_path))["serving"]["ok"] == 16


def _lenet_state(seed: int, step: int) -> TrainState:
    model = LeNet5(device="cpu", seed=seed)
    return TrainState(step=step, params=dict(model.named_parameters()), opt_state=[],
                      generator=torch.Generator().manual_seed(0))


def test_lenet_watch_reloads_a_step_committed_mid_load(tmp_path):
    ck_dir = tmp_path / "ck"
    with Checkpointer(ck_dir, async_save=False) as ck:
        ck.save(1, _lenet_state(0, 1))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serve.cli", "--device", "cpu", "--model",
         "lenet", "--checkpoint-dir", str(ck_dir), "--watch", "--watch-interval-s",
         "0.02", "--max-batch", "1", "--max-queue", "4096", "--clients", "8",
         "--requests-per-client", "150"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    err: list[str] = []
    warmed = threading.Event()

    def read_err():
        for line in proc.stderr:
            err.append(line)
            if "warmed" in line:
                warmed.set()

    reader = threading.Thread(target=read_err, daemon=True)
    reader.start()
    try:
        assert warmed.wait(120), "".join(err)[-2000:]
        with Checkpointer(ck_dir, async_save=False) as ck:
            ck.save(2, _lenet_state(1, 2))
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    assert proc.returncode == 0, "".join(err)[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["extra"]["checkpoint_step"] == 1
    assert rec["extra"]["reloads"] >= 1 and rec["extra"]["params_version"] == 2
    assert rec["extra"]["requests_ok"] == 8 * 150 and rec["extra"]["requests_shed"] == 0


def test_tinyllama_fleet_run_with_a_rolling_reload(tmp_path):
    wd = tmp_path / "fleet"
    rec = _run(["-m", f"{PKG}.serve.cli", "--device", "cpu", "--model", "tinyllama",
                "--replicas", "2", "--rolling-reload", "--compare-single-replica",
                "--clients", "4", "--requests-per-client", "4", "--workdir", str(wd)],
               timeout=220)
    ex = rec["extra"]
    assert ex["requests_ok"] == 16 and ex["requests_dropped"] == 0
    assert ex["requests_failed"] == 0
    assert ex["rolling_reload"]["replicas_reloaded"] == 2
    assert set(ex["replica_devices"].values()) == {"cpu"}
    assert ex["prefix"]["hits"] >= 1 and ex["single_replica"]["requests_ok"] == 16
    fs = tstatus.report(str(wd), fleet_serve=True)["fleet_serve"]
    assert fs["totals"]["ok"] >= 32


def test_serve_mnist_example_reloads_under_load(tmp_path):
    rec = _run([str(ROOT / PKG / "examples" / "serve_mnist.py"), "--device", "cpu",
                "--steps", "4", "--clients", "8", "--requests", "8", "--workdir",
                str(tmp_path)])
    ex = rec["extra"]
    assert ex["hot_reloads"] >= 1 and ex["requests_ok"] == 64
    assert ex["checkpoint_step_at_start"] == 4 and ex["device"] == "cpu"


def test_llama_driver_samples_after_fit(tmp_path):
    """``--sample-tokens 16`` at ``--variant tiny``: two continuations of
    16 tokens inside the vocabulary, printed and in the JSON line."""
    out = subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli", "--master", "local[1]", "--conf",
         "spark.dls.device=cpu", "--workdir", str(tmp_path),
         str(ROOT / PKG / "examples" / "train_llama_lora.py"), "--variant", "tiny",
         "--steps", "2", "--batch-size", "4", "--seq-len", "64", "--lora-rank", "4",
         "--sample-tokens", "16"], capture_output=True, text=True, timeout=200,
        cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads([x for x in out.stdout.splitlines()
                      if x.startswith('{"train"')][-1])
    sampled = rec["sampled"]
    assert len(sampled) == 2 and all(len(r) == 16 for r in sampled)
    assert all(0 <= t < 2048 for r in sampled for t in r)
    assert f"sampled continuations: {sampled}" in out.stdout


def test_llama_driver_refuses_sampling_on_a_pipeline(capsys):
    """Generation runs on one card: the stages of a pipeline hold its
    layers, so ``--sample-tokens`` beside ``--pipeline`` fails at parse
    time naming its ROADMAP item."""
    from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora

    with pytest.raises(SystemExit) as e:
        train_llama_lora.parse_args(["--pipeline", "2", "--sample-tokens", "4"])
    assert e.value.code == 2
    assert "ROADMAP Queue 1 item 8" in capsys.readouterr().err
    assert train_llama_lora.parse_args(["--sample-tokens", "4"]).sample_tokens == 4

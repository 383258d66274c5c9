"""The port's ``Supervisor``: its copies of the JAX package's fast
supervisor and chaos drills (``tests/test_supervisor.py``,
``tests/test_chaos.py``; plain-python workers, no device), then three
drills through the port's LeNet driver on the CPU (a crash, a hang, a torn
checkpoint), each a supervised gang of one whose relaunch resumes from the
newest verified step. The crash drill's final params are bitwise an
uninterrupted run's, and the JAX package's ``dlstatus`` reads the port's
stream, attempt timeline included."""

import io
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from distributeddeeplearningspark_tpu import status
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu_torch import supervisor as sup_lib
from distributeddeeplearningspark_tpu_torch.supervisor import (
    RESTORE_FAILED_EXIT,
    Supervisor,
    SupervisorResult,
)
from distributeddeeplearningspark_tpu_torch.utils.env import conf_to_env
from test_torch_deadline import per_test

ROOT = Path(__file__).resolve().parents[1]
MNIST = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_mnist.py"
CPU = conf_to_env({"spark.dls.device": "cpu"})


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _corrupt_dirs(path):
    return sorted(d for d in os.listdir(path) if re.match(r"\d+\.corrupt-\d+$", d))


def _attempt_ends(workdir):
    return {e["ordinal"]: e["classification"]
            for e in jtele.read_events(str(workdir))
            if e["kind"] == "attempt" and e.get("edge") == "end"}


def _recovery_events(workdir):
    return [e for e in jtele.read_events(str(workdir)) if e["kind"] == "recovery"]


# -- the fast drills (plain-python workers) ----------------------------------------


def test_supervisor_gives_up_after_max_restarts():
    result = Supervisor([sys.executable, "-c", "import sys; sys.exit(7)"],
                        num_processes=1, max_restarts=2,
                        restart_backoff_s=0.01).run()
    assert not result.ok and len(result.attempts) == 3
    assert all(a.returncodes == [7] for a in result.attempts)
    assert all(a.classification == "training-crash" for a in result.attempts)


def test_restart_backoff_grows_exponentially_with_cap():
    s = Supervisor(["true"], restart_backoff_s=0.5, restart_backoff_max_s=3.0,
                   backoff_jitter=0.0)
    assert [s._backoff_delay(i) for i in range(5)] == [0.5, 1.0, 2.0, 3.0, 3.0]
    j = Supervisor(["true"], restart_backoff_s=1.0, restart_backoff_max_s=8.0,
                   backoff_jitter=0.25)
    for i in range(4):
        base = min(1.0 * 2 ** i, 8.0)
        assert 0.75 * base <= j._backoff_delay(i) <= 1.25 * base


def _recorded_sleeps(monkeypatch) -> list:
    sleeps: list[float] = []
    real_sleep = sup_lib.time.sleep
    monkeypatch.setattr(sup_lib.time, "sleep",
                        lambda s: (sleeps.append(s), real_sleep(min(s, 0.01)))[1])
    return sleeps


def test_restart_backoff_timing_observed(monkeypatch):
    sleeps = _recorded_sleeps(monkeypatch)
    result = Supervisor([sys.executable, "-c", "import sys; sys.exit(7)"],
                        max_restarts=2, restart_backoff_s=0.15, backoff_jitter=0.0,
                        poll_interval=0.01).run()
    assert len(result.attempts) == 3
    assert [s for s in sleeps if s > 0.01] == [0.15, 0.3]


def test_backoff_resets_after_observed_progress(tmp_path, monkeypatch):
    script = tmp_path / "worker.py"
    script.write_text("import os, sys\n"
                      "open(os.path.join(os.environ['PROG'], 'touch'), 'w').write('x')\n"
                      "sys.exit(7)\n")
    prog = tmp_path / "prog"
    prog.mkdir()
    sleeps = _recorded_sleeps(monkeypatch)
    result = Supervisor([sys.executable, str(script)], max_restarts=2,
                        restart_backoff_s=0.15, backoff_jitter=0.0,
                        poll_interval=0.01, progress_path=str(prog),
                        env={"PROG": str(prog)}).run()
    assert len(result.attempts) == 3
    assert all(a.made_progress for a in result.attempts)
    assert [s for s in sleeps if s > 0.01] == [0.15, 0.15]


def test_shrink_to_survive_drops_dead_host(tmp_path):
    (tmp_path / "10").mkdir()
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys, time\n"
        "host = os.environ.get('DLS_HOST_ID', os.environ['DLS_PROCESS_ID'])\n"
        "if host == '1':\n"
        "    sys.exit(1)\n"
        "if os.environ['DLS_NUM_PROCESSES'] == '1':\n"
        "    with open(os.path.join(sys.argv[1], 'DONE'), 'w') as f:\n"
        "        f.write(os.environ['DLS_RESTART'] + ' ' + os.environ['DLS_HOST_ID'])\n"
        "    sys.exit(0)\n"
        "time.sleep(30)\n")
    result = Supervisor([sys.executable, str(script), str(tmp_path)],
                        num_processes=2, max_restarts=3, restart_backoff_s=0.01,
                        backoff_jitter=0.0, ckpt_dir=str(tmp_path),
                        shrink_after=2).run()
    assert result.ok, [(a.returncodes, a.classification) for a in result.attempts]
    assert [a.num_processes for a in result.attempts] == [2, 2, 1]
    assert [a.dead_host for a in result.attempts] == [1, 1, None]
    assert (tmp_path / "DONE").read_text().split() == ["2", "0"]
    geo = [e for e in _recovery_events(tmp_path) if e["event"] == "geometry_change"]
    assert len(geo) == 1
    assert geo[0]["dead_host"] == 1 and geo[0]["hosts"] == [0]
    assert (geo[0]["from_processes"], geo[0]["to_processes"]) == (2, 1)
    assert geo[0]["step"] == 10 and geo[0]["batch_policy"] == "preserve_global"


def test_shrink_respects_min_processes():
    result = Supervisor([sys.executable, "-c", "import sys; sys.exit(1)\n"],
                        num_processes=2, max_restarts=3, restart_backoff_s=0.01,
                        backoff_jitter=0.0, shrink_after=2, min_processes=2).run()
    assert not result.ok
    assert all(a.num_processes == 2 for a in result.attempts)


def test_result_shapes_and_startup_grace():
    r = SupervisorResult(attempts=[])
    assert not r.ok and r.restarts == 0
    assert Supervisor(["true"], hang_timeout_s=2.0).startup_grace_s == 10.0
    assert Supervisor(["true"], hang_timeout_s=2.0,
                      startup_grace_s=30.0).startup_grace_s == 30.0
    assert Supervisor(["true"]).startup_grace_s is None


def test_heartbeat_file_counts_as_progress(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text("import os, time\n"
                      "hb = os.environ['DLS_HEARTBEAT_FILE']\n"
                      "for _ in range(12):\n"
                      "    open(hb, 'w').write('x')\n"
                      "    time.sleep(0.2)\n")
    result = Supervisor([sys.executable, str(script)], num_processes=1,
                        max_restarts=0, hang_timeout_s=1.0, startup_grace_s=30.0,
                        progress_path=str(tmp_path / "ckpt-does-not-exist")).run()
    assert result.ok and result.attempts[0].returncodes == [0]


def test_restore_failure_falls_back_to_previous_step(tmp_path):
    for step, what in ((10, "good step"), (20, "poisoned step")):
        (tmp_path / str(step)).mkdir()
        (tmp_path / str(step) / "ok").write_text(what)
    script = ("import os, sys\n"
              "root = sys.argv[1]\n"
              "steps = sorted(int(d) for d in os.listdir(root) if d.isdigit())\n"
              f"if steps[-1] == 20: sys.exit({RESTORE_FAILED_EXIT})\n"
              "open(os.path.join(root, 'DONE'), 'w').write(str(steps[-1]))\n")
    result = Supervisor([sys.executable, "-c", script, str(tmp_path)],
                        num_processes=1, max_restarts=2, restart_backoff_s=0.01,
                        backoff_jitter=0.0, ckpt_dir=str(tmp_path)).run()
    assert result.ok and result.restarts == 1
    assert [a.classification for a in result.attempts] == ["restore-failure", "clean"]
    assert _corrupt_dirs(tmp_path) == ["20.corrupt-0"]
    assert (tmp_path / "DONE").read_text() == "10"
    assert _attempt_ends(tmp_path) == {0: "restore-failure", 1: "clean"}
    assert any(e["event"] == "restore-fallback" and e["step"] == 20
               for e in _recovery_events(tmp_path))


def test_restore_failure_without_fallback_burns_restarts(tmp_path):
    (tmp_path / "20").mkdir()
    result = Supervisor([sys.executable, "-c", f"import sys; sys.exit({RESTORE_FAILED_EXIT})"],
                        num_processes=1, max_restarts=2, restart_backoff_s=0.01,
                        backoff_jitter=0.0, ckpt_dir=str(tmp_path),
                        fallback_on_restore_failure=False).run()
    assert not result.ok
    assert [a.classification for a in result.attempts] == ["restore-failure"] * 3
    assert _corrupt_dirs(tmp_path) == []
    assert _attempt_ends(tmp_path) == {i: "restore-failure" for i in range(3)}


def test_drain_evidence_roundtrip_and_classification(tmp_path):
    assert sup_lib.read_drain_evidence(tmp_path) is None
    sup_lib.write_drain_evidence(tmp_path, host=1, step=9)
    assert sup_lib.read_drain_evidence(tmp_path) == (1, 9)
    sup = Supervisor([sys.executable, "-c", "pass"], num_processes=2,
                     ckpt_dir=str(tmp_path))
    assert sup._classify([0, 0], ordinal=0, hang=False,
                         made_progress=True) == "graceful-shutdown"
    assert sup._classify([0, -15], ordinal=0, hang=False,
                         made_progress=True) == "graceful-shutdown"
    assert not sup_lib.Attempt(ordinal=0, returncodes=[0, 0], duration_s=1.0,
                               classification="graceful-shutdown").ok
    sup_lib.consume_drain_evidence(tmp_path, ordinal=0)
    assert sup_lib.read_drain_evidence(tmp_path) is None
    assert (tmp_path / "DRAIN.consumed-0").exists()
    assert sup._classify([0, 0], ordinal=0, hang=False, made_progress=True) == "clean"


def test_workers_get_the_port_launch_contract_and_the_callers_conf(tmp_path):
    """The env contract of the port's cli, the conf the caller gave and
    nothing more: the supervisor never sets the device."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ['DLS_COORDINATOR', 'DLS_NUM_PROCESSES', 'DLS_PROCESS_ID',\n"
        "        'DLS_HOST_ID', 'DLS_RESTART', 'DLS_TELEMETRY_DIR', 'PYTHONPATH',\n"
        "        'OMP_NUM_THREADS']\n"
        "env = {k: os.environ.get(k) for k in keys}\n"
        "env['conf'] = sorted(k for k in os.environ if k.startswith('DLS_CONF_'))\n"
        "open(os.path.join(sys.argv[1], 'env' + env['DLS_PROCESS_ID']), 'w')"
        ".write(json.dumps(env))\n")
    for conf, want in (({}, []), ({"spark.dls.device": "cpu"},
                                  ["DLS_CONF_spark__dls__device"])):
        result = Supervisor([sys.executable, str(script), str(tmp_path)],
                            num_processes=2, max_restarts=0, env=conf_to_env(conf),
                            telemetry_dir=str(tmp_path / "wd")).run()
        assert result.ok
        envs = [json.loads((tmp_path / f"env{r}").read_text()) for r in (0, 1)]
        for r, env in enumerate(envs):
            assert env["DLS_PROCESS_ID"] == env["DLS_HOST_ID"] == str(r)
            assert env["DLS_NUM_PROCESSES"] == "2" and env["DLS_RESTART"] == "0"
            assert re.fullmatch(r"127\.0\.0\.1:\d+", env["DLS_COORDINATOR"])
            assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
            assert env["DLS_TELEMETRY_DIR"] == str(tmp_path / "wd")
            assert int(env["OMP_NUM_THREADS"]) >= 1
            assert [c for c in env["conf"] if "device" in c] == want


def test_a_kill_takes_the_workers_process_group(tmp_path):
    """A rank's own child (a forked input worker, a kernel build) dies with
    the gang: the failing rank's sibling sleeps in a child of its own."""
    pidfile = tmp_path / "child.pid"
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, subprocess, sys, time\n"
        "if os.environ['DLS_PROCESS_ID'] == '1':\n"
        "    time.sleep(0.5)\n"
        "    sys.exit(3)\n"
        "child = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
        f"open({str(pidfile)!r}, 'w').write(str(child.pid))\n"
        "time.sleep(60)\n")
    result = Supervisor([sys.executable, str(script)], num_processes=2,
                        max_restarts=0).run()
    assert not result.ok and result.attempts[0].dead_host == 1
    child = int(pidfile.read_text())

    def alive() -> bool:
        try:  # a zombie waits for its reaper; it holds nothing
            return "State:\tZ" not in Path(f"/proc/{child}/status").read_text()
        except OSError:
            return False

    deadline = time.monotonic() + 5.0  # a killed process takes a moment to exit
    while alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not alive()


# -- drills through the port's LeNet driver on the CPU ------------------------------

STEPS, EVERY = 12, 4


def _mnist_argv(ckpt: Path, *extra: str) -> list[str]:
    return [sys.executable, str(MNIST), "--steps", str(STEPS), "--batch-size", "32",
            "--log-every", "1", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", str(EVERY), "--resume", *extra]


def _final_params(ckpt: Path) -> dict:
    saved = torch.load(ckpt / str(STEPS) / "state.pt", map_location="cpu",
                       weights_only=True)
    return saved["params"]


def _run(workdir: Path, fault: str | None, **kw) -> "SupervisorResult":
    sup = Supervisor(_mnist_argv(workdir / "ckpt"), num_processes=1, max_restarts=2,
                     restart_backoff_s=0.05,
                     env={**CPU, **({"DLS_FAULT": fault} if fault else {})}, ckpt_dir=str(workdir / "ckpt"),
                     progress_path=str(workdir / "ckpt"),
                     telemetry_dir=str(workdir), **kw)
    return sup.run()


@pytest.fixture(autouse=True)
def _no_inherited_fault(monkeypatch):
    for name in ("DLS_FAULT", "DLS_RESTART", "DLS_FAULT_ALL_ATTEMPTS",
                 "DLS_TELEMETRY_DIR", "DLS_FAULT_RANK"):
        monkeypatch.delenv(name, raising=False)


def test_crash_drill_resumes_bitwise_and_dlstatus_reads_the_timeline(tmp_path):
    crashed = _run(tmp_path / "crash", "crash@8")
    assert crashed.ok, [(a.returncodes, a.classification) for a in crashed.attempts]
    assert [a.classification for a in crashed.attempts] == ["training-crash", "clean"]
    assert crashed.attempts[0].returncodes == [-9]
    straight = _run(tmp_path / "straight", None)
    assert straight.ok and len(straight.attempts) == 1
    got, want = _final_params(tmp_path / "crash" / "ckpt"), \
        _final_params(tmp_path / "straight" / "ckpt")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert _attempt_ends(tmp_path / "crash") == {0: "training-crash", 1: "clean"}
    assert any(e["event"] == "restart" and e["classification"] == "training-crash"
               for e in _recovery_events(tmp_path / "crash"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = status.main([str(tmp_path / "crash")])
    assert rc == 0
    text = out.getvalue()
    assert "attempts" in text and "training-crash" in text and "clean" in text


def test_hang_drill_is_killed_classified_and_relaunched(tmp_path):
    hung = _run(tmp_path, "hang@6", hang_timeout_s=5.0, startup_grace_s=120.0)
    assert hung.ok, [(a.returncodes, a.classification) for a in hung.attempts]
    assert [a.classification for a in hung.attempts] == ["hang", "clean"]
    assert _attempt_ends(tmp_path) == {0: "hang", 1: "clean"}
    assert (tmp_path / "ckpt" / str(STEPS)).is_dir()


def test_truncate_drill_walks_back_past_the_torn_step(tmp_path):
    torn = _run(tmp_path, "truncate_ckpt@8")
    assert torn.ok, [(a.returncodes, a.classification) for a in torn.attempts]
    assert [a.classification for a in torn.attempts] == ["training-crash", "clean"]
    assert torn.attempts[0].returncodes == [-9]
    assert _corrupt_dirs(tmp_path / "ckpt") == ["8.corrupt-0"]
    assert any(e["event"] == "quarantine" and e["step"] == 8
               for e in _recovery_events(tmp_path))
    assert (tmp_path / "ckpt" / str(STEPS)).is_dir()


def test_supervised_driver_without_conf_takes_the_card(tmp_path):
    """No conf: the worker asks for CUDA and, on a machine without it,
    fails; the supervisor does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA failure needs a machine without CUDA")
    result = Supervisor([sys.executable, str(MNIST), "--steps", "1"],
                        num_processes=1, max_restarts=0).run()
    assert not result.ok and result.attempts[0].returncodes != [0]


def test_module_entry_point_runs_a_supervised_gang(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.supervisor",
         "-n", "2", "--max-restarts", "0", "--conf", "spark.dls.device=cpu",
         "--telemetry-dir", str(tmp_path), "--", sys.executable, "-c",
         "import os; assert os.environ['DLS_CONF_spark__dls__device'] == 'cpu'"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert _attempt_ends(tmp_path) == {0: "clean"}

"""The port's launcher and the Session's launch contract on the CPU.

Three gangs of 2 gloo processes run the port's ``examples/train_mnist.py``
through ``python -m distributeddeeplearningspark_tpu_torch.cli --master
local[2]``: 80 steps with checkpoints, a ``--resume`` to 120 (accuracy
above 0.9, as ``tests/test_train_mnist.py`` asks of JAX at 120 steps), and
120 straight steps, whose checkpoint the resumed run matches bit for bit;
the JAX package's ``dlstatus`` reads the run's workdir, checkpoint phases
included. A fourth gang has a rank that raises: the launcher exits
non-zero and leaves no process alive. The rest runs in this process: a
malformed ``DLS_*`` env, ``local[2]`` without the launcher, the launch
conf, and the launcher's pieces.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from distributeddeeplearningspark_tpu_torch import Session
from distributeddeeplearningspark_tpu_torch import checkpoint as tcheckpoint
from distributeddeeplearningspark_tpu_torch import cli
from distributeddeeplearningspark_tpu_torch.session import DETERMINISTIC_CONF, DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.utils import env as tenv
from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_mnist.py"
GANG_DEADLINE_S = 240
LAUNCH_ENV = (tenv.COORDINATOR_ENV, tenv.NUM_PROCESSES_ENV, tenv.PROCESS_ID_ENV)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def run_gang(args: list[str], *, deadline_s: float = GANG_DEADLINE_S
             ) -> subprocess.CompletedProcess:
    """The port's cli in a subprocess, bounded: past the deadline the
    launcher is terminated (it stops its ranks), then killed, and the test
    fails."""
    cmd = [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.cli", *args]
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=15)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        pytest.fail(f"gang {args} passed its {deadline_s} s deadline")
    except BaseException:  # the test's own deadline: never leave the gang
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _example(workdir: Path, *args: str) -> dict:
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    "--workdir", str(workdir), "--tenant", "research",
                    str(EXAMPLE), "--checkpoint-dir", str(workdir / "ckpt"),
                    "--checkpoint-every", "40", *args])
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [line for line in res.stdout.splitlines() if line.startswith('{"train"')]
    assert len(lines) == 1, res.stdout[-2000:]  # rank 0 prints, rank 1 does not
    return json.loads(lines[0])


@pytest.fixture(scope="module")
@bounded()
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    first = _example(root / "split", "--steps", "80")
    resumed = _example(root / "split", "--steps", "120", "--resume")
    straight = _example(root / "straight", "--steps", "120")
    return root, first, resumed, straight


def test_example_trains_over_two_gloo_processes(runs):
    _, first, resumed, straight = runs
    for res in (first, resumed, straight):
        assert res["world_size"] == 2 and res["backend"] == "gloo"
        assert res["device"] == "cpu"
    assert first["step"] == 80 and first["grad_allreduces"] == 80
    assert resumed["test"]["accuracy"] > 0.9, resumed["test"]
    assert straight["test"]["accuracy"] > 0.9, straight["test"]


def test_resume_restores_the_step_and_the_feed_position(runs):
    _, _, resumed, _ = runs
    assert resumed["restored_step"] == 80
    assert resumed["data_state"] == {"examples_seen": 80 * 64, "batch_size": 64}
    assert resumed["step"] == 120 and resumed["grad_allreduces"] == 40


def test_resumed_gang_equals_uninterrupted_gang_bitwise(runs):
    root, *_ = runs
    split, straight = (torch.load(root / d / "ckpt" / "120" / tcheckpoint.STATE_FILE,
                                  weights_only=True) for d in ("split", "straight"))
    assert split["step"] == straight["step"] == 120
    for k, v in straight["params"].items():
        assert torch.equal(split["params"][k], v), k
    for a, b in zip(split["opt_state"], straight["opt_state"]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_checkpoints_verify_in_both_packages(runs):
    from distributeddeeplearningspark_tpu import checkpoint as jcheckpoint

    root, *_ = runs
    ckpt = tcheckpoint.Checkpointer(root / "split" / "ckpt")
    assert ckpt.all_steps() == [40, 80, 120]
    for step in ckpt.all_steps():
        step_dir = str(root / "split" / "ckpt" / str(step))
        assert ckpt.verify(step)
        assert jcheckpoint.verify_step_dir(step_dir) == (True, "manifest verified")


def test_dlstatus_reads_a_port_gang(runs):
    """The JAX package's dlstatus folds both ranks' streams: the last step,
    goodput with the checkpoint and restore phases, and exits 0."""
    from distributeddeeplearningspark_tpu import status
    from distributeddeeplearningspark_tpu import telemetry as jtele

    root, *_ = runs
    workdir = str(root / "split")
    rep = status.report(workdir)
    assert [os.path.basename(f) for f in rep["event_files"]] == [
        "events-p0.jsonl", "events-p1.jsonl"]
    assert rep["last_step"] == 120
    goodput = rep["goodput"]
    assert goodput["checkpoint_s"] > 0 and goodput["restore_s"] > 0
    assert goodput["productive_s"] > 0
    events = jtele.read_events(workdir)
    assert {e["hosts"] for e in events} == {2}
    assert {e["tenant"] for e in events} == {"research"}
    saves = [e["step"] for e in events if e["kind"] == "phase"
             and e["name"] == "checkpoint" and e["edge"] == "end"]
    assert saves == [40, 80, 120]  # rank 0 writes
    assert status.main([workdir]) == 0


FAILING_RANK = textwrap.dedent("""
    import os, subprocess, sys, time
    from pathlib import Path
    from distributeddeeplearningspark_tpu_torch import Session

    out = Path(sys.argv[1])
    spark = Session.builder.getOrCreate()
    if spark.rank == 1:
        (out / "pid1").write_text(str(os.getpid()))
        raise RuntimeError("rank 1 fails")
    child = subprocess.Popen(["sleep", "600"])
    (out / "pid0").write_text(f"{os.getpid()} {child.pid}")
    time.sleep(600)
""")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    stat = Path(f"/proc/{pid}/stat")
    return not (stat.exists() and stat.read_text().split(") ")[1].startswith("Z"))


def test_failing_rank_fails_the_launch_and_stops_the_gang(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(FAILING_RANK)
    t0 = time.monotonic()
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(script), str(tmp_path)], deadline_s=120)
    assert res.returncode == 1, (res.returncode, res.stderr[-2000:])
    assert "rank 1 fails" in res.stderr
    assert time.monotonic() - t0 < 100
    pids = [int(p) for p in (tmp_path / "pid0").read_text().split()]
    pids.append(int((tmp_path / "pid1").read_text()))
    assert not [p for p in pids if _alive(p)]


@pytest.fixture
def clean_env(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    for name in list(os.environ):
        if name.startswith(tenv.CONF_ENV_PREFIX):
            monkeypatch.delenv(name)
    return monkeypatch


@pytest.mark.parametrize("env,match", [
    ({"DLS_COORDINATOR": "127.0.0.1:1", "DLS_NUM_PROCESSES": "two",
      "DLS_PROCESS_ID": "0"}, "integers"),
    ({"DLS_COORDINATOR": "127.0.0.1:1", "DLS_NUM_PROCESSES": "2",
      "DLS_PROCESS_ID": "2"}, "rank 2 of world 2"),
    ({"DLS_COORDINATOR": "127.0.0.1", "DLS_NUM_PROCESSES": "2",
      "DLS_PROCESS_ID": "0"}, "host:port"),
    ({"DLS_COORDINATOR": "127.0.0.1:1"}, "incomplete"),
    ({"DLS_NUM_PROCESSES": "2", "DLS_PROCESS_ID": "0"}, "incomplete"),
    ({"DLS_COORDINATOR": "127.0.0.1:1", "DLS_NUM_PROCESSES": "0",
      "DLS_PROCESS_ID": "0"}, "rank 0 of world 0"),
])
def test_malformed_launch_env_raises(clean_env, env, match):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        tenv.distributed_env()
    with pytest.raises(ValueError, match=match):
        Session.builder.master("local[2]").config(DEVICE_CONF, "cpu").getOrCreate()
    assert Session._active is None
    # telemetry's reader stays lenient: a crashed worker's last event is kept
    assert tenv.process_identity()[1] >= 1


def test_local2_without_the_launcher_raises(clean_env):
    assert tenv.distributed_env() is None
    with pytest.raises(ValueError, match="cli"):
        Session.builder.master("local[2]").config(DEVICE_CONF, "cpu").getOrCreate()
    with pytest.raises(ValueError, match="cli"):
        Session.builder.config("spark.executor.instances", "3").config(
            DEVICE_CONF, "cpu").getOrCreate()


def test_launch_conf_reaches_the_session_and_the_builder_wins(clean_env):
    for k, v in tenv.conf_to_env({"spark.app.name": "from-launch",
                                  "spark.master": "local[1]",
                                  DEVICE_CONF: "cpu", "my.key": "x"}).items():
        clean_env.setenv(k, v)
    assert tenv.conf_from_env()["my.key"] == "x"
    with Session.builder.appName("mine").getOrCreate() as spark:
        assert spark.app_name == "mine" and spark.conf["my.key"] == "x"
        assert spark.rank == 0 and spark.world_size == 1
        assert not spark.distributed and spark.backend is None


def test_world_that_disagrees_with_the_master_raises(clean_env):
    clean_env.setenv(tenv.COORDINATOR_ENV, "127.0.0.1:1")
    clean_env.setenv(tenv.NUM_PROCESSES_ENV, "2")
    clean_env.setenv(tenv.PROCESS_ID_ENV, "0")
    with pytest.raises(ValueError, match="started 2 processes"):
        Session.builder.master("local[3]").config(DEVICE_CONF, "cpu").getOrCreate()


def test_deterministic_conf_is_restored_on_stop(clean_env):
    before = torch.are_deterministic_algorithms_enabled()
    with Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").config(
            DETERMINISTIC_CONF, "true").getOrCreate():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.benchmark
    assert torch.are_deterministic_algorithms_enabled() == before


@pytest.mark.parametrize("argv,want", [
    (["--master", "local[3]"], 3),
    (["--master", "local[2]", "--num-executors", "4"], 4),
    (["--master", "local[*]", "--conf", f"{DEVICE_CONF}=cpu"], 1),
    (["--conf", "mesh.data=2", "--conf", f"{DEVICE_CONF}=cpu"], 2),
])
def test_launcher_counts_ranks(argv, want):
    args = cli.build_parser().parse_args([*argv, "x.py"])
    assert cli.num_processes(cli.parse_conf(args)) == want


def test_launcher_refuses_what_it_cannot_start(tmp_path):
    # the pipeline beside seq still refuses, naming its ROADMAP item
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        cli.num_processes({"spark.master": "local[2]", "mesh.seq": "2", "mesh.pipe": "2"})
    # data × fsdp (HSDP) and data × seq are ported: local[2] at fsdp=2 or at
    # seq=2 is four processes,
    assert cli.num_processes({"spark.master": "local[2]", "mesh.fsdp": "2"}) == 4
    assert cli.num_processes({"spark.master": "local[2]", "mesh.seq": "2"}) == 4
    # and so are expert and pipe: local[2] at expert=2 or at pipe=2 is four
    # processes (pipe counts like the other axes); pipe beside expert still
    # refuses
    assert cli.num_processes({"spark.master": "local[2]", "mesh.expert": "2"}) == 4
    assert cli.num_processes({"spark.master": "local[2]", "mesh.pipe": "2"}) == 4
    assert cli.num_processes({"spark.master": "local[1]", "mesh.pipe": "2",
                              "mesh.tensor": "2"}) == 4
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        cli.num_processes({"spark.master": "local[2]", "mesh.expert": "2",
                           "mesh.pipe": "2"})
    with pytest.raises(SystemExit, match="KEY=VALUE"):
        cli.parse_conf(cli.build_parser().parse_args(["--conf", "nokey", "x.py"]))
    with pytest.raises(SystemExit, match="script not found"):
        cli.main(["--master", "local[1]", str(tmp_path / "missing.py")])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA sees none"):
            cli.num_processes({"spark.master": "local[*]"})


def test_child_env_carries_the_launch_contract(clean_env):
    clean_env.delenv("OMP_NUM_THREADS", raising=False)
    args = cli.build_parser().parse_args(
        ["--master", "local[2]", "--name", "app", "--workdir", "wd", "--tenant", "t",
         "--priority", "3", "x.py"])
    env = cli.child_env(cli.parse_conf(args), args, world=2, rank=1, port=1234)
    assert env["DLS_COORDINATOR"] == "127.0.0.1:1234"
    assert env["DLS_NUM_PROCESSES"] == "2" and env["DLS_PROCESS_ID"] == "1"
    assert env["DLS_CONF_spark__master"] == "local[2]"
    assert env["DLS_CONF_spark__app__name"] == "app"
    assert env["DLS_TELEMETRY_DIR"] == os.path.abspath("wd")
    assert env["DLS_TENANT"] == "t" and env["DLS_PRIORITY"] == "3"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert int(env["OMP_NUM_THREADS"]) == max(1, (os.cpu_count() or 1) // 2)
    clean_env.setenv("OMP_NUM_THREADS", "5")
    assert cli.child_env({}, args, world=2, rank=0, port=1)["OMP_NUM_THREADS"] == "5"
    assert 0 < cli.free_port() < 65536

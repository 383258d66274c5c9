"""The MPMD pipeline's drills: stage processes under the port's
``PipelineSupervisor``, the built-in stage worker on the CPU (the spec's
``"device": "cpu"``), the tiny Llama (4 layers, f32), 2 stages.

- **The kill drill** (JAX's ``test_pipeline_supervisor_stage_kill_drill``):
  ``DLS_FAULT=die_host@5`` on stage 1, a checkpoint every 2 steps, 6 steps.
  Only stage 1 restarts (``stage-crash``, then ``clean``; stage 0 one
  ``clean`` attempt); the supervisor records ``stage-restart`` for stage 1
  and stage 0 a ``pipeline-resync``; the losses, and each stage's final
  params (their summaries' digests), are bitwise those of the clean run;
  the port's ``status.report(workdir, traces=True)["pipeline"]``
  is filled in.
- **A survivor held in ``connect``** longer than the hang watchdog's
  timeout (stage 1 starts :data:`HOLD_S` late, stamping its own heartbeat
  while it waits) is not killed as a hang: stage 0 stamps its heartbeat
  while it waits for its peer.
- **The stage worker beats while it imports**: the watchdog times a stage
  from its launch to its first heartbeat, so the worker stamps it before
  it imports torch and from a thread while the imports run (on a loaded
  host they outlast the timeout, which made the test above unsteady).
"""

import json
import os
import sys

import numpy as np
import pytest

from distributeddeeplearningspark_tpu_torch import status, telemetry
from distributeddeeplearningspark_tpu_torch.supervisor import (
    PipelineSupervisor,
    StagePlan,
)

from test_torch_deadline import per_test

SPEC = {"steps": 6, "batch_size": 8, "microbatches": 4, "seq": 32,
        "checkpoint_every": 2, "seed": 0, "mode": "exact", "device": "cpu"}
#: one intra-op thread a stage: two stages' OpenMP pools spinning against
#: each other on a shared CPU make a tiny step ~10x slower
BASE_ENV = {"DLS_PIPE_SPEC": json.dumps(SPEC), "OMP_NUM_THREADS": "1"}
#: the watchdog's timeout, and how long the late stage keeps stage 0 waiting
#: in connect (past the timeout, and past a stage's start under load)
HANG_TIMEOUT_S, HOLD_S = 12.0, 24.0


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _supervised(wd: str, env: dict, stages: list[StagePlan] | None = None,
                **kw) -> tuple:
    sup = PipelineSupervisor(stages or [StagePlan(), StagePlan()], env=env,
                             telemetry_dir=wd, wall_timeout_s=200,
                             restart_backoff_s=0.1, **kw)
    res = sup.run()
    assert res.ok, {k: [(a.returncodes, a.classification) for a in v]
                    for k, v in res.attempts.items()}
    with open(os.path.join(wd, "DONE")) as f:
        return res, json.load(f)


def test_pipeline_supervisor_stage_kill_drill(tmp_path):
    _, clean = _supervised(str(tmp_path / "clean"), dict(BASE_ENV))
    wd = str(tmp_path / "fault")
    res, faulted = _supervised(wd, {**BASE_ENV, "DLS_FAULT": "die_host@5",
                                    "DLS_FAULT_HOST": "1", "DLS_FAULT_ONCE": "1"})
    assert res.restarts_of(1) == 1 and res.restarts_of(0) == 0, \
        {k: len(v) for k, v in res.attempts.items()}
    assert faulted["step"] == clean["step"] == 6
    assert [np.float32(x).tobytes() for x in clean["losses"]] == \
        [np.float32(x).tobytes() for x in faulted["losses"]]
    events = telemetry.read_events(wd)
    rec = [(e.get("event"), e.get("stage")) for e in events
           if e.get("kind") == "recovery"]
    assert ("stage-restart", 1) in rec, rec
    assert ("pipeline-resync", 0) in rec, rec  # the survivor resynced
    ends = [(e.get("stage"), e.get("classification")) for e in events
            if e.get("kind") == "attempt" and e.get("edge") == "end"]
    assert sorted(ends) == [(0, "clean"), (1, "clean"), (1, "stage-crash")], ends
    # the restarted stage restored its own step-4 checkpoint: it reports
    # the whole run from its second attempt
    with open(os.path.join(wd, "stage1", "summary-1.json")) as f:
        again = json.load(f)
    assert again["step"] == 6 and again["attempt"] == 1
    for k, attempt in ((0, 0), (1, 1)):
        with open(os.path.join(tmp_path, "clean", f"stage{k}", "summary-0.json")) as f:
            want = json.load(f)["param_digests"]
        with open(os.path.join(wd, f"stage{k}", f"summary-{attempt}.json")) as f:
            assert json.load(f)["param_digests"] == want, k
    pl = status.report(wd, traces=True)["pipeline"]
    assert pl and pl["p"] == 2 and pl["m"] == 4 and pl["measured_bubble_frac"] is not None


def test_survivor_waiting_in_connect_is_not_a_hang(tmp_path):
    """Stage 1 begins HOLD_S late (its own stand-in stamping its heartbeat,
    then the worker); stage 0 waits in connect all that while, longer than
    the watchdog's HANG_TIMEOUT_S, and must not be killed as hung."""
    late = (f"import os, sys, time\n"
            f"t = time.time()\n"
            f"while time.time() - t < {HOLD_S}:\n"
            f"    open(os.environ['DLS_HEARTBEAT_FILE'], 'w').close()\n"
            f"    time.sleep(0.5)\n"
            f"os.execv(sys.executable, [sys.executable, '-m', "
            f"'distributeddeeplearningspark_tpu_torch.train.pipeline_trainer'])\n")
    spec = {**SPEC, "steps": 2, "checkpoint_every": None}
    wd = str(tmp_path / "late")
    res, done = _supervised(
        wd, {**BASE_ENV, "DLS_PIPE_SPEC": json.dumps(spec)},
        [StagePlan(), StagePlan(argv=[sys.executable, "-c", late])],
        hang_timeout_s=HANG_TIMEOUT_S, max_restarts=0)
    assert done["step"] == 2
    assert [len(res.attempts[k]) for k in (0, 1)] == [1, 1]
    assert res.attempts[0][0].duration_s > HOLD_S > HANG_TIMEOUT_S


#: a stage worker under a stand-in for a loaded host: its import of torch
#: stalls STALL_S (past several of the boot beat's periods), and it records
#: whether its heartbeat was stamped before that import and again during it
_SLOW_IMPORT = """
import importlib.abc, os, runpy, sys, time
hb, out = os.environ["DLS_HEARTBEAT_FILE"], os.environ["PROBE_OUT"]

class SlowTorch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "torch":
            sys.meta_path.remove(self)
            mtime = lambda: os.stat(hb).st_mtime if os.path.exists(hb) else None
            before = mtime()
            time.sleep({stall})
            with open(out, "w") as f:
                f.write(repr((before, mtime())))
        return None

sys.meta_path.insert(0, SlowTorch())
runpy.run_module("distributeddeeplearningspark_tpu_torch.train.pipeline_trainer",
                 run_name="__main__", alter_sys=True)
"""


def test_stage_worker_beats_while_it_imports(tmp_path):
    """The cause of a stage taken for hung on a loaded host: the watchdog
    times a stage from its launch to its first heartbeat, and the worker
    (``python -m ...pipeline_trainer``, the late stage's ``execv`` too)
    stamped it only in ``stage_main``, after seconds of imports. The worker
    stamps it before it imports torch and goes on stamping while the import
    stalls."""
    import subprocess

    stall = 3.5
    hb, out = tmp_path / "hb", tmp_path / "probe"
    env = {k: v for k, v in os.environ.items() if k != "DLS_PIPE_SPEC"}
    env.update(DLS_HEARTBEAT_FILE=str(hb), PROBE_OUT=str(out),
               PYTHONPATH=os.pathsep.join(filter(None, [
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   env.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", _SLOW_IMPORT.format(stall=stall)],
                          env=env, capture_output=True, text=True, timeout=120)
    # no spec in the env: stage_main stops at it, after the imports
    assert proc.returncode != 0 and "DLS_PIPE_SPEC" in proc.stderr, proc.stderr[-2000:]
    before, during = eval(out.read_text())
    assert before is not None, "no heartbeat before the worker imported torch"
    assert during - before >= stall - 1.5, (before, during)

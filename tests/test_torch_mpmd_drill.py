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

"""MPMD pipeline training end to end: N stage processes, one supervisor.

The port of ``examples/train_llama_mpmd.py``. Launches a pipeline of
independent stage processes (:mod:`..train.pipeline_trainer`'s built-in
worker, one card each: stage k sees card k of the visible ones through
``CUDA_VISIBLE_DEVICES``) training the built-in tiny Llama over the socket
transport, supervised with stage-scoped restart
(:class:`..supervisor.PipelineSupervisor`). Prints ONE summary JSON line
with the loss trajectory, the measured bubble fraction against the
(P−1)/(M+P−1) bound from the run's own trace spans (the port's
``status.report(traces=True)``), and per-stage restart counts::

    python -m distributeddeeplearningspark_tpu_torch.examples.train_llama_mpmd \\
        --steps 8 --microbatches 4
    ... --kill-stage 1 --kill-at 5       # drill: only stage 1 restarts
    ... --device cpu                     # every stage on the CPU

A stage of the port is one card: ``--devices-per-stage`` other than 1 is
refused (ROADMAP Queue 1 item 7, multi-card stages).
"""

import argparse
import json
import os
import sys
import tempfile

from distributeddeeplearningspark_tpu_torch.parallel import plan as plan_lib
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--devices-per-stage", type=int, default=1)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--mode", choices=["exact", "sharded"], default="exact")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every stage runs (the card unless asked)")
    ap.add_argument("--workdir", default=None,
                    help="run directory (telemetry + per-stage checkpoints); "
                         "default: a fresh temp dir")
    ap.add_argument("--kill-stage", type=int, default=None,
                    help="chaos drill: DLS_FAULT=die_host targeted at this "
                         "stage (only it should restart)")
    ap.add_argument("--kill-at", type=int, default=5,
                    help="--kill-stage fires before this 1-based step")
    ap.add_argument("--max-restarts", type=int, default=3)
    args = ap.parse_args(argv)
    if args.devices_per_stage != 1:
        ap.error(f"--devices-per-stage {args.devices_per_stage}: a stage is one "
                 f"card; {plan_lib.MULTI_CARD_STAGES}")
    return args


def _card_envs(stages: int) -> list[dict[str, str]]:
    """Each stage's ``CUDA_VISIBLE_DEVICES``: card k of the visible ones
    (round robin when there are fewer cards than stages)."""
    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c for c in visible.split(",") if c.strip()] if visible
             else [str(i) for i in range(torch.cuda.device_count())])
    return [{"CUDA_VISIBLE_DEVICES": cards[k % len(cards)]} for k in range(stages)]


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise here

    from distributeddeeplearningspark_tpu_torch import status, telemetry
    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    workdir = args.workdir or tempfile.mkdtemp(prefix="dls_mpmd_")
    spec = {
        "steps": args.steps, "batch_size": args.batch_size,
        "seq": args.seq, "microbatches": args.microbatches,
        "checkpoint_every": args.checkpoint_every, "seed": 0,
        "mode": args.mode, "device": args.device,
    }
    env = {"DLS_PIPE_SPEC": json.dumps(spec)}
    if args.kill_stage is not None:
        env.update({"DLS_FAULT": f"die_host@{args.kill_at}",
                    "DLS_FAULT_HOST": str(args.kill_stage),
                    "DLS_FAULT_ONCE": "1"})
    stage_envs = (_card_envs(args.stages) if args.device == "cuda"
                  else [{} for _ in range(args.stages)])
    sup = PipelineSupervisor(
        [StagePlan(env=e) for e in stage_envs], env=env,
        telemetry_dir=workdir, max_restarts=args.max_restarts,
        restart_backoff_s=0.1, wall_timeout_s=1800)
    result = sup.run()
    restarts = {str(s): result.restarts_of(s) for s in range(args.stages)}
    done = {}
    done_path = os.path.join(workdir, "DONE")
    if os.path.exists(done_path):
        with open(done_path) as f:
            done = json.load(f)
    rep = status.report(workdir, traces=True,
                        events=telemetry.read_events(workdir))
    pl = rep.get("pipeline") or {}
    record = {
        "metric": "mpmd_pipeline_final_loss",
        "value": (done.get("losses") or [None])[-1],
        "unit": "loss",
        "extra": {
            "ok": result.ok,
            "workdir": workdir,
            "stages": args.stages,
            "microbatches": args.microbatches,
            "mode": args.mode,
            "device": args.device,
            "final_step": done.get("step"),
            "losses": done.get("losses"),
            "restarts_per_stage": restarts,
            "pipeline_bubble_frac": pl.get("measured_bubble_frac"),
            "theoretical_bubble_frac": pl.get("theoretical_bubble_frac"),
            "microbatch_traces": pl.get("microbatch_traces"),
        },
    }
    print(json.dumps(record))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""MPMD pipeline training end to end: N stage processes, one supervisor.

The port of ``examples/train_llama_mpmd.py``. Launches a pipeline of
independent stage gangs (:mod:`..train.pipeline_trainer`'s built-in
worker, one process a card: stage k of n cards a stage sees cards k·n …
k·n+n−1 of the visible ones through ``CUDA_VISIBLE_DEVICES``, its mesh
``{"data": n}`` as JAX's driver lays it) training the built-in tiny Llama
over the socket transport, supervised with stage-scoped restart
(:class:`..supervisor.PipelineSupervisor`). Prints ONE summary JSON line
with the loss trajectory, the measured bubble fraction against the
(P−1)/(M+P−1) bound from the run's own trace spans (the port's
``status.report(traces=True)``), and per-stage restart counts::

    python -m distributeddeeplearningspark_tpu_torch.examples.train_llama_mpmd \\
        --steps 8 --microbatches 4
    ... --kill-stage 1 --kill-at 5       # drill: only stage 1's gang restarts
    ... --device cpu                     # n gloo processes a stage on the CPU
    ... --devices-per-stage 1            # one card (one process) a stage
"""

import argparse
import json
import os
import sys
import tempfile

from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--devices-per-stage", type=int, default=2)
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
    if args.devices_per_stage < 1:
        ap.error(f"--devices-per-stage {args.devices_per_stage}: at least 1")
    return args


def _card_envs(stages: int, per_stage: int = 1,
               visible: list[str] | None = None) -> list[dict[str, str]]:
    """Each stage's ``CUDA_VISIBLE_DEVICES``: stage k takes cards
    k·n … k·n+n−1 of the visible ones (``visible``, else the environment's
    or every card's); fewer cards than stages × n raise (two ranks would
    share a card)."""
    if visible is None:
        env = os.environ.get("CUDA_VISIBLE_DEVICES")
        if env is not None:
            visible = [c for c in env.split(",") if c.strip()]
        else:
            import torch

            visible = [str(i) for i in range(torch.cuda.device_count())]
    need = stages * per_stage
    if len(visible) < need:
        raise ValueError(f"{stages} stages of {per_stage} card(s) need {need} "
                         f"cards, {len(visible)} visible")
    return [{"CUDA_VISIBLE_DEVICES": ",".join(visible[k * per_stage:(k + 1) * per_stage])}
            for k in range(stages)]


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
        "mesh": {"data": args.devices_per_stage},
    }
    env = {"DLS_PIPE_SPEC": json.dumps(spec)}
    if args.kill_stage is not None:
        env.update({"DLS_FAULT": f"die_host@{args.kill_at}",
                    "DLS_FAULT_HOST": str(args.kill_stage),
                    "DLS_FAULT_ONCE": "1"})
    stage_envs = (_card_envs(args.stages, args.devices_per_stage)
                  if args.device == "cuda" else [{} for _ in range(args.stages)])
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
            "devices_per_stage": args.devices_per_stage,
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

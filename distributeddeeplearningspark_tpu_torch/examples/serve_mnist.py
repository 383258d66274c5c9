"""End-to-end serving example: train LeNet-5 a few steps, serve it hot — the
port of the repository's ``examples/serve_mnist.py``.

1. train a LeNet-5 for a few steps (config 1's setup, synthetic MNIST) and
   checkpoint it;
2. start the dynamic-batching engine in process on the trained params;
3. fire concurrent synthetic clients through it (and, for comparison,
   through an engine held to single-request batches);
4. mid-traffic, save a NEWER checkpoint and let the hot reloader swap it
   in, with zero dropped requests;
5. print a latency/throughput summary (one JSON line).

On the card by default; ``--device cpu`` runs it on the CPU::

    python distributeddeeplearningspark_tpu_torch/examples/serve_mnist.py \\
        --steps 8 --clients 16 --requests 4
"""

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np

from distributeddeeplearningspark_tpu_torch import Checkpointer, LeNet5, Session, Trainer
from distributeddeeplearningspark_tpu_torch.data.sources import synthetic_mnist
from distributeddeeplearningspark_tpu_torch.serve import HotReloader, InferenceEngine
from distributeddeeplearningspark_tpu_torch.serve.cli import _pct, run_load
from distributeddeeplearningspark_tpu_torch.train import losses, optim


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default="local[1]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=4, help="requests per client")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--workdir", default=None,
                   help="checkpoint + telemetry dir (default: a tmp dir)")
    args = p.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="serve_mnist_")

    # -- 1. train a few steps (train_mnist's setup) ---------------------------
    spark = (Session.builder.master(args.master).appName("serve-mnist")
             .config("spark.dls.device", args.device).getOrCreate())
    ds = synthetic_mnist(2048, num_partitions=spark.default_parallelism, seed=0)
    model = LeNet5(device=spark.device)
    with Checkpointer(workdir, async_save=False) as ckpt:
        trainer = Trainer(spark, model, losses.softmax_xent,
                          optim.sgd(0.05, momentum=0.9), checkpointer=ckpt)
        trainer.fit(ds.repeat(), batch_size=args.batch_size, steps=args.steps,
                    log_every=args.steps, checkpoint_every=args.steps)

        # -- 2. serve the trained checkpoint ----------------------------------
        params, step = ckpt.restore_params()
        print(f"serving checkpoint step {step}", file=sys.stderr)
        rng = np.random.default_rng(1)

        def example(i: int):
            return {"image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32)}

        engine = InferenceEngine.for_model(
            model, params, device=spark.device, max_batch=args.max_batch,
            max_wait_ms=5.0, max_queue=4096, workdir=workdir, name="lenet")
        with engine:
            engine.warmup(example(0))

            # -- 4. the hot-reload drill: a newer checkpoint lands mid-traffic
            trainer.fit(ds.repeat(), batch_size=args.batch_size,
                        steps=args.steps * 2, log_every=args.steps,
                        checkpoint_every=args.steps)
            reloader = HotReloader(engine, workdir, current_step=step)

            # the reload must land MID-traffic to mean anything: a helper
            # thread waits until the engine has requests queued, then polls
            # once, so the swap races real batches
            def reload_when_traffic_flows():
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if engine.stats()["queue_depth"]:
                        break
                    time.sleep(0.001)
                reloader.poll()

            swapper = threading.Thread(target=reload_when_traffic_flows)
            swapper.start()
            try:
                # -- 3. concurrent load -------------------------------------
                lat, shed, wall = run_load(engine, example, clients=args.clients,
                                           requests_per_client=args.requests)
            finally:
                swapper.join()
                reloader.stop()
            stats = engine.stats()

        # the single-request arm (same machinery, no coalescing); no workdir:
        # its events would pollute the run's serving rollup
        seq = InferenceEngine.for_model(
            model, params, device=spark.device, max_batch=1, max_wait_ms=0.0,
            max_queue=4096, name="lenet-seq")
        with seq:
            seq.warmup(example(0))
            seq_lat, _, seq_wall = run_load(seq, example, clients=args.clients,
                                            requests_per_client=args.requests)
    spark.stop()

    # -- 5. summary -----------------------------------------------------------
    rps = len(lat) / wall if wall > 0 else 0.0
    seq_rps = len(seq_lat) / seq_wall if seq_wall > 0 else 0.0
    rec = {
        "metric": "serve_mnist_requests_per_sec",
        "value": round(rps, 1),
        "unit": "req/s",
        "extra": {
            "clients": args.clients,
            "requests_ok": len(lat),
            "requests_shed": shed,
            "latency_p50_ms": round(_pct(lat, 0.5) * 1e3, 2) if lat else None,
            "latency_p99_ms": round(_pct(lat, 0.99) * 1e3, 2) if lat else None,
            "sequential_requests_per_sec": round(seq_rps, 1),
            "batching_speedup": round(rps / seq_rps, 2) if seq_rps else None,
            "served_params_version": stats["params_version"],
            "hot_reloads": stats["reloads"],
            "checkpoint_step_at_start": step,
            "device": str(spark.device),
            "workdir": workdir,
        },
    }
    if stats["reloads"] < 1:
        raise RuntimeError("hot reload never fired during the load")
    if shed or len(lat) != args.clients * args.requests:
        raise RuntimeError("requests were dropped across the hot reload")
    print(json.dumps(rec))
    print(f"dlstatus {workdir}   # p50/p99 rollup from the request telemetry",
          file=sys.stderr)
    return rec


if __name__ == "__main__":
    main()

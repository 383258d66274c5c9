"""``dlserve`` — stand up the serving engine (or a replica fleet) under
load; the port of ``distributeddeeplearningspark_tpu/serve/cli.py``, run as
``python -m distributeddeeplearningspark_tpu_torch.serve.cli``.

The serving sibling of ``dlsubmit``/``dlstatus``: builds an
:class:`~.engine.InferenceEngine` over a model (params from a checkpoint
directory when given, verified via the integrity manifests; fresh init
otherwise), drives it with N closed-loop synthetic clients, and prints
ONE JSON line with the latency/throughput evidence (the bench.py house
convention). With ``--compare-sequential`` the same request count runs
single-request-at-a-time through the identical jitted forward, so the
line carries the dynamic-batching speedup measured, not assumed. With
``--watch`` a :class:`~.reload.HotReloader` polls the checkpoint
directory for newer verified steps for the whole run — a training job
committing checkpoints mid-load exercises hot reload under traffic.

``--replicas N`` engages the fleet path (:mod:`.fleet`): N engine
replicas as separate processes behind the queue-depth/p99 router,
optionally with one ``--rolling-reload`` mid-traffic (zero dropped
in-flight requests — the record carries the count) and a
``--compare-single-replica`` arm that reruns the load through one
replica for the measured scaling factor. ``--model tinyllama`` serves
continuous decode over the paged KV arena with prefix caching; its
synthetic clients share a system prompt (``--prefix-tokens``), so the
record also carries the prefix-cache hit rate and prompt tokens saved.

::

    python -m distributeddeeplearningspark_tpu_torch.serve.cli --model lenet \
        --clients 64 --requests-per-client 4 --compare-sequential
    python -m distributeddeeplearningspark_tpu_torch.serve.cli --model lenet \
        --checkpoint-dir CK --watch --workdir CK
    python -m distributeddeeplearningspark_tpu_torch.serve.cli --model tinyllama \
        --replicas 2 --rolling-reload --compare-single-replica --workdir WD

Everything runs on the card (``--device cuda``, the default: fleet replica
i on ``cuda:(i % device_count)``) unless ``--device cpu`` asks for the CPU.
Per-request ``request`` telemetry events land in ``--workdir`` (or the
checkpoint dir); ``dlstatus <workdir>`` renders the p50/p99 rollup and
``dlstatus <workdir> --fleet-serve`` the per-replica table.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

# the ONE percentile definition (nearest-rank): the CLI's printed p50/p99
# must never drift from the dlstatus rollup of the same run
from distributeddeeplearningspark_tpu_torch.status import _percentile as _pct


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dlserve",
        description="Serve a model with dynamic batching; measure it under "
                    "synthetic concurrent load.")
    p.add_argument("--model", default="lenet", choices=["lenet", "tinyllama"],
                   help="served model (synthetic request generator included); "
                        "tinyllama = continuous decode over the paged KV "
                        "arena, fleet mode only")
    p.add_argument("--checkpoint-dir", default=None,
                   help="load params from this checkpoint root (newest "
                        "verified step); fresh-init when unset")
    p.add_argument("--workdir", default=None,
                   help="telemetry dir for request events (default: the "
                        "checkpoint dir, when given; fleet mode makes a "
                        "tmp dir so the rollup always has a home)")
    p.add_argument("--watch", action="store_true",
                   help="hot-reload newer verified checkpoints during the "
                        "run (requires --checkpoint-dir)")
    p.add_argument("--watch-interval-s", type=float, default=2.0)
    p.add_argument("--clients", type=int, default=16,
                   help="concurrent closed-loop synthetic clients")
    p.add_argument("--requests-per-client", type=int, default=8)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=1024)
    p.add_argument("--compare-sequential", action="store_true",
                   help="also run the same request count one-by-one through "
                        "the identical forward and report the speedup")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine and the replicas serve (the card "
                        "unless cpu is asked for)")
    # -- fleet mode -----------------------------------------------------------
    p.add_argument("--replicas", type=int, default=0,
                   help="serve through N replica PROCESSES behind the "
                        "router (0 = classic in-process single engine)")
    p.add_argument("--rolling-reload", action="store_true",
                   help="fleet mode: one rolling hot-reload mid-traffic "
                        "(drain → swap → undrain, one replica at a time)")
    p.add_argument("--compare-single-replica", action="store_true",
                   help="fleet mode: rerun the load through ONE replica and "
                        "report the measured scaling factor")
    p.add_argument("--tenant-budget", type=int, default=None,
                   help="fleet mode: per-tenant outstanding-request budget "
                        "(None = unlimited)")
    p.add_argument("--tenants", type=int, default=1,
                   help="fleet mode: spread clients across this many tenants")
    p.add_argument("--pin-cores", action="store_true",
                   help="fleet mode: pin each replica process to one CPU "
                        "core (the CPU stand-in for one replica a card: "
                        "without it one replica's intra-op pool saturates "
                        "the whole box and 1->N scaling measures thread "
                        "contention, not replica capacity)")
    p.add_argument("--slots", type=int, default=4,
                   help="tinyllama: KV slots per replica")
    p.add_argument("--page-size", type=int, default=16,
                   help="tinyllama: KV page size (tokens)")
    p.add_argument("--max-cache-len", type=int, default=128)
    p.add_argument("--prefix-tokens", type=int, default=32,
                   help="tinyllama: shared system-prompt length (the "
                        "prefix-cache workload knob)")
    p.add_argument("--suffix-tokens", type=int, default=8,
                   help="tinyllama: per-request unique prompt tail")
    p.add_argument("--max-new-tokens", type=int, default=8)
    p.add_argument("--fault-sleep-ms", type=float, default=0.0,
                   help="fleet mode drill: make ONE replica slow by "
                        "sleeping this long before every decode step — "
                        "the deterministic fault the SLO sentinel smoke "
                        "injects (dlstatus --slo flips its verdict, "
                        "--traces names the slow replica's decode stage)")
    p.add_argument("--fault-replica", type=int, default=0,
                   help="which replica --fault-sleep-ms slows (default 0)")
    return p


def _lenet_setup(args):
    """(model, params, example_fn, step) for the LeNet workload."""
    import numpy as np

    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5

    model = LeNet5(device=args.device, seed=args.seed)
    rng = np.random.default_rng(args.seed)

    def example(i: int):
        return {"image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32)}

    if args.checkpoint_dir:
        from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer

        with Checkpointer(args.checkpoint_dir, async_save=False) as ck:
            params, step = ck.restore_params()
        print(f"dlserve: serving checkpoint step {step} from "
              f"{args.checkpoint_dir}", file=sys.stderr)
    else:
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        step = None
        print("dlserve: no --checkpoint-dir, serving fresh-init params",
              file=sys.stderr)
    return model, params, example, step


def run_load(engine, example_fn, *, clients: int, requests_per_client: int):
    """Pipelined concurrent load: every client submits its whole request
    stream, then collects the results (HTTP/2-style pipelining — the
    client-side Python cost of a resubmit never serializes the server,
    so the measurement sees the engine's throughput, not the GIL's).

    Returns (latencies_sorted, shed_count, wall_s). A shed request counts
    in ``shed`` and contributes no latency sample."""
    from distributeddeeplearningspark_tpu_torch.serve.engine import OverloadedError

    lat: list[float] = []
    shed = [0]
    lock = threading.Lock()
    # payloads are built BEFORE the clock starts: generating request bodies
    # is client work, not serving work, and doing it inside the timed loop
    # would serialize every arm on the GIL identically — measuring python,
    # not the engine
    payloads = [[example_fn(c * requests_per_client + j)
                 for j in range(requests_per_client)]
                for c in range(clients)]
    barrier = threading.Barrier(clients + 1)

    def client(cid: int):
        barrier.wait()
        pending = []
        for ex in payloads[cid]:
            t0 = time.monotonic()
            try:
                pending.append((t0, engine.submit(ex)))
            except OverloadedError:
                with lock:
                    shed[0] += 1
        for t0, fut in pending:
            fut.result(timeout=120.0)
            with lock:
                lat.append(time.monotonic() - t0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    return sorted(lat), shed[0], time.monotonic() - t0


def run_router_load(router, payload_fn, *, clients: int,
                    requests_per_client: int, op: str = "infer",
                    tenants: int = 1, timeout: float = 300.0):
    """The fleet twin of :func:`run_load`, dispatching through the router.

    Returns (latencies_sorted, shed_count, failed_count, wall_s) — a
    failed request (replica died with no survivor to fail over to) is the
    one thing the zero-drop assertion counts; sheds are intentional."""
    from distributeddeeplearningspark_tpu_torch.serve.engine import OverloadedError

    lat: list[float] = []
    shed = [0]
    failed = [0]
    lock = threading.Lock()
    payloads = [[payload_fn(c * requests_per_client + j)
                 for j in range(requests_per_client)]
                for c in range(clients)]
    barrier = threading.Barrier(clients + 1)

    def client(cid: int):
        tenant = f"tenant{cid % max(1, tenants)}"
        barrier.wait()
        pending = []
        for payload in payloads[cid]:
            t0 = time.monotonic()
            try:
                pending.append((t0, router.submit(payload, op=op,
                                                  tenant=tenant)))
            except OverloadedError:
                with lock:
                    shed[0] += 1
        for t0, fut in pending:
            try:
                fut.result(timeout=timeout)
            except OverloadedError:
                # a replica-side shed (engine queue full) rides the
                # future — it is the intentional typed backpressure, not
                # a dropped request, and must not trip the zero-drop gate
                with lock:
                    shed[0] += 1
                continue
            except Exception:  # noqa: BLE001 — counted, not raised: the
                with lock:     # record must carry the drop evidence
                    failed[0] += 1
                continue
            with lock:
                lat.append(time.monotonic() - t0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    return sorted(lat), shed[0], failed[0], time.monotonic() - t0


# -- fleet mode ---------------------------------------------------------------


def _fleet_payload_fn(args):
    """(payload_fn, op) for the fleet workload. tinyllama clients share a
    system prompt (the prefix-cache case); suffixes are per-request."""
    import numpy as np

    rng = np.random.default_rng(args.seed)
    if args.model == "lenet":
        def payload(i: int):
            return {"example": {
                "image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32)}}

        return payload, "infer"
    vocab = 256
    system = rng.integers(1, vocab, (args.prefix_tokens,)).astype(np.int32)

    def payload(i: int):
        suffix = rng.integers(1, vocab,
                              (args.suffix_tokens,)).astype(np.int32)
        return {"prompt": np.concatenate([system, suffix]),
                "max_new_tokens": args.max_new_tokens}

    return payload, "generate"


def fleet_main(args) -> int:
    from distributeddeeplearningspark_tpu_torch.serve.fleet import ServingFleet

    workdir = (args.workdir or args.checkpoint_dir
               or tempfile.mkdtemp(prefix="dlserve_fleet_"))
    spec = {
        "model": args.model,
        "seed": args.seed,
        "checkpoint_dir": args.checkpoint_dir,
        "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "max_queue": args.max_queue,
        "slots": args.slots,
        "max_cache_len": args.max_cache_len,
        "page_size": args.page_size,
        "gauge_interval_s": 0.5,
        "pin_cores": args.pin_cores,
        "device": "cpu" if args.device == "cpu" else None,
        **({"step_delay_ms": {str(args.fault_replica): args.fault_sleep_ms}}
           if args.fault_sleep_ms else {}),
    }
    payload_fn, op = _fleet_payload_fn(args)
    print(f"dlserve: launching {args.replicas} {args.model} replica(s), "
          f"workdir={workdir}", file=sys.stderr)
    reload_evidence: list[dict] = []
    with ServingFleet(spec, replicas=args.replicas,
                      workdir=workdir) as fleet:
        router = fleet.router(default_tenant_budget=args.tenant_budget)

        # warm every replica with the REAL payload shape before timing:
        # the replica's own warmup cannot know the client prompt length, and
        # an untimed pair per replica runs both the miss-path prompt bucket
        # and the hit-path remainder window (first-call costs are a deploy
        # cost, not a request cost — the single path's rule)
        replica_devices = {h.name: h.call("ping")["device"] for h in fleet.handles}
        for h in fleet.handles:
            for j in range(2):
                h.submit(payload_fn(-1 - j), op).result(timeout=600.0)

        reload_thread = None
        if args.rolling_reload:
            def reload_when_traffic_flows():
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    if router.stats()["dispatched"] >= args.replicas:
                        break
                    time.sleep(0.002)
                reload_evidence.extend(fleet.rolling_reload(router))

            reload_thread = threading.Thread(target=reload_when_traffic_flows)
            reload_thread.start()
        lat, shed, failed, wall = run_router_load(
            router, payload_fn, clients=args.clients,
            requests_per_client=args.requests_per_client, op=op,
            tenants=args.tenants)
        if reload_thread is not None:
            reload_thread.join()
        rstats = router.stats()
        replica_stats = {h.name: h.call("stats") for h in fleet.handles}

        single = None
        if args.compare_single_replica and args.replicas > 1:
            # same load, one replica: the others drain (stay alive — the
            # arm measures one engine's throughput under the identical
            # router/transport costs, isolating the replica scaling)
            for h in fleet.handles[1:]:
                router.drain(h.name)
            s_lat, s_shed, s_failed, s_wall = run_router_load(
                router, payload_fn, clients=args.clients,
                requests_per_client=args.requests_per_client, op=op,
                tenants=args.tenants)
            for h in fleet.handles[1:]:
                router.undrain(h.name)
            single = {"requests_ok": len(s_lat), "shed": s_shed,
                      "failed": s_failed, "wall_s": round(s_wall, 3),
                      "requests_per_sec": round(len(s_lat) / s_wall, 1)
                      if s_wall > 0 else 0.0}

    expected = args.clients * args.requests_per_client
    prefix_hits = sum(s.get("prefix_hits", 0) or 0
                      for s in replica_stats.values())
    prefix_misses = sum(s.get("prefix_misses", 0) or 0
                        for s in replica_stats.values())
    rec = {
        "metric": "dlserve_fleet_requests_per_sec",
        "value": round(len(lat) / wall, 1) if wall > 0 else 0.0,
        "unit": "req/s",
        "extra": {
            "model": args.model,
            "op": op,
            "replicas": args.replicas,
            "clients": args.clients,
            "requests_expected": expected,
            "requests_ok": len(lat),
            "requests_shed": shed,
            "requests_failed": failed,
            "requests_dropped": expected - len(lat) - shed - failed,
            "latency_p50_ms": (round(_pct(lat, 0.5) * 1e3, 2)
                               if lat else None),
            "latency_p99_ms": (round(_pct(lat, 0.99) * 1e3, 2)
                               if lat else None),
            "wall_s": round(wall, 3),
            "router": rstats,
            "per_replica": replica_stats,
            "rolling_reload": {
                "performed": bool(reload_evidence),
                "replicas_reloaded": len(reload_evidence),
                "evidence": reload_evidence,
            },
            "prefix": {
                "hits": prefix_hits,
                "misses": prefix_misses,
                "hit_rate": (round(prefix_hits / (prefix_hits + prefix_misses),
                                   4) if prefix_hits + prefix_misses else None),
                "tokens_saved": sum(s.get("prefix_tokens_saved", 0) or 0
                                    for s in replica_stats.values()),
            },
            "kv_page_occupancy": {
                n: s.get("kv_page_occupancy")
                for n, s in replica_stats.items()
                if s.get("kv_page_occupancy") is not None} or None,
            "tenants": args.tenants,
            "tenant_budget": args.tenant_budget,
            "replica_devices": replica_devices,
            "workdir": workdir,
        },
    }
    if single is not None:
        rec["extra"]["single_replica"] = single
        if single["requests_per_sec"] > 0:
            rec["extra"]["replica_scaling"] = round(
                rec["value"] / single["requests_per_sec"], 2)
    print(json.dumps(rec))
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.watch and not args.checkpoint_dir:
        build_parser().error("--watch requires --checkpoint-dir")
    if args.replicas < 0:
        build_parser().error("--replicas must be >= 0")
    if args.model == "tinyllama" and not args.replicas:
        build_parser().error("--model tinyllama runs in fleet mode "
                             "(--replicas N)")
    fleet_flags = args.rolling_reload or args.compare_single_replica \
        or args.pin_cores or args.tenant_budget is not None \
        or args.fault_sleep_ms
    if fleet_flags and not args.replicas:
        build_parser().error("--rolling-reload/--compare-single-replica/"
                             "--pin-cores/--tenant-budget/--fault-sleep-ms "
                             "need --replicas N")
    if args.fault_sleep_ms < 0:
        # a negative sleep would reach time.sleep() inside the replica's
        # decode loop and kill its serving thread with a ValueError
        build_parser().error("--fault-sleep-ms must be >= 0")
    if args.fault_sleep_ms and not (0 <= args.fault_replica < args.replicas):
        # an out-of-range id would make the drill a silent no-op: every
        # replica healthy, the SLO verdict GOOD, and the operator
        # concluding the sentinel tolerates a fault that never ran
        build_parser().error(
            f"--fault-replica {args.fault_replica} is out of range for "
            f"--replicas {args.replicas}")
    if args.replicas:
        if args.watch or args.compare_sequential:
            build_parser().error("--watch/--compare-sequential are the "
                                 "single-engine harness; fleet mode has "
                                 "--rolling-reload/--compare-single-replica")
        return fleet_main(args)

    workdir = args.workdir or args.checkpoint_dir
    # heavy imports AFTER argparse
    from distributeddeeplearningspark_tpu_torch.serve import (
        HotReloader,
        InferenceEngine,
    )

    model, params, example_fn, ckpt_step = _lenet_setup(args)
    engine = InferenceEngine.for_model(
        model, params, device=args.device, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        workdir=workdir, name=args.model)
    reloader = None
    if args.watch:
        reloader = HotReloader(engine, args.checkpoint_dir, current_step=ckpt_step,
                               interval_s=args.watch_interval_s)

    with engine:
        # run the whole bucket ladder before timing: first-call costs are a
        # deploy cost, not a per-request latency fact
        n_warm = engine.warmup(example_fn(0))
        print(f"dlserve: warmed {n_warm} batch bucket(s) "
              f"{engine.batch_sizes}", file=sys.stderr)
        if reloader is not None:
            reloader.start()
        lat, shed, wall = run_load(
            engine, example_fn, clients=args.clients,
            requests_per_client=args.requests_per_client)
        stats = engine.stats()
        if reloader is not None:
            reloader.stop()

    rec = {
        "metric": "dlserve_requests_per_sec",
        "value": round(len(lat) / wall, 1) if wall > 0 else 0.0,
        "unit": "req/s",
        "extra": {
            "model": args.model,
            "clients": args.clients,
            "requests_ok": len(lat),
            "requests_shed": shed,
            "latency_p50_ms": (round(_pct(lat, 0.5) * 1e3, 2)
                               if lat else None),
            "latency_p99_ms": (round(_pct(lat, 0.99) * 1e3, 2)
                               if lat else None),
            "wall_s": round(wall, 3),
            "max_batch": args.max_batch,
            "max_wait_ms": args.max_wait_ms,
            "bucket_counts": stats["bucket_counts"],
            "compiled_batch_shapes": stats["compiled_batch_shapes"],
            "params_version": stats["params_version"],
            "reloads": stats["reloads"],
            "checkpoint_step": ckpt_step,
            "device": str(engine.device),
            "workdir": workdir,
        },
    }

    if args.compare_sequential:
        # the same closed-loop load through an engine that answers ONE
        # request per forward (max_batch=1, no coalescing window): both
        # arms pay identical queue/future/telemetry costs, so the ratio
        # isolates exactly what dynamic batching buys
        # NO workdir: the comparison arm is local evidence for this JSON
        # line — its request events in the run's stream would blend two
        # engines' latencies into one dlstatus rollup and deflate the
        # span-based throughput with the idle gap between the phases
        seq = InferenceEngine.for_model(
            model, params, device=args.device, max_batch=1, max_wait_ms=0.0,
            max_queue=args.max_queue, name=f"{args.model}-seq")
        with seq:
            seq.warmup(example_fn(0))
            seq_lat, _, seq_wall = run_load(
                seq, example_fn, clients=args.clients,
                requests_per_client=args.requests_per_client)
        seq_rps = len(seq_lat) / seq_wall if seq_wall > 0 else 0.0
        rec["extra"]["sequential_requests_per_sec"] = round(seq_rps, 1)
        rec["extra"]["sequential_latency_p50_ms"] = (
            round(_pct(seq_lat, 0.5) * 1e3, 2) if seq_lat else None)
        rec["extra"]["batching_speedup"] = (
            round(rec["value"] / seq_rps, 2) if seq_rps > 0 else None)

    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

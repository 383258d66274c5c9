"""Serving fleet — N engine replicas as separate processes, one command;
the port of ``distributeddeeplearningspark_tpu/serve/fleet.py``.

Each replica is its own OS process running one
:class:`~.engine.InferenceEngine` (LeNet-5) or
:class:`~.generate.ContinuousGenerator` (a tiny Llama), launched with the
supervisor's gang idiom: a fresh port per process and the ``DLS_*`` env
contract (``DLS_PROCESS_ID`` = replica index, ``DLS_NUM_PROCESSES``,
``DLS_TELEMETRY_DIR``), so every replica's ``request`` events land in ONE
run directory under its own process identity, and ``dlstatus
--fleet-serve`` attributes them. A replica is ``subprocess.Popen``'d
(fork and exec at once: no process that has initialised CUDA is forked);
on a machine with cards replica i takes ``cuda:(i % device_count)``
unless the spec asks for the CPU (``"device": "cpu"``), and without a
card and without that request it fails to start (no fallback).

Control and data go over one ``multiprocessing.connection`` socket per
replica (stdlib, authkey-authenticated, pickled numpy): the parent sends
``{"id", "op", ...}`` requests and a reader thread resolves the matching
futures as the responses arrive. The transport is the failure detector: a
replica that dies tears the socket, every pending future fails with
:class:`~.router.ReplicaDiedError`, the :class:`~.router.Router` retries
those requests on the survivors, and :meth:`ServingFleet.restart_dead`
(or the :meth:`ServingFleet.watch` thread) relaunches it with a bumped
``DLS_RESTART`` ordinal and warms its weights from a live peer
(``export_params`` → ``import_params``, checked by a blake2b digest).

**Rolling hot reload** (:meth:`ServingFleet.rolling_reload`): one replica
at a time is drained (the router stops feeding it, its in-flight requests
finish), told to reload and undrained, so N−1 replicas serve throughout.

This module is both library and replica entry point:
``python -c "from distributeddeeplearningspark_tpu_torch.serve.fleet
import replica_main; replica_main()"`` runs :func:`replica_main`,
configured by the environment alone.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any

from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib
from distributeddeeplearningspark_tpu_torch.serve.engine import (
    EngineStoppedError,
    OverloadedError,
)
from distributeddeeplearningspark_tpu_torch.serve.router import (
    ReplicaDiedError,
    Router,
)
from distributeddeeplearningspark_tpu_torch.supervisor import free_port

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.serve")

#: the directory holding the package, put on a replica's PYTHONPATH
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENV_SPEC = "DLS_SERVE_SPEC"
ENV_PORT = "DLS_SERVE_PORT"
ENV_AUTHKEY = "DLS_SERVE_AUTHKEY"

#: Exceptions a replica may raise that the client reconstructs typed (the
#: load-shed/stop contract must survive the process boundary — a caller
#: branching on OverloadedError can't branch on a stringly RuntimeError).
_TYPED_ERRORS = {
    "OverloadedError": lambda m, f: OverloadedError(
        f.get("queue_depth", -1), f.get("max_queue", -1)),
    "EngineStoppedError": lambda m, f: EngineStoppedError(m),
    "ValueError": lambda m, f: ValueError(m),
}


# -- replica side (child process) ---------------------------------------------


def _tiny_llama_cfg(spec: dict):
    """The fleet's built-in Llama geometry, small enough to serve on the
    CPU (tests and drills; real weights come through ``checkpoint_dir``)."""
    import torch

    from distributeddeeplearningspark_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=int(spec.get("vocab_size", 256)), hidden_size=64,
        num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position=int(spec.get("max_cache_len", 128)), dtype=torch.float32)


def _replica_device(spec: dict, replica_id: int) -> str:
    """Where replica ``replica_id`` serves: ``spec["device"]`` when given,
    else ``cuda:(id % device_count)`` (the card; no fallback to the CPU)."""
    import torch

    if spec.get("device"):
        return str(spec["device"])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError(
            "no CUDA device for a serving replica; give the spec "
            "\"device\": \"cpu\" to serve on the CPU")
    return f"cuda:{replica_id % count}"


def _build_replica(spec: dict, replica_id: int, workdir: str | None):
    """(engine, reload_fn, warm) for the spec'd model.

    ``reload_fn(step)`` performs one hot reload and returns its evidence:
    a checkpoint-backed replica polls the directory for a newer verified
    step (the :class:`~.reload.HotReloader` walk, manifests and all); one
    without a checkpoint re-initialises from a bumped seed (the drill
    path)."""
    import numpy as np
    import torch

    seed = int(spec.get("seed", 0))
    model_name = spec.get("model", "lenet")
    ckpt_dir = spec.get("checkpoint_dir")
    device = _replica_device(spec, replica_id)

    def restored():
        from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer

        with Checkpointer(ckpt_dir, async_save=False) as ck:
            return ck.restore_params()

    if model_name == "lenet":
        from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
        from distributeddeeplearningspark_tpu_torch.serve.engine import (
            InferenceEngine,
        )

        model = LeNet5(device=device)

        def new_params(s: int):
            model.init_weights(torch.Generator(device=device).manual_seed(s))
            return {k: v.detach().clone() for k, v in model.named_parameters()}

        params, step0 = restored() if ckpt_dir else (new_params(seed), None)
        engine = InferenceEngine.for_model(
            model, params, device=device,
            max_batch=int(spec.get("max_batch", 32)),
            max_wait_ms=float(spec.get("max_wait_ms", 5.0)),
            max_queue=int(spec.get("max_queue", 1024)),
            workdir=workdir, name=model_name)

        def warm():
            engine.warmup({"image": np.zeros((28, 28, 1), np.float32)})
    elif model_name == "tinyllama":
        from distributeddeeplearningspark_tpu_torch.models.llama import (
            LlamaForCausalLM,
        )
        from distributeddeeplearningspark_tpu_torch.serve.generate import (
            ContinuousGenerator,
        )

        cfg = _tiny_llama_cfg(spec)

        def new_params(s: int):
            model = LlamaForCausalLM(cfg, device=device)
            model.init_weights(torch.Generator(device=device).manual_seed(s))
            return {k: v.detach() for k, v in model.named_parameters()}

        params, step0 = restored() if ckpt_dir else (new_params(seed), None)
        # the deterministic "this replica got slow" drill: replica id (a
        # str: JSON keys) → sleep ms before each decode step
        delay_ms = (spec.get("step_delay_ms") or {}).get(str(replica_id), 0)
        engine = ContinuousGenerator(
            cfg, params, device=device,
            slots=int(spec.get("slots", 4)),
            max_cache_len=int(spec.get("max_cache_len", 128)),
            page_size=spec.get("page_size", 16),
            prefix_cache=bool(spec.get("prefix_cache", True)),
            max_queue=int(spec.get("max_queue", 1024)),
            gauge_interval_s=float(spec.get("gauge_interval_s", 1.0)),
            step_delay_s=float(delay_ms) / 1e3,
            workdir=workdir, name=model_name)

        def warm():
            engine.generate(np.arange(1, 5, dtype=np.int32), 2, timeout=300.0)
    else:
        raise ValueError(f"unknown fleet model {model_name!r}")

    reloads = [0]
    reloader = None
    if ckpt_dir:
        from distributeddeeplearningspark_tpu_torch.serve.reload import HotReloader

        reloader = HotReloader(engine, ckpt_dir, current_step=step0)

    def reload_fn(step=None):
        if reloader is not None:
            act = reloader.poll()
            return {"action": act, "params_version": engine.params_version}
        # the drill path: a deterministic re-init from a bumped seed
        reloads[0] += 1
        engine.swap_params(new_params(seed + 1000 * reloads[0]), version=reloads[0])
        telemetry_lib.emit("recovery", event="serve-reload", replica=replica_id,
                           params_version=engine.params_version)
        return {"action": {"action": "reinit", "seed_bump": reloads[0]},
                "params_version": engine.params_version}

    return engine, reload_fn, warm


def replica_main() -> int:
    """One serving replica, entirely env-configured (the worker half of
    the gang contract): build the engine, warm it, listen, serve ops
    until shutdown or the parent's socket dies."""
    from multiprocessing.connection import Listener

    import torch

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    spec = json.loads(os.environ[ENV_SPEC])
    if spec.get("pin_cores"):
        # one replica ↔ one core, the CPU stand-in for one replica a card:
        # without it each replica's intra-op pool spans every host core, and
        # 1→2 scaling measures thread contention, not replica capacity
        try:
            cores = sorted(os.sched_getaffinity(0))
            mine = cores[int(os.environ.get("DLS_PROCESS_ID", "0")) % len(cores)]
            os.sched_setaffinity(0, {mine})
            torch.set_num_threads(1)
        except (AttributeError, OSError):
            pass  # non-Linux: serve unpinned rather than not at all
    port = int(os.environ[ENV_PORT])
    authkey = bytes.fromhex(os.environ[ENV_AUTHKEY])
    replica_id = int(os.environ.get("DLS_PROCESS_ID", "0"))
    workdir = os.environ.get(telemetry_lib.WORKDIR_ENV) or None

    engine, reload_fn, warm = _build_replica(spec, replica_id, workdir)
    engine.start()
    if spec.get("warmup", True):
        warm()
    logger.info("replica %d: serving %s on port %d", replica_id,
                spec.get("model"), port)

    send_lock = threading.Lock()

    with Listener(("127.0.0.1", port), authkey=authkey) as listener, \
            listener.accept() as conn:

        def reply(mid, **fields):
            with send_lock:
                try:
                    conn.send({"id": mid, **fields})
                except (OSError, ValueError):
                    pass  # parent gone; the recv loop will see EOF too

        def reply_err(mid, e: BaseException):
            extra = {}
            if isinstance(e, OverloadedError):
                extra = {"queue_depth": e.queue_depth,
                         "max_queue": e.max_queue}
            reply(mid, ok=False, etype=type(e).__name__,
                  error=str(e), **extra)

        def on_future(mid, fut: Future):
            e = fut.exception()
            if e is not None:
                reply_err(mid, e)
            else:
                # ts = when the reply left the replica: the parent stamps
                # it on the resolved future so the router can account the
                # return hop as a trace stage (stream leg=return) — the
                # last piece of the e2e latency the stage sum must cover
                reply(mid, ok=True, result=fut.result(), ts=time.time())

        try:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    logger.info("replica %d: parent gone, stopping",
                                replica_id)
                    break
                mid, op = msg.get("id"), msg.get("op")
                try:
                    if op == "ping":
                        reply(mid, ok=True,
                              result={"replica": replica_id, "pid": os.getpid(),
                                      "model": spec.get("model"),
                                      "device": str(engine.device)})
                    elif op == "stats":
                        reply(mid, ok=True, result=engine.stats())
                    elif op == "infer":
                        # trace context crosses the socket as a plain
                        # payload field: the replica's stage spans join
                        # the router's tree (telemetry.trace)
                        fut = engine.submit(msg["example"],
                                            trace=msg.get("trace"))
                        fut.add_done_callback(
                            lambda f, mid=mid: on_future(mid, f))
                    elif op == "generate":
                        fut = engine.submit(msg["prompt"],
                                            msg["max_new_tokens"],
                                            trace=msg.get("trace"))
                        fut.add_done_callback(
                            lambda f, mid=mid: on_future(mid, f))
                    elif op == "reload":
                        reply(mid, ok=True, result=reload_fn(msg.get("step")))
                    elif op == "export_params":
                        # peer warm-up export: the serving weights leave as
                        # numpy + a digest, so the importer can prove the
                        # transfer landed intact
                        from distributeddeeplearningspark_tpu_torch.parallel import (
                            live_reshard,
                        )

                        params, version = engine.export_params()
                        reply(mid, ok=True, result={
                            "params": params, "version": version,
                            "digest": live_reshard.tree_digest(params)})
                    elif op == "import_params":
                        from distributeddeeplearningspark_tpu_torch.parallel import (
                            live_reshard,
                        )

                        got = live_reshard.tree_digest(msg["params"])
                        want = msg.get("digest")
                        if want is not None and got != want:
                            raise ValueError(
                                f"import_params digest mismatch: donor sent "
                                f"{want}, received tree hashes to {got} — "
                                f"refusing to serve corrupted weights; "
                                f"reload from the checkpoint instead")
                        engine.swap_params(msg["params"],
                                           version=msg.get("version"))
                        telemetry_lib.emit(
                            "recovery", event="replica-warmup",
                            replica=replica_id, digest=got,
                            params_version=engine.params_version)
                        reply(mid, ok=True, result={
                            "params_version": engine.params_version,
                            "digest": got})
                    elif op == "shutdown":
                        reply(mid, ok=True, result=engine.stats())
                        break
                    else:
                        reply(mid, ok=False, etype="ValueError",
                              error=f"unknown op {op!r}")
                except Exception as e:  # noqa: BLE001 — one bad op must not
                    # kill the replica; the caller learns the real error
                    reply_err(mid, e)
        finally:
            engine.stop()
    return 0


# -- parent side --------------------------------------------------------------


class ReplicaHandle:
    """Client for one replica process: request/response correlation over
    the authenticated socket, a reader thread resolving futures, and
    death detection (socket EOF or process exit fails every pending
    future with :class:`~.router.ReplicaDiedError` — the router's cue to
    fail over)."""

    def __init__(self, name: str, proc: subprocess.Popen, conn):
        self.name = name
        self.proc = proc
        self._conn = conn
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._mid = 0
        self._dead = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"dlserve-{name}-reader",
            daemon=True)
        self._reader.start()

    @property
    def alive(self) -> bool:
        return not self._dead and self.proc.poll() is None

    def submit(self, payload: dict[str, Any], op: str = "infer") -> Future:
        fut: Future = Future()
        with self._lock:
            if self._dead:
                raise ReplicaDiedError(f"replica {self.name} is dead")
            self._mid += 1
            mid = self._mid
            self._pending[mid] = fut
        try:
            with self._send_lock:
                self._conn.send({"id": mid, "op": op, **payload})
        except (OSError, ValueError, BrokenPipeError) as e:
            with self._lock:
                self._pending.pop(mid, None)
            self._mark_dead()
            raise ReplicaDiedError(
                f"replica {self.name}: send failed ({e})") from e
        return fut

    def call(self, op: str, *, timeout: float | None = 60.0,
             **payload) -> Any:
        """Blocking convenience for control ops (ping/stats/reload)."""
        return self.submit(payload, op).result(timeout=timeout)

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                self._mark_dead()
                return
            with self._lock:
                fut = self._pending.pop(msg.get("id"), None)
            if fut is None:
                continue
            if msg.get("ok"):
                if msg.get("ts") is not None:
                    fut.dls_reply_ts = msg["ts"]  # replica send time
                fut.set_result(msg.get("result"))
            else:
                make = _TYPED_ERRORS.get(msg.get("etype"))
                err = (make(msg.get("error", ""), msg) if make
                       else RuntimeError(
                           f"{msg.get('etype')}: {msg.get('error')}"))
                fut.set_exception(err)

    def _mark_dead(self) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(ReplicaDiedError(
                    f"replica {self.name} died with the request in flight"))

    def stop(self, timeout: float = 15.0) -> None:
        try:
            if self.alive:
                self.call("shutdown", timeout=timeout)
        except Exception:  # noqa: BLE001 — best-effort; escalate below
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        try:
            self._conn.close()
        except OSError:
            pass


class LocalReplica:
    """In-process handle over an engine/generator — same protocol as
    :class:`ReplicaHandle`, no process. For tests, and for composing a
    router over engines that share one process (e.g. two meshes)."""

    def __init__(self, name: str, engine, *, reload_fn=None):
        self.name = name
        self.engine = engine
        self.alive = True
        self._reload_fn = reload_fn
        self._reloads = 0

    def submit(self, payload: dict[str, Any], op: str = "infer") -> Future:
        if not self.alive:
            raise ReplicaDiedError(f"replica {self.name} is dead")
        if op == "infer":
            return self.engine.submit(payload["example"],
                                      trace=payload.get("trace"))
        if op == "generate":
            return self.engine.submit(payload["prompt"],
                                      payload["max_new_tokens"],
                                      trace=payload.get("trace"))
        fut: Future = Future()
        try:
            if op in ("stats", "ping"):
                fut.set_result(self.engine.stats())
            elif op == "reload":
                if self._reload_fn is None:
                    raise ValueError(f"replica {self.name} has no reload_fn")
                self._reloads += 1
                self.engine.swap_params(self._reload_fn(self._reloads))
                fut.set_result(
                    {"params_version": self.engine.params_version})
            elif op == "export_params":
                from distributeddeeplearningspark_tpu_torch.parallel import (
                    live_reshard,
                )

                params, version = self.engine.export_params()
                fut.set_result({
                    "params": params, "version": version,
                    "digest": live_reshard.tree_digest(params)})
            elif op == "import_params":
                from distributeddeeplearningspark_tpu_torch.parallel import (
                    live_reshard,
                )

                got = live_reshard.tree_digest(payload["params"])
                want = payload.get("digest")
                if want is not None and got != want:
                    raise ValueError(
                        f"import_params digest mismatch: donor sent {want}, "
                        f"received tree hashes to {got} — refusing to serve "
                        f"corrupted weights; reload from the checkpoint "
                        f"instead")
                self.engine.swap_params(payload["params"],
                                        version=payload.get("version"))
                fut.set_result({
                    "params_version": self.engine.params_version,
                    "digest": got})
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # noqa: BLE001 — protocol parity with the
            fut.set_exception(e)  # process handle: errors ride the future
        return fut

    def call(self, op: str, *, timeout: float | None = 60.0,
             **payload) -> Any:
        return self.submit(payload, op).result(timeout=timeout)

    def stop(self, timeout: float = 15.0) -> None:
        self.engine.stop()


def _proc_of(replica_name: str) -> str | None:
    """Fleet handle name ("r<idx>") -> the replica's telemetry process
    name ("p<idx>" — the fleet exports ``DLS_PROCESS_ID=idx``), so
    recovery events can be joined against per-process serving rows and
    health-alert evidence without knowing the naming convention."""
    if replica_name.startswith("r") and replica_name[1:].isdigit():
        return "p" + replica_name[1:]
    return None


class ServingFleet:
    """Launch and manage N replica processes (the serving gang).

    ``spec`` is the replica build recipe (model, checkpoint_dir, device,
    engine knobs — see :func:`_build_replica`), shipped to each child via
    ``DLS_SERVE_SPEC``. Replicas inherit the parent env plus the gang
    contract; ``workdir`` binds every replica's telemetry into one run
    directory (``dlstatus --fleet-serve`` reads it back).
    """

    def __init__(self, spec: dict, *, replicas: int = 2,
                 workdir: str | None = None,
                 startup_timeout_s: float = 300.0,
                 env: dict[str, str] | None = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.spec = dict(spec)
        self.num_replicas = int(replicas)
        self.workdir = workdir
        self.startup_timeout_s = float(startup_timeout_s)
        self.env = dict(env or {})
        self.handles: list[ReplicaHandle] = []
        self._ordinals: dict[int, int] = {}
        self._watch_stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        self._tele = (telemetry_lib.EventWriter(
            workdir, process="fleet", host=None) if workdir else None)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingFleet":
        t0 = time.monotonic()
        # Popen everything first (compiles overlap), then connect each
        launches = [self._spawn(i) for i in range(self.num_replicas)]
        handles: list[ReplicaHandle] = []
        try:
            for i, (proc, port, key) in enumerate(launches):
                handles.append(self._connect(i, proc, port, key))
            for h in handles:
                h.call("ping", timeout=self.startup_timeout_s)
        except BaseException:
            # one replica failing to come up must not leak the rest:
            # connected ones stop cleanly; never-connected ones would
            # block in accept() forever waiting for a parent that gave up
            for h in handles:
                try:
                    h.stop(timeout=2.0)
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            for proc, _, _ in launches[len(handles):]:
                if proc.poll() is None:
                    proc.terminate()
            raise
        self.handles = handles
        logger.info("fleet: %d replica(s) serving after %.1fs",
                    len(self.handles), time.monotonic() - t0)
        return self

    def _spawn(self, idx: int) -> tuple[subprocess.Popen, int, str]:
        port = free_port()
        key = secrets.token_hex(16)
        ordinal = self._ordinals.get(idx, 0)
        path = os.environ.get("PYTHONPATH")
        env = {
            **os.environ,
            **self.env,
            "PYTHONPATH": _PKG_PARENT + (os.pathsep + path if path else ""),
            "DLS_PROCESS_ID": str(idx),
            "DLS_NUM_PROCESSES": str(self.num_replicas),
            "DLS_RESTART": str(ordinal),
            ENV_PORT: str(port),
            ENV_AUTHKEY: key,
            ENV_SPEC: json.dumps(self.spec),
        }
        if self.workdir:
            env[telemetry_lib.WORKDIR_ENV] = self.workdir
        # -c, not -m: running the module under runpy while the package's
        # __init__ also imports it would run it twice (runpy warns); Popen
        # forks and execs at once, so a parent that holds CUDA is safe
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from distributeddeeplearningspark_tpu_torch.serve."
             "fleet import replica_main; sys.exit(replica_main())"],
            env=env)
        return proc, port, key

    def _connect(self, idx: int, proc, port: int, key: str) -> ReplicaHandle:
        from multiprocessing.connection import Client

        deadline = time.monotonic() + self.startup_timeout_s
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {idx} exited rc={proc.returncode} before "
                    f"accepting its control socket")
            try:
                conn = Client(("127.0.0.1", port),
                              authkey=bytes.fromhex(key))
                break
            except (ConnectionRefusedError, OSError):
                if time.monotonic() > deadline:
                    proc.terminate()
                    raise RuntimeError(
                        f"replica {idx} did not listen within "
                        f"{self.startup_timeout_s:.0f}s")
                time.sleep(0.1)
        return ReplicaHandle(f"r{idx}", proc, conn)

    def router(self, **kw) -> Router:
        kw.setdefault("workdir", self.workdir)
        return Router(list(self.handles), **kw)

    def stop(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join()
            self._watch_thread = None
        for h in self.handles:
            h.stop()
        if self._tele is not None:
            self._tele.close()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- rolling hot-reload --------------------------------------------------

    def rolling_reload(self, router: Router, *, step: int | None = None,
                       drain_timeout_s: float = 120.0,
                       reload_timeout_s: float = 300.0) -> list[dict]:
        """Reload every replica, one at a time, with zero global downtime:
        drain (router stops feeding it) → wait for its in-flight requests
        to finish → reload → undrain. N−1 replicas serve at every moment;
        the router's drain guard refuses to take the last one offline.

        Returns one evidence record per replica."""
        results = []
        for h in self.handles:
            router.drain(h.name)
            try:
                deadline = time.monotonic() + drain_timeout_s
                while router.inflight(h.name) > 0:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{h.name}: {router.inflight(h.name)} requests "
                            f"still in flight after {drain_timeout_s:.0f}s "
                            f"drain")
                    time.sleep(0.002)
                rec = h.call("reload", step=step, timeout=reload_timeout_s)
                results.append({"replica": h.name, **(rec or {})})
                if self._tele is not None:
                    self._tele.recovery(None, "rolling-reload",
                                        replica=h.name,
                                        replica_process=_proc_of(h.name),
                                        params_version=(rec or {}).get(
                                            "params_version"))
            finally:
                router.undrain(h.name)
        return results

    # -- failure handling ----------------------------------------------------

    def _warm_from_peer(self, nh) -> dict | None:
        """Warm a relaunched replica's weights from an alive peer instead of
        disk: export the donor's serving params (numpy + digest over the
        socket), import them into the newcomer, which re-hashes before
        swapping. The relaunch already serves *something* (spec seed or
        whatever the checkpoint dir holds); this replaces it with the exact
        tree the survivors are serving — no stale-version window, no
        checkpoint round trip. Returns the warm-up record, or None when no
        donor is alive or the transfer failed (the replica then keeps its
        disk/seed params — degraded, not down)."""
        donor = next(
            (h for h in self.handles if h is not nh and h.alive), None)
        if donor is None:
            return None
        try:
            t0 = time.monotonic()
            exported = donor.call("export_params",
                                  timeout=self.startup_timeout_s)
            rec = nh.call("import_params", params=exported["params"],
                          version=exported["version"],
                          digest=exported["digest"],
                          timeout=self.startup_timeout_s)
            return {"donor": donor.name,
                    "wall_s": round(time.monotonic() - t0, 6),
                    **(rec or {})}
        except Exception:  # noqa: BLE001 — warm-up is best-effort: a failed
            # transfer must not turn one dead replica into two
            logger.exception("fleet: warm-up of %s from peer failed; "
                             "serving its own restore", nh.name)
            return None

    def restart_dead(self, router: Router | None = None) -> list[str]:
        """Relaunch every dead replica (bumped ``DLS_RESTART`` ordinal),
        warm its weights from an alive peer (:meth:`_warm_from_peer`), and
        swap the new handle into the router. Returns restarted names."""
        restarted = []
        for i, h in enumerate(self.handles):
            if h.alive:
                continue
            rc = h.proc.poll()
            self._ordinals[i] = self._ordinals.get(i, 0) + 1
            logger.warning("fleet: replica %s died (rc=%s); restarting "
                           "(ordinal %d)", h.name, rc, self._ordinals[i])
            h.stop(timeout=1.0)
            proc, port, key = self._spawn(i)
            nh = self._connect(i, proc, port, key)
            nh.call("ping", timeout=self.startup_timeout_s)
            warm = self._warm_from_peer(nh)
            self.handles[i] = nh
            if router is not None:
                router.replace(nh)
            if self._tele is not None:
                # replica_process is the incident-correlation stamp: the
                # health engine's alert evidence names replicas by their
                # telemetry stream ("p0"), the fleet by handle ("r0") —
                # both on the event lets the timeline join them
                self._tele.recovery(None, "replica-restart",
                                    replica=nh.name,
                                    replica_process=_proc_of(nh.name),
                                    returncode=rc,
                                    ordinal=self._ordinals[i],
                                    warmed_from=(warm or {}).get("donor"))
                if warm is not None:
                    self._tele.recovery(
                        None, "replica-warmup", replica=nh.name,
                        replica_process=_proc_of(nh.name),
                        donor=warm["donor"], wall_s=warm["wall_s"],
                        digest=warm.get("digest"),
                        params_version=warm.get("params_version"))
            restarted.append(nh.name)
        return restarted

    def watch(self, router: Router, *, interval_s: float = 1.0) -> None:
        """Background liveness watcher: restart dead replicas while the
        router keeps routing around them. Stopped by :meth:`stop`."""
        if self._watch_thread is not None:
            return

        def loop():
            while not self._watch_stop.wait(interval_s):
                try:
                    self.restart_dead(router)
                except Exception:  # noqa: BLE001 — the watcher must outlive
                    logger.exception("fleet watch: restart failed")

        self._watch_thread = threading.Thread(
            target=loop, name="dlserve-fleet-watch", daemon=True)
        self._watch_thread.start()


if __name__ == "__main__":
    sys.exit(replica_main())

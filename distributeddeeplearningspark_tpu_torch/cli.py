"""The port's ``dlsubmit``: launch a training script as a data-parallel gang.

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        [--name app] [--conf k=v ...] [--num-executors N] [--workdir DIR] \\
        [--tenant T] [--priority P] script.py [script args ...]

The launch flags of the JAX package's ``dlsubmit`` (its ``cli.py``), without
``--cluster``. Where that ``dlsubmit`` runs the script in its own process
(``local[N]`` is N devices of one process), this one starts one process per
executor: N children running ``sys.executable script.py args`` (a fresh
interpreter each, never a fork). Each child gets

- ``DLS_COORDINATOR=127.0.0.1:<port>`` (a free port, found by binding port
  0), ``DLS_NUM_PROCESSES=N`` and ``DLS_PROCESS_ID=r``, from which its
  ``Session`` joins the process group (NCCL on the card, gloo on the CPU);
- the session conf as ``DLS_CONF_*`` (``--master``, ``--name``,
  ``--num-executors`` and each ``--conf``);
- ``DLS_TELEMETRY_DIR`` (``--workdir``), ``DLS_TENANT`` and
  ``DLS_PRIORITY``, which the telemetry writer stamps on every event;
- the port's package on ``PYTHONPATH``;
- unless the caller set it, ``OMP_NUM_THREADS`` = the host's cores over
  N, as ``torchrun`` does: N ranks each sizing its thread pool to every
  core would oversubscribe the host many times over.

N is ``spark.executor.instances`` (``--num-executors``), else the N of
``local[N]``; a wildcard master (``local[*]``, ``auto``) takes every visible
card (one process on the CPU). The launcher waits for the gang: it exits
0 when every rank exits 0, and otherwise with the first non-zero exit code
(128 + the signal for a rank killed by one), after terminating the other
ranks and their process groups. A rank that never reaches its peers fails
at the group's rendezvous timeout (``session.GROUP_TIMEOUT_S``), so a gang
never hangs.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.parallel.mesh import devices_from_conf
from distributeddeeplearningspark_tpu_torch.utils.env import (
    COORDINATOR_ENV,
    NUM_PROCESSES_ENV,
    PROCESS_ID_ENV,
    conf_to_env,
)

#: seconds a terminated rank gets before it is killed
TERMINATE_GRACE_S = 5.0
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributeddeeplearningspark_tpu_torch.cli",
        description="Launch a training script as one process per executor "
                    "(spark-submit-shaped).")
    p.add_argument("--master", default=None, help="local[N] | local[*] | auto")
    p.add_argument("--name", "--app-name", dest="name", default=None)
    p.add_argument("--conf", action="append", default=[], metavar="KEY=VALUE",
                   help="session conf entry (repeatable)")
    p.add_argument("--num-executors", type=int, default=None,
                   help="alias for --conf spark.executor.instances=N")
    p.add_argument("--workdir", default=None,
                   help="run directory: telemetry events append to "
                        "<workdir>/telemetry, where `dlstatus <workdir>` reads them")
    p.add_argument("--tenant", default=None,
                   help="tenant stamped on every telemetry record (DLS_TENANT)")
    p.add_argument("--priority", type=int, default=None,
                   help="priority stamped on every telemetry record (DLS_PRIORITY)")
    p.add_argument("script", help="the script each rank runs")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def parse_conf(args: argparse.Namespace) -> dict[str, str]:
    conf: dict[str, str] = {}
    for entry in args.conf:
        if "=" not in entry:
            raise SystemExit(f"--conf expects KEY=VALUE, got {entry!r}")
        k, _, v = entry.partition("=")
        conf[k] = v
    if args.master:
        conf["spark.master"] = args.master
    if args.name:
        conf["spark.app.name"] = args.name
    if args.num_executors is not None:
        conf["spark.executor.instances"] = str(args.num_executors)
    return conf


def num_processes(conf: dict[str, str]) -> int:
    """How many ranks the launch conf asks for."""
    n = devices_from_conf(conf.get("spark.master"), conf)
    if n is not None:
        return n
    if conf.get("spark.dls.device", "cuda") == "cpu":
        return 1
    import torch

    n = torch.cuda.device_count()
    if n < 1:
        raise SystemExit("master asks for every card, and CUDA sees none; pass "
                         "--conf spark.dls.device=cpu to run on the CPU")
    return n


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(conf: dict[str, str], args: argparse.Namespace, *, world: int,
              rank: int, port: int) -> dict[str, str]:
    env = dict(os.environ)
    env.update(conf_to_env(conf))
    env[COORDINATOR_ENV] = f"127.0.0.1:{port}"
    env[NUM_PROCESSES_ENV] = str(world)
    env[PROCESS_ID_ENV] = str(rank)
    if args.workdir:
        env[telemetry.WORKDIR_ENV] = os.path.abspath(args.workdir)
    if args.tenant:
        env[telemetry.TENANT_ENV] = args.tenant
    if args.priority is not None:
        env[telemetry.PRIORITY_ENV] = str(args.priority)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _PKG_PARENT + (os.pathsep + path if path else "")
    return env


def _exit_code(returncode: int) -> int:
    return 128 - returncode if returncode < 0 else returncode


def _stop(procs: list[subprocess.Popen]) -> None:
    """Terminate every live rank's process group, then kill what is left."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + TERMINATE_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        try:  # the group too: a rank's own children (e.g. a kernel build)
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def launch(script: str, script_args: list[str], conf: dict[str, str],
           args: argparse.Namespace, world: int) -> int:
    """Run the gang to its end; the first non-zero rank exit code, else 0."""
    port = free_port()
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, script, *script_args],
                env=child_env(conf, args, world=world, rank=rank, port=port),
                start_new_session=True))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return _exit_code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    conf = parse_conf(args)
    if not os.path.exists(args.script):
        raise SystemExit(f"dlsubmit: script not found: {args.script}")
    world = num_processes(conf)
    # a terminated launcher still stops its gang (launch's finally)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    return launch(os.path.abspath(args.script), args.script_args, conf, args,
                  world)


if __name__ == "__main__":
    sys.exit(main())

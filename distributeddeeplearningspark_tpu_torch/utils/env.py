"""The ``DLS_*`` launch contract, the port's own copy.

The port of the jax-free half of ``distributeddeeplearningspark_tpu/
utils/env.py`` and of ``cli.py``'s conf hand-off. A launcher (the port's
:mod:`..cli`) starts one process per executor and gives each:

- ``DLS_COORDINATOR`` — ``host:port`` of rank 0's rendezvous store;
- ``DLS_NUM_PROCESSES`` — the world size;
- ``DLS_PROCESS_ID`` — this process's rank;
- ``DLS_CONF_<key>`` — session conf, dots written as ``__``
  (``DLS_CONF_spark__master=local[2]``).

:func:`process_identity` is the lenient reader the telemetry writer stamps
events with: a malformed value degrades to one process, so a crashed
worker's last event is still written. :func:`distributed_env` is the strict
reader a :class:`~..session.Session` joins its process group from: a
malformed or inconsistent value raises.
"""

from __future__ import annotations

import dataclasses
import os

COORDINATOR_ENV = "DLS_COORDINATOR"
NUM_PROCESSES_ENV = "DLS_NUM_PROCESSES"
PROCESS_ID_ENV = "DLS_PROCESS_ID"
#: env var prefix that carries session conf from the launcher to the script
CONF_ENV_PREFIX = "DLS_CONF_"


def process_identity() -> tuple[int, int]:
    """This host's (process index, process count) from ``DLS_PROCESS_ID`` /
    ``DLS_NUM_PROCESSES``; a malformed value degrades to one process."""
    try:
        index = int(os.environ.get(PROCESS_ID_ENV, "0"))
    except ValueError:
        index = 0
    try:
        count = int(os.environ.get(NUM_PROCESSES_ENV, "1"))
    except ValueError:
        count = 1
    # a contract violation (id >= count) still yields a usable identity
    return max(0, index), max(1, count, index + 1)


def conf_to_env(conf: dict[str, str]) -> dict[str, str]:
    """Session conf as ``DLS_CONF_*`` variables (the launcher's side)."""
    return {CONF_ENV_PREFIX + k.replace(".", "__"): str(v)
            for k, v in conf.items()}


def conf_from_env() -> dict[str, str]:
    """Session conf exported by the launcher (the script's side)."""
    return {k[len(CONF_ENV_PREFIX):].replace("__", "."): v
            for k, v in os.environ.items() if k.startswith(CONF_ENV_PREFIX)}


@dataclasses.dataclass(frozen=True)
class DistributedEnv:
    """A process's place in its gang, as the launcher gave it."""

    coordinator: str
    world_size: int
    rank: int

    @property
    def init_method(self) -> str:
        return f"tcp://{self.coordinator}"


def distributed_env() -> DistributedEnv | None:
    """The gang this process belongs to, or None when no launcher set the
    contract (none of the three variables is set).

    Strict: a missing companion variable, a value that is not an integer,
    a world size below 1, a rank outside ``[0, world)`` or a coordinator
    that is not ``host:port`` raises ``ValueError``."""
    names = (COORDINATOR_ENV, NUM_PROCESSES_ENV, PROCESS_ID_ENV)
    raw = {n: os.environ.get(n) for n in names}
    if all(v is None for v in raw.values()):
        return None
    missing = [n for n, v in raw.items() if not v]
    if missing:
        raise ValueError(f"launch env incomplete: {missing} unset while "
                         f"{[n for n in names if n not in missing]} are set")
    try:
        world = int(raw[NUM_PROCESSES_ENV])
        rank = int(raw[PROCESS_ID_ENV])
    except ValueError:
        raise ValueError(
            f"malformed launch env: {NUM_PROCESSES_ENV}="
            f"{raw[NUM_PROCESSES_ENV]!r}, {PROCESS_ID_ENV}="
            f"{raw[PROCESS_ID_ENV]!r} must be integers") from None
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"malformed launch env: rank {rank} of world "
                         f"{world}")
    host, sep, port = raw[COORDINATOR_ENV].rpartition(":")
    if not (sep and host and port.isdigit() and 0 < int(port) < 65536):
        raise ValueError(f"malformed launch env: {COORDINATOR_ENV}="
                         f"{raw[COORDINATOR_ENV]!r} is not host:port")
    return DistributedEnv(raw[COORDINATOR_ENV], world, rank)

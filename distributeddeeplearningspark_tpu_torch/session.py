"""Session lifecycle — the SparkSession surface over one device.

The port of ``distributeddeeplearningspark_tpu/session.py``: the same
builder, ::

    spark = Session.builder.master("local[1]").appName("bert").getOrCreate()
    docs = spark.parallelize(lines)
    ... train ...
    spark.stop()

but ``getOrCreate`` binds one torch device instead of a JAX mesh: the card
(``cuda``) unless the caller asks for the CPU with
``.config("spark.dls.device", "cpu")``, and it raises without CUDA
otherwise. Master URLs: ``local[1]``, and ``local``/``local[*]``/``auto``
when they come to one device. A master that asks for more than one device
raises ``NotImplementedError``: data parallelism over several cards (NCCL)
arrives with its own slice of the port.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Iterable, Sequence

import torch

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch")

#: conf key naming the device: "cuda" (the default) or "cpu"
DEVICE_CONF = "spark.dls.device"

_LOCK = threading.Lock()


class Session:
    """An active session bound to one device. Construct via
    ``Session.builder`` (SparkSession-style)."""

    _active: "Session | None" = None

    def __init__(self, app_name: str, conf: dict[str, str], device: torch.device):
        self.app_name = app_name
        self.conf = dict(conf)
        self.device = device
        self._stopped = False

    class Builder:
        def __init__(self) -> None:
            self._conf: dict[str, str] = {}

        def appName(self, name: str) -> "Session.Builder":
            self._conf["spark.app.name"] = name
            return self

        def master(self, master: str) -> "Session.Builder":
            self._conf["spark.master"] = master
            return self

        def config(self, key: str, value: Any) -> "Session.Builder":
            self._conf[key] = str(value)
            return self

        def getOrCreate(self) -> "Session":
            with _LOCK:
                if Session._active is not None and not Session._active._stopped:
                    Session._active.conf.update(self._conf)
                    return Session._active
                sess = _create_session(self._conf)
                Session._active = sess
                return sess

    # ``Session.builder`` yields a fresh Builder per access, like pyspark.
    class _BuilderDescriptor:
        def __get__(self, obj, objtype=None) -> "Session.Builder":
            return Session.Builder()

    builder = _BuilderDescriptor()

    @classmethod
    def get_or_default(cls) -> "Session":
        """The active session, or a default one on the card."""
        if cls._active is not None and not cls._active._stopped:
            return cls._active
        return cls.Builder().getOrCreate()

    def parallelize(self, data: Sequence | Iterable,
                    numSlices: int | None = None) -> PartitionedDataset:
        n = numSlices if numSlices is not None else self.default_parallelism
        return PartitionedDataset.parallelize(data, n)

    @property
    def default_parallelism(self) -> int:
        """Data shards: one, the session's one device."""
        return 1

    @property
    def num_devices(self) -> int:
        return 1

    def stop(self) -> None:
        self._stopped = True
        if Session._active is self:
            Session._active = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        return f"Session(app={self.app_name!r}, device={self.device})"


def _devices_asked(master: str | None, device: torch.device) -> int:
    """How many devices ``master`` asks for on ``device``'s kind."""
    if master in (None, "auto", "local", "local[*]"):
        return torch.cuda.device_count() if device.type == "cuda" else 1
    if master.startswith("local[") and master.endswith("]") \
            and master[len("local["):-1].isdigit():
        return int(master[len("local["):-1])
    raise ValueError(f"unrecognized master URL: {master!r}")


def _create_session(conf: dict[str, str]) -> Session:
    device = resolve_device(conf.get(DEVICE_CONF, "cuda"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    master = conf.get("spark.master")
    n = _devices_asked(master, device)
    if n < 1:
        raise ValueError(f"master {master!r} asks for no device")
    if n > 1:
        raise NotImplementedError(
            f"master {master!r} asks for {n} devices: the port runs on one "
            f"device until its data-parallel slice (NCCL gradient "
            f"all-reduce) lands; use local[1]")
    app = conf.get("spark.app.name", "dls-torch")
    logger.info("session %s on %s", app, device)
    return Session(app, conf, device)

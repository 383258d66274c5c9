"""Session lifecycle — the SparkSession surface over a process group.

The port of ``distributeddeeplearningspark_tpu/session.py``: the same
builder, ::

    spark = Session.builder.master("local[2]").appName("mnist").getOrCreate()
    docs = spark.parallelize(lines)
    ... train ...
    spark.stop()

The process model differs from the JAX package's. There, ``local[N]`` is N
devices in one process, and several hosts join through the ``DLS_*`` env
contract. Here **an executor is a process holding one device** (the torch
idiom, and the reference Spark's own model): the port's launcher,
``python -m distributeddeeplearningspark_tpu_torch.cli --master local[N]
script.py``, starts N processes, and each one's ``getOrCreate`` joins a
``torch.distributed`` group from ``DLS_COORDINATOR``,
``DLS_NUM_PROCESSES`` and ``DLS_PROCESS_ID`` (``init_method=
"tcp://$DLS_COORDINATOR"``): backend ``nccl`` with rank r on ``cuda:r``,
or ``gloo`` on the CPU. A gang of one (the launcher at ``local[1]``) still
forms the group, and the train step's all-reduce runs over it.

- ``local[N]`` with N > 1 outside such a launch raises ``ValueError``
  (launch through the cli); so does a world larger than the visible cards
  ("needs N devices, only M available") and a malformed ``DLS_*`` value.
- ``local[1]`` (or a wildcard master on one card) outside a launch forms
  no group: one device, no all-reduce.
- The device is the card unless the caller asks for the CPU with
  ``.config("spark.dls.device", "cpu")``; without CUDA it raises. There is
  no fallback: no CPU in place of a missing card, no gloo in place of a
  failing NCCL.
- ``spark.dls.deterministic=true`` turns on deterministic algorithms
  (``torch.use_deterministic_algorithms``, cuDNN without autotuning) for
  the session's life, so a resumed run repeats an uninterrupted one bit
  for bit on the card as on the CPU.

Conf exported by the launcher (``DLS_CONF_*``) is read first; the
builder's ``.master()``/``.config()`` win over it.

``Session.mesh`` is the mesh over the gang (:mod:`.parallel.mesh`): its
``shape`` is JAX's ``Session.mesh.shape``, and the global batch is split
``data × fsdp`` ways, one share for each batch coordinate (the ``seq``
and ``tensor`` peers of a coordinate take the same rows; the ``seq``
peers each a block of their sequence; the ``pipe`` peers, the same rows).
With ``mesh.fsdp``, ``mesh.seq`` or ``mesh.tensor`` above 1 (the JAX Llama
driver's ``mesh.data=1, mesh.fsdp=-1, mesh.seq=C, mesh.tensor=T``), or
``mesh.pipe`` or ``mesh.expert`` above 1,
the session builds a
``torch.distributed`` ``DeviceMesh`` over its group with
``init_device_mesh``, one dim for each axis above 1, named as the JAX
axis, on the session's device type, and the process groups over the
batch axes, the loss axes (``data × fsdp × seq``), the shard axes (with
and without ``pipe``), ``pipe``, ``expert``, ``seq`` and ``tensor``
(``Mesh.group``); ``Trainer(rules=...)`` shards
parameters over it (:mod:`.parallel.sharding`). Such a mesh without a
group raises.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import Any, Iterable, Sequence

import torch

from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    BATCH_AXES,
    LOSS_AXES,
    MESH_AXES,
    SHARD_AXES,
    STAGE_SHARD_AXES,
    Mesh,
    MeshSpec,
    devices_from_conf,
    group_ranks,
    num_data_shards,
    spec_from_conf,
)
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device
from distributeddeeplearningspark_tpu_torch.utils.env import (
    DistributedEnv,
    conf_from_env,
    distributed_env,
)

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch")

#: conf key naming the device: "cuda" (the default) or "cpu"
DEVICE_CONF = "spark.dls.device"
#: conf key turning on deterministic algorithms ("true"/"false")
DETERMINISTIC_CONF = "spark.dls.deterministic"
#: seconds the group's rendezvous and each collective may take: a gang
#: whose peer never arrives fails instead of hanging
GROUP_TIMEOUT_S = 120.0

_LOCK = threading.Lock()


class Session:
    """An active session: one device, and the process group when launched
    as a gang. Construct via ``Session.builder`` (SparkSession-style)."""

    _active: "Session | None" = None

    def __init__(self, app_name: str, conf: dict[str, str], device: torch.device,
                 spec: MeshSpec | None = None, *, rank: int = 0,
                 world_size: int = 1, group: bool = False, device_mesh=None,
                 groups: dict | None = None):
        self.app_name = app_name
        self.conf = dict(conf)
        self.device = device
        self.spec = spec or MeshSpec(data=world_size)
        #: the mesh over the gang: ``mesh.shape`` ``{axis: size}``, and the
        #: ``DeviceMesh`` and the axes' groups when ``fsdp``, ``expert``,
        #: ``seq`` or ``tensor`` is above 1
        self.mesh = Mesh(self.spec.shape(world_size), device_mesh, groups or {},
                         rank=rank)
        self.rank = rank
        self.world_size = world_size
        #: True when this session formed a ``torch.distributed`` group
        self.distributed = group
        self._restore_determinism: tuple | None = None
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
                # launch conf arrives through the env and loses to the
                # script's own .master()/.config() calls
                sess = _create_session({**conf_from_env(), **self._conf})
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
    def read(self):
        """``spark.read`` — the DataFrame reader (config 4's feature entry
        point): ``spark.read.option("sep", "\\t").schema([...]).csv(path)``,
        at :attr:`default_parallelism` partitions."""
        from distributeddeeplearningspark_tpu_torch.data.dataframe import DataFrameReader

        return DataFrameReader(default_parallelism=self.default_parallelism)

    def createDataFrame(self, rows, numSlices: int | None = None):
        """Columnarize driver-side rows into a :class:`~.data.dataframe.DataFrame`."""
        from distributeddeeplearningspark_tpu_torch.data.dataframe import from_rows

        n = numSlices if numSlices is not None else self.default_parallelism
        return from_rows(rows, num_partitions=n)

    create_dataframe = createDataFrame

    @property
    def default_parallelism(self) -> int:
        """Data shards: one per process of the gang."""
        return num_data_shards(self.mesh.shape)

    @property
    def num_devices(self) -> int:
        return self.world_size

    @property
    def backend(self) -> str | None:
        """The group's backend (``"nccl"``/``"gloo"``), None without one."""
        if not self.distributed:
            return None
        import torch.distributed as dist

        return str(dist.get_backend())

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self.distributed:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        if self._restore_determinism is not None:
            _set_determinism(*self._restore_determinism)
            self._restore_determinism = None
        if Session._active is self:
            Session._active = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        return (f"Session(app={self.app_name!r}, device={self.device}, "
                f"rank={self.rank}, world_size={self.world_size})")


def _set_determinism(algorithms: bool, cudnn_deterministic: bool,
                     cudnn_benchmark: bool) -> None:
    torch.use_deterministic_algorithms(algorithms)
    torch.backends.cudnn.deterministic = cudnn_deterministic
    torch.backends.cudnn.benchmark = cudnn_benchmark


def _join_group(env: DistributedEnv, device: torch.device) -> None:
    """Join the gang's process group (NCCL on a card, gloo on the CPU) and
    prove the connection with one all-reduce. The rendezvous and every
    collective are bounded by :data:`GROUP_TIMEOUT_S`."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed group already exists in this "
                           "process; stop its Session first")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=env.init_method,
                            world_size=env.world_size, rank=env.rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != env.world_size:
        raise RuntimeError(f"group probe summed to {probe.item()}, want "
                           f"{env.world_size}")


def _device_mesh(shape: dict[str, int], rank: int, device: torch.device
                 ) -> tuple[Any, dict]:
    """The ``DeviceMesh`` over the gang's group, one dim for each axis above
    1 in ``MESH_AXES`` order (rank r at JAX's device r), and this rank's
    process groups over ``BATCH_AXES``, ``LOSS_AXES``, ``SHARD_AXES``,
    ``STAGE_SHARD_AXES``, ``pipe``, ``expert``, ``seq`` and ``tensor``
    where they do not span the gang: a
    ``DeviceMesh`` dim's group where one axis of them is above 1, else made
    here (every rank makes every group, in the same order, as
    ``new_group`` needs)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(a for a in MESH_AXES if shape[a] > 1)
    mesh = init_device_mesh(device.type, tuple(shape[a] for a in names),
                            mesh_dim_names=names)
    world = mesh.size()
    groups, by_wide = {}, {}
    pipe = (STAGE_SHARD_AXES, (AXIS_PIPE,)) if shape[AXIS_PIPE] > 1 else ()
    for axes in (BATCH_AXES, LOSS_AXES, SHARD_AXES, *pipe, (AXIS_EXPERT,), (AXIS_SEQ,),
                 (AXIS_TENSOR,)):
        wide = tuple(a for a in axes if shape[a] > 1)
        size = 1
        for a in wide:
            size *= shape[a]
        if size == world:
            continue
        if wide in by_wide:  # the same ranks (the loss group at seq 1)
            groups[axes] = by_wide[wide]
            continue
        if len(wide) == 1:
            groups[axes] = by_wide[wide] = mesh.get_group(wide[0])
            continue
        for ranks in group_ranks(shape, axes):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = by_wide[wide] = g
    return mesh, groups


def _create_session(conf: dict[str, str]) -> Session:
    device = resolve_device(conf.get(DEVICE_CONF, "cuda"))
    master = conf.get("spark.master")
    spec = spec_from_conf(master, conf)
    requested = devices_from_conf(master, conf)
    env = distributed_env()
    world = env.world_size if env is not None else 1
    if env is None and requested not in (None, 1):
        raise ValueError(
            f"master {master!r} asks for {requested} executors: in the port "
            f"an executor is a process; launch the script through "
            f"`python -m distributeddeeplearningspark_tpu_torch.cli "
            f"--master local[{requested}] script.py`")
    if env is not None and requested not in (None, world):
        raise ValueError(f"master {master!r} asks for {requested} executors, "
                         f"the launch started {world} processes")
    # the mesh's shape over this gang (an axis that cannot fit raises here)
    shape = spec.shape(world)
    if device.type == "cuda":
        available = torch.cuda.device_count()
        if env is None and requested is None and available > 1:
            raise ValueError(
                f"master {master!r} asks for all {available} devices: launch "
                f"the script through `python -m "
                f"distributeddeeplearningspark_tpu_torch.cli`, one process "
                f"per device")
        if world > available:
            raise ValueError(f"master {master!r} needs {world} devices, only "
                             f"{available} available")
        index = env.rank if env is not None else (
            device.index if device.index is not None
            else torch.cuda.current_device())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    sess_kw: dict[str, Any] = {}
    restore = None
    if conf.get(DETERMINISTIC_CONF, "false").lower() == "true":
        restore = (torch.are_deterministic_algorithms_enabled(),
                   torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark)
        # cuBLAS reads its workspace rule when its handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        _set_determinism(True, True, False)
    if env is not None:
        _join_group(env, device)
        sess_kw = dict(rank=env.rank, world_size=env.world_size, group=True)
        if any(shape[a] > 1 for a in (AXIS_FSDP, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ,
                                      AXIS_TENSOR)):
            sess_kw["device_mesh"], sess_kw["groups"] = _device_mesh(
                shape, env.rank, device)
    app = conf.get("spark.app.name", "dls-torch")
    sess = Session(app, conf, device, spec, **sess_kw)
    sess._restore_determinism = restore
    logger.info("session %s on %s, rank %d of %d%s", app, device, sess.rank,
                sess.world_size, f" ({sess.backend})" if sess.distributed else "")
    return sess

"""Mesh shape — the six named axes of the JAX package, over processes.

The port of ``distributeddeeplearningspark_tpu/parallel/mesh.py``'s
:class:`MeshSpec`: the same axis names in the same order (``data``,
``fsdp``, ``pipe``, ``expert``, ``seq``, ``tensor``), at most one axis
``-1`` absorbing every device, and the same conf keys, parsed as the JAX
``Session`` parses them (``local[N]``, ``mesh.<axis>``, ``mesh.data``,
``spark.executor.instances``, the last winning for ``data``).

In the port an executor is a process holding one device, so a mesh spans
the processes of a ``torch.distributed`` group, rank r at the coordinates
of device r of the JAX mesh (row-major over ``MESH_AXES``, ``tensor``
innermost). Every axis is ported, alone or together (``pipe`` with
``data``, ``fsdp`` and ``tensor`` only): ``fsdp > 1`` shards parameters over
the gang (FSDP2, :mod:`.sharding`), the JAX Llama driver's layout
(``mesh.data=1, mesh.fsdp=-1``); ``data × fsdp`` is HSDP; ``tensor > 1`` splits the
layers over ``llama_rules``' ``tensor`` entries (``DTensor``), and the
ranks that differ only in their ``tensor`` coordinate take the same rows
of every batch; ``seq > 1`` is context parallelism: the ranks that differ
only in their ``seq`` coordinate take the same rows, each its block of
the sequence (:mod:`..ops.ring_attention`, :mod:`..ops.ulysses`);
``expert > 1`` is expert parallelism: ``llama_rules`` splits the MoE
expert bank's experts over it (:mod:`..models.moe`), and the ranks that
differ only in their ``expert`` coordinate take the same rows, as
``tensor`` peers do. ``pipe > 1`` is the GPipe pipeline
(:mod:`.pipeline`, :mod:`..models.llama_pp`): the ranks that differ only
in their ``pipe`` coordinate hold a stage of the layers each and take the
same rows, as in JAX, where ``pipe`` is in neither ``BATCH_AXES`` nor
``LOSS_AXES``. Two groups then differ: the *batch* group over
``BATCH_AXES`` (who takes distinct rows) and the *loss* group over
``LOSS_AXES`` (over whom losses, metrics and gradients are summed).
``pipe`` beside ``seq`` or ``expert`` raises ``NotImplementedError``
naming ROADMAP Queue 1 item 10: the JAX package has no tested path there.

One deliberate difference from the JAX ``Session``: there, ``local[N]``
with ``mesh.tensor=T`` asks for N·T devices (``--tensor`` "peels off
chips" within each of N executors); here ``local[N]`` is the launch's N
processes, and a ``-1`` axis absorbs what the others leave, so JAX's
``local[N]`` at ``tensor=T`` is the port's ``local[N·T]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"

#: fixed axis order, outermost first (the JAX package's ``MESH_AXES``)
MESH_AXES: tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_EXPERT,
                              AXIS_SEQ, AXIS_TENSOR)

#: the axes the global batch is split over
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)
#: the axes the global batch's tokens are split over: losses, metrics and
#: gradients are summed across them (the ``seq`` peers of a batch shard
#: hold the blocks of its rows)
LOSS_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)
#: the axes that shard parameters: each distinct shard lies once in a group
#: over them, so a norm over shards sums across it and never across ``data``
SHARD_AXES = (AXIS_FSDP, AXIS_EXPERT, AXIS_TENSOR)
#: the shard axes and ``pipe``: a norm over a pipeline's stages sums the
#: squares of each stage's own layers across it
STAGE_SHARD_AXES = SHARD_AXES + (AXIS_PIPE,)

#: master URLs that ask for every local device
WILDCARD_MASTERS = (None, "auto", "local", "local[*]")

#: the axes the pipeline does not compose with yet → their ROADMAP item
_NOT_BESIDE_PIPE = {
    AXIS_SEQ: "the pipeline beside context parallelism: ROADMAP Queue 1 item 10",
    AXIS_EXPERT: "the pipeline beside expert parallelism: ROADMAP Queue 1 item 10",
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; ``-1`` means "absorb all remaining devices".
    At most one axis may be ``-1``."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def __post_init__(self) -> None:
        for axis in MESH_AXES:
            n = getattr(self, axis)
            if n == 0 or n < -1:
                raise ValueError(f"mesh {axis} axis must be >= 1 or -1, got {n}")
        beside = {a: getattr(self, a) for a in _NOT_BESIDE_PIPE if getattr(self, a) != 1}
        if self.pipe != 1 and beside:
            raise NotImplementedError(
                f"mesh pipe={self.pipe} beside {beside}: the port pipelines "
                f"beside data, fsdp and tensor only; "
                + "; ".join(_NOT_BESIDE_PIPE[a] for a in beside))
        if sum(getattr(self, a) == -1 for a in MESH_AXES) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got spec {self}")

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in MESH_AXES)

    def axis_sizes(self, num_devices: int) -> tuple[int, ...]:
        """Each axis's size over ``num_devices``: the ``-1`` axis takes what
        the others leave (JAX's rule)."""
        sizes = list(self.sizes)
        wild = [i for i, s in enumerate(sizes) if s == -1]
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if num_devices % fixed:
                raise ValueError(f"{num_devices} devices not divisible by fixed "
                                 f"axes {fixed} ({self})")
            sizes[wild[0]] = num_devices // fixed
        if math.prod(sizes) != num_devices:
            raise ValueError(f"mesh spec {tuple(sizes)} needs {math.prod(sizes)} "
                             f"devices, got {num_devices}")
        return tuple(sizes)

    def shape(self, num_devices: int) -> dict[str, int]:
        """``{axis: size}`` over ``num_devices`` (``Mesh.shape``'s form)."""
        return dict(zip(MESH_AXES, self.axis_sizes(num_devices)))


def coordinates(shape: dict[str, int], rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: JAX's device order,
    row-major over ``MESH_AXES`` (``tensor`` innermost)."""
    out = {}
    for axis in reversed(MESH_AXES):
        rank, out[axis] = divmod(rank, shape[axis])
    return {a: out[a] for a in MESH_AXES}


def group_ranks(shape: dict[str, int], axes: Sequence[str]) -> list[list[int]]:
    """The ranks of each group over ``axes``: ranks that share their
    coordinate on every other axis, each group in its coordinates' order."""
    groups: dict[tuple, list[int]] = {}
    for r in range(math.prod(shape.values())):
        c = coordinates(shape, r)
        groups.setdefault(tuple(c[a] for a in MESH_AXES if a not in axes), []).append(r)
    return list(groups.values())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A session's mesh: each axis's size (the JAX ``Mesh.shape``); where
    ``fsdp``, ``pipe``, ``expert``, ``seq`` or ``tensor`` is above 1, the
    ``torch.distributed`` ``DeviceMesh`` over the gang, one dim for each
    axis above 1 named as the JAX axis (None otherwise); the process groups
    over ``BATCH_AXES``, ``LOSS_AXES``, ``SHARD_AXES``, ``STAGE_SHARD_AXES``,
    ``pipe``, ``expert``, ``seq`` and ``tensor`` that do not span the whole
    gang (:meth:`group`); and this process's rank."""

    shape: dict[str, int]
    device_mesh: Any = None
    groups: dict = dataclasses.field(default_factory=dict)
    rank: int = 0

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group of this rank over ``axes`` (a tuple of axis
        names): None where it is the whole gang (``torch.distributed``'s
        default group). Axes the session made no group for (as a collective
        verb may name) take their ``DeviceMesh`` dim's where one of them is
        above 1."""
        axes = tuple(axes)
        if self.size(axes) == math.prod(self.shape.values()):
            return None
        wide = tuple(a for a in axes if self.shape[a] > 1)
        if axes not in self.groups and self.device_mesh is not None and len(wide) == 1:
            self.groups[axes] = self.device_mesh.get_group(wide[0])
        if axes not in self.groups:
            raise RuntimeError(f"mesh {self.shape} has no process group over "
                               f"{axes}: it needs the gang's process group "
                               f"(launch through the port's cli)")
        return self.groups[axes]

    def batch_index(self, rank: int) -> int:
        """Which of the ``data × fsdp`` batch shards rank ``rank`` feeds: its
        coordinate on ``BATCH_AXES`` (tensor peers feed the same)."""
        c = coordinates(self.shape, rank)
        return c[AXIS_DATA] * self.shape[AXIS_FSDP] + c[AXIS_FSDP]

    @property
    def seq_index(self) -> int:
        """This rank's coordinate on ``seq``: which block of each row's
        sequence it holds."""
        return coordinates(self.shape, self.rank)[AXIS_SEQ]

    @property
    def pipe_index(self) -> int:
        """This rank's coordinate on ``pipe``: which stage of the layers it
        runs."""
        return coordinates(self.shape, self.rank)[AXIS_PIPE]

    def pipe_peer(self, stage: int) -> int:
        """The rank of this rank's pipe group at ``stage``: every other
        coordinate its own."""
        c = coordinates(self.shape, self.rank)
        c[AXIS_PIPE] = stage
        r = 0
        for axis in MESH_AXES:
            r = r * self.shape[axis] + c[axis]
        return r


def num_data_shards(shape: dict[str, int]) -> int:
    """How many ways the global batch is split (the executor count)."""
    return shape[AXIS_DATA] * shape[AXIS_FSDP]


def local_n(master: str | None) -> int | None:
    """N of a ``local[N]`` master URL, else None."""
    if master and master.startswith("local[") and master.endswith("]"):
        inner = master[len("local["):-1]
        if inner.isdigit():
            return int(inner)
    return None


def spec_from_conf(master: str | None, conf: dict[str, str]) -> MeshSpec:
    """A master URL and session conf as a :class:`MeshSpec`, by the JAX
    ``Session``'s rules: ``local[N]`` asks for N data shards, a wildcard
    master for all (``data=-1``); ``mesh.<axis>`` sizes the others (``-1``
    included); ``mesh.data`` and then ``spark.executor.instances`` override
    the data axis."""
    axes = {a: int(conf.get(f"mesh.{a}", 1)) for a in MESH_AXES[1:]}
    if master in WILDCARD_MASTERS:
        data = -1
    elif local_n(master) is not None:
        data = local_n(master)
    else:
        raise ValueError(f"unrecognized master URL: {master!r}")
    if "mesh.data" in conf:
        data = int(conf["mesh.data"])
    if conf.get("spark.executor.instances") is not None:
        data = int(conf["spark.executor.instances"])
    return MeshSpec(data=data, **axes)


def devices_from_conf(master: str | None, conf: dict[str, str]) -> int | None:
    """How many devices (processes) a master URL and conf ask for; None for
    every device. A spec without a ``-1`` axis asks for the product of its
    axes; with one, ``local[N]`` asks for N processes, which the ``-1``
    axis spreads over what the other axes leave (JAX's ``local[N]`` with
    ``mesh.data=1, mesh.fsdp=-1`` is N devices over fsdp; at ``tensor=T``
    JAX asks for N·T, the module docstring says why the port does not),
    and a wildcard master for all."""
    spec = spec_from_conf(master, conf)
    if -1 not in spec.sizes:
        return math.prod(spec.sizes)
    return local_n(master)

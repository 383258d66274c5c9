"""Mesh shape — the six named axes of the JAX package, over processes.

The port of ``distributeddeeplearningspark_tpu/parallel/mesh.py``'s
:class:`MeshSpec`: the same axis names in the same order (``data``,
``fsdp``, ``pipe``, ``expert``, ``seq``, ``tensor``), ``data=-1``
absorbing every device, and the same conf keys, parsed as the JAX
``Session`` parses them (``local[N]``, ``mesh.<axis>``, ``mesh.data``,
``spark.executor.instances``, the last winning for ``data``).

In the port an executor is a process holding one device, so a mesh spans
the processes of a ``torch.distributed`` group. Only the ``data`` axis is
ported: a spec with any other axis above 1 raises ``NotImplementedError``
(FSDP and tensor parallelism are ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

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

#: master URLs that ask for every local device
WILDCARD_MASTERS = (None, "auto", "local", "local[*]")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; ``data=-1`` absorbs every device."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def __post_init__(self) -> None:
        beyond = {a: getattr(self, a) for a in MESH_AXES[1:]
                  if getattr(self, a) != 1}
        if beyond:
            raise NotImplementedError(
                f"mesh axes {beyond}: the port shards only the data axis; "
                f"FSDP, tensor, sequence, expert and pipeline axes are "
                f"ROADMAP Queue 1 item 5")
        if self.data == 0 or self.data < -1:
            raise ValueError(f"mesh data axis must be >= 1 or -1, got {self.data}")

    def axis_sizes(self, num_devices: int) -> tuple[int, ...]:
        """Each axis's size over ``num_devices`` (every axis but ``data``
        is 1)."""
        data = num_devices if self.data == -1 else self.data
        if data != num_devices:
            raise ValueError(f"mesh spec needs {data} devices, got {num_devices}")
        return (data,) + (1,) * (len(MESH_AXES) - 1)

    def shape(self, num_devices: int) -> dict[str, int]:
        """``{axis: size}`` over ``num_devices`` (``Mesh.shape``'s form)."""
        return dict(zip(MESH_AXES, self.axis_sizes(num_devices)))


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
    master for all (``data=-1``); ``mesh.data`` and then
    ``spark.executor.instances`` override the data axis."""
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

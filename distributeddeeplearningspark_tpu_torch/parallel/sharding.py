"""Parameter-sharding rules, and their lowering to FSDP2 over the gang.

The port of ``distributeddeeplearningspark_tpu/parallel/sharding.py``. The
reference has two parameter layouts (SURVEY.md §2): replicated everywhere
(LeNet, ResNet, BERT, the DLRM's MLPs) and FSDP-style sharding "across
Spark executors" for Llama-2 7B (config 5). Both come from the same small
rule engine, copied here unchanged, over the port's param names
(``named_parameters()``'s, dots as ``/``: ``layers/0/attention/wq/weight``):

1. explicit regex rules (path pattern → :class:`PartitionSpec`) take
   precedence — tensor-parallel layouts and sharded tables;
2. the auto-FSDP pass then shards the largest still-unsharded, divisible
   dim of every param of at least ``fsdp_min_size`` elements over the
   ``fsdp`` axis (ZeRO-3);
3. everything else stays replicated.

A spec lowers onto the session's ``DeviceMesh`` (:func:`fully_shard_model`)
in torchtitan's order. First its model-parallel entries, ``expert`` and
``tensor``: where one or both are above 1 the param becomes a ``DTensor``
on the sub-mesh of those axes, ``Shard`` on each one's dim, each rank
keeping its chunk (``llama_rules``' Megatron layout and its expert bank;
the model reads the placements and splits its compute,
:mod:`..models.llama`, :mod:`..models.moe`). Then its ``fsdp`` entry: FSDP2's ``fully_shard``
over the batch dims of the mesh (``fsdp``, or ``data × fsdp`` for HSDP:
sharded over ``fsdp``, replicated over ``data``), once on each layer of
the model's layer ``ModuleList``\\ s that holds such a param, then on the
root, each on its rule's dim (``shard_placement_fn``; on a tensor-split
param FSDP2 shards the local chunk, so a rule's ``P("tensor", "fsdp")``
lands as placements ``(Shard(1), Shard(0))`` over ``(fsdp, tensor)``, and
the bank's ``P("expert", "fsdp", "tensor")`` as ``(Shard(1), Shard(0),
Shard(2))`` over ``(fsdp, expert, tensor)``),
every other param handed over as ``ignored_params``. Those keep the
data-parallel path: the train step sums their gradients over the batch
group with ``collectives.all_reduce_grads``. The FSDP-sharded params'
gradients arrive reduce-scattered (and, under HSDP, all-reduced over
``data``), **summed** (FSDP2 averages by default; the train step's loss is
already weighed by each rank's share of the global batch,
``collectives.weigh_loss``). A sharded param is a ``DTensor`` whose local
shard is ``to_local()``; the train step, its optimizer and its guard work
on those shards, so the optimizer state is sharded like its params, as
the JAX ``state_shardings`` lays it out. Each card holds
:func:`bytes_per_card`.

What the lowering cannot place raises, and never trains replicas: a spec
entry on an axis other than ``fsdp``, ``expert`` and ``tensor`` above 1,
two axes above 1 on one dim (FSDP2 would interleave them,
``_StridedShard``), an ``expert`` or ``tensor`` dim that does not divide, a sharded mesh with no
``DeviceMesh``, and a torch whose FSDP2 lacks what the lowering calls.

On a pipeline (a mesh with ``pipe`` above 1, :mod:`.pipeline`) the rules
carry the stage layout (``ShardingRules.stage_of``): a stage's layers lie
on its own cards only, so the model holds no other stage's layers by the
time the rules are lowered (:mod:`..models.llama_pp`), and each of its
params is lowered as above over the sub-mesh of its own pipe coordinate
(``data``, ``fsdp``, ``tensor``): the ``DeviceMesh`` slices of a rank
never cross ``pipe``. :func:`bytes_per_card` reckons a stage's card, and a
stage's params carry their stage (:func:`mark_stage`) for the norms, the
replica checks and the checkpoints.

How the port's layout differs from JAX's: JAX stacks Llama's layers
(``scan_layers``), so each norm scale is one ``[L, H]`` leaf past
``fsdp_min_size`` and sharded; the port's are ``L`` leaves of ``[H]``,
under it, and replicated: at Llama-2 7B a card holds (N−1)/N of their
1.06 MB more than JAX's.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import re
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_TENSOR,
    BATCH_AXES,
    SHARD_AXES,
)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: one entry a dim, each None
    (not sharded), an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def path_str(name: str) -> str:
    """A ``named_parameters()`` name as the rules' path: dots as ``/``."""
    return name.replace(".", "/")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (regex → PartitionSpec) rules plus an auto-FSDP pass.

    ``rules``: first regex (searched, not fullmatch) that matches the
    '/'.joined param path wins.
    ``fsdp``: if True, params with ``size >= fsdp_min_size`` get their largest
    unsharded divisible dim sharded over the ``fsdp`` mesh axis.
    ``fsdp_exclude``: path regexes whose params the auto-FSDP pass must leave
    alone (e.g. LoRA adapters that should stay fully replicated).
    ``mesh`` is anything with a ``shape`` mapping of axis → size: the
    session's :class:`~.mesh.Mesh`, or a JAX ``Mesh``.
    ``stage_pattern`` / ``num_layers``: the pipeline's layout over the
    ``pipe`` axis, JAX's ``P("pipe", ...)`` on the stacked ``[L]`` dim of
    every layer param, which the port's per-layer params do not have: a
    param whose path matches ``stage_pattern`` (its first group the layer
    index i) belongs to stage ``i // (num_layers / pipe)`` and lies on that
    stage's cards only; every other param is replicated over ``pipe``.
    """

    rules: tuple[tuple[str, PartitionSpec], ...] = ()
    fsdp: bool = False
    fsdp_min_size: int = 2**14
    fsdp_exclude: tuple[str, ...] = ()
    stage_pattern: str | None = None
    num_layers: int = 0

    def stage_of(self, path: str, mesh) -> int | None:
        """The pipeline stage that holds the param at ``path`` on ``mesh``;
        None where it is replicated over ``pipe`` (every param at ``pipe``
        1, and every param of rules without a stage layout)."""
        pipe = mesh.shape.get(AXIS_PIPE, 1)
        if pipe == 1 or self.stage_pattern is None:
            return None
        m = re.search(self.stage_pattern, path)
        if m is None:
            return None
        if self.num_layers % pipe:
            raise ValueError(f"num_layers {self.num_layers} must divide by pipe {pipe}")
        return int(m.group(1)) // (self.num_layers // pipe)

    def spec_for(self, path: str, shape: tuple[int, ...], mesh) -> PartitionSpec:
        spec = None
        for pattern, s in self.rules:
            if re.search(pattern, path):
                spec = s
                break
        if spec is None:
            spec = P(*([None] * len(shape)))
        if (
            self.fsdp
            and mesh.shape[AXIS_FSDP] > 1
            and not any(re.search(p, path) for p in self.fsdp_exclude)
        ):
            spec = add_axis_spec(spec, shape, mesh, (AXIS_FSDP,), self.fsdp_min_size)
        return spec

    def tree_specs(self, shapes: dict[str, tuple[int, ...]], mesh
                   ) -> dict[str, PartitionSpec]:
        """The spec of each param, by name, from its shape alone (a 0-d
        param is replicated)."""
        return {n: self.spec_for(path_str(n), tuple(s), mesh) if len(s) else P()
                for n, s in shapes.items()}


def add_axis_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh,
                  axes: tuple[str, ...], min_size: int) -> PartitionSpec:
    """Shard the largest unsharded divisible dim of ``shape`` over ``axes``.

    Leaves smaller than ``min_size`` elements, already mentioning one of
    ``axes``, or with no dim divisible by the axes' total extent stay as
    they were. When more than one axis is given the whole tuple lands on
    ONE dim (divisible by the product); if no dim fits, each axis is tried
    separately, largest-dim first."""
    size = 1
    for d in shape:
        size *= d
    if size < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(_mentions(e, a) for e in entries for a in axes):
        return spec
    extent = 1
    for a in axes:
        extent *= mesh.shape[a]
    if extent <= 1:
        return spec
    candidates = [
        (shape[i], i)
        for i in range(len(shape))
        if entries[i] is None and shape[i] % extent == 0
    ]
    if candidates:
        _, dim = max(candidates)
        entries[dim] = axes[0] if len(axes) == 1 else tuple(axes)
        return P(*entries)
    if len(axes) > 1:
        # no single dim takes the whole tuple: place axes one at a time
        out = spec
        for a in sorted(axes, key=lambda a: -mesh.shape[a]):
            out = add_axis_spec(out, shape, mesh, (a,), min_size)
        return out
    return spec


def _mentions(entry, axis: str) -> bool:
    if entry is None:
        return False
    if isinstance(entry, str):
        return entry == axis
    return axis in entry


#: Pure data parallelism: everything replicated (reference configs 1–4).
REPLICATED = ShardingRules()

#: FSDP over the `fsdp` axis for every large param (reference config 5).
FSDP = ShardingRules(fsdp=True)


# -- the lowering to DTensor and FSDP2 ----------------------------------------------


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_dim(spec: PartitionSpec, axis: str) -> int | None:
    """The dim a spec shards over ``axis``, None where it does not."""
    for i, e in enumerate(spec):
        if _mentions(e, axis):
            return i
    return None


def fsdp_dim(spec: PartitionSpec) -> int | None:
    """The dim a spec shards over ``fsdp``, None where it does not."""
    return axis_dim(spec, AXIS_FSDP)


def _specs(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, PartitionSpec]:
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return rules.tree_specs(shapes, mesh)


def _dims(specs: dict[str, PartitionSpec], mesh, axis: str) -> dict[str, int]:
    if mesh.shape[axis] == 1:
        return {}
    dims = {n: axis_dim(s, axis) for n, s in specs.items()}
    return {n: d for n, d in dims.items() if d is not None}


def shard_dims(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """The params the rules shard over ``fsdp`` on ``mesh``: name → dim."""
    return _dims(_specs(model, rules, mesh), mesh, AXIS_FSDP)


def tensor_dims(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """The params the rules split over ``tensor`` on ``mesh``: name → dim."""
    return _dims(_specs(model, rules, mesh), mesh, AXIS_TENSOR)


def expert_dims(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """The params the rules split over ``expert`` on ``mesh``: name → dim."""
    return _dims(_specs(model, rules, mesh), mesh, AXIS_EXPERT)


#: the model-parallel axes: a spec's entries on them lower to ``DTensor``
#: ``Shard``s on their sub-mesh, the model reading the placements
MODEL_AXES = (AXIS_EXPERT, AXIS_TENSOR)


def bytes_per_card(shapes: dict[str, tuple[int, ...]], itemsizes: dict[str, int],
                   rules: ShardingRules, mesh, stage: int = 0) -> int:
    """The rule engine's reckoning of the param bytes each card holds: a
    param's bytes over the product of the sizes of the mesh axes its spec
    names, a replicated one's whole. ``shapes`` are the whole model's; on
    a pipeline (``rules.stage_of``) a card of ``stage`` holds that stage's
    layers only."""
    total = 0
    for name, spec in rules.tree_specs(shapes, mesh).items():
        if rules.stage_of(path_str(name), mesh) not in (None, stage):
            continue
        nbytes = math.prod(shapes[name]) * itemsizes[name]
        total += nbytes // math.prod(mesh.shape[a] for e in spec for a in _axes(e))
    return total


def is_sharded(t: Any) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (a view: writes to it reach the
    param), any other tensor itself. Taken outside autograd: an in-place
    write to a ``to_local()`` view that autograd tracks is refused."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return t.to_local()


def local_value(t: torch.Tensor) -> torch.Tensor:
    """``local`` inside autograd, for a forward: a ``DTensor``'s local
    shard (its gradient flows back to the ``DTensor``), any other tensor
    itself. What a kernel receives is never a ``DTensor``."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor, gathered from every rank that holds a
    part of it (a collective: every rank calls it), any other tensor
    itself."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return t.full_tensor()


def shard_of(t: DTensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``whole`` (a view) by ``t``'s placements: each
    ``Shard(d)`` over a mesh dim of size n keeps chunk (the rank's
    coordinate) of n along d, as ``DTensor`` and FSDP2 chunk it. No
    collective."""
    from torch.distributed.tensor import Shard

    coord = t.device_mesh.get_coordinate()
    out = whole
    for i, p in enumerate(t.placements):
        if not p.is_shard():
            continue
        if type(p) is not Shard:
            raise NotImplementedError(f"placement {p} (two mesh axes on one dim) "
                                      f"cannot be sliced locally")
        out = out.chunk(t.device_mesh.size(i), p.dim)[coord[i]]
    return out


def assign(t: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` (any device, cast to ``t``'s dtype) into
    ``t`` in place; into its local shard when ``t`` is sharded (every rank
    calls it with the same ``src``, each keeping its shard: no
    collective)."""
    with torch.no_grad():
        src = torch.as_tensor(src).detach()
        if isinstance(t, DTensor):
            dst = t.to_local()
            dst.copy_(shard_of(t, src).to(dst.device, dst.dtype))
        else:
            t.copy_(src.to(t.device, t.dtype))


def resident_param_bytes(model: nn.Module) -> int:
    """The param bytes this card holds: each sharded param's local shard,
    each replicated one whole."""
    return sum(local(p).numel() * p.element_size() for p in model.parameters())


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """How a ``DTensor`` is split over a mesh axis (``tensor``, ``expert``):
    the dim, the 1-D mesh of that axis (None for a tensor on a wider mesh)
    and the axis's group, this rank's index and the size."""

    dim: int
    mesh: Any
    group: Any
    index: int
    size: int


def mesh_split(t: Any, axis: str) -> TensorSplit | None:
    """``t``'s split over the mesh axis ``axis``, None where ``t`` is not a
    ``DTensor`` sharded over it: what a layer reads to run on its shard
    (:mod:`..models.llama`, :mod:`..models.moe`)."""
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return None
    i = names.index(axis)
    p = t.placements[i]
    if not p.is_shard():
        return None
    # a layer's forward sees its weight on the 1-D model-parallel mesh
    # (FSDP2's unsharded param); the sharded param outside one names none
    sub = mesh if mesh.ndim == 1 else None
    return TensorSplit(dim=p.dim, mesh=sub, group=mesh.get_group(i),
                       index=mesh.get_local_rank(i), size=mesh.size(i))


def tensor_split(t: Any) -> TensorSplit | None:
    """``t``'s split over the mesh's ``tensor`` axis (:func:`mesh_split`)."""
    return mesh_split(t, AXIS_TENSOR)


def fsdp_reduced(t: Any) -> bool:
    """True for a param FSDP2 shards over ``fsdp``: its gradient arrives
    reduced from FSDP2's backward."""
    if not isinstance(t, DTensor):
        return False
    names = t.device_mesh.mesh_dim_names or ()
    return AXIS_FSDP in names and t.placements[names.index(AXIS_FSDP)].is_shard()


def norm_share(t: Any, group_size: int, stages: int = 1) -> float:
    """A tensor's weight in a norm summed across the ``SHARD_AXES`` group
    (``STAGE_SHARD_AXES`` on a pipeline of ``stages``) of ``group_size``
    ranks: 0 for a whole tensor every rank of the group holds (counted
    once, on every rank alike); else its distinct shards over the number of
    ranks of the group that hold it (a stage's param: its stage's), so each
    distinct shard's squares count once."""
    owned = pipe_stage(t) is not None
    if not isinstance(t, DTensor):
        return 1.0 / (group_size // stages) if owned else 0.0
    shards = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                       if p.is_shard())
    return shards / (group_size // stages if owned else group_size)


#: the attribute a pipeline stage's param carries: its stage index
_STAGE_ATTR = "_dls_pipe_stage"


def mark_stage(t: torch.Tensor, stage: int) -> None:
    """Tag a param as one that only the cards of pipeline stage ``stage``
    hold (:mod:`.pipeline`): norms, replica checks and checkpoints read it."""
    setattr(t, _STAGE_ATTR, int(stage))


def pipe_stage(t: Any) -> int | None:
    """The pipeline stage a param belongs to (:func:`mark_stage`); None for
    a param every stage holds."""
    return getattr(t, _STAGE_ATTR, None)


def _layer_units(module: nn.Module) -> list[nn.Module]:
    """The layers of the model's outermost ``ModuleList``\\ s, in order."""
    units = []
    for child in module.children():
        if isinstance(child, nn.ModuleList):
            units.extend(child)
        else:
            units.extend(_layer_units(child))
    return units


def _sum_gradients(unit) -> None:
    """Have FSDP2 sum the sharded gradients across ranks (its default is the
    mean): a divide factor of 1, reduced with ``SUM`` (gloo has no
    pre-multiplied sum)."""
    unit.set_gradient_divide_factor(1.0)
    unit.set_force_sum_reduction_for_comms(True)


def _check_placeable(specs: dict[str, PartitionSpec], shapes: dict, mesh) -> None:
    """Raise where the lowering cannot place a spec on ``mesh``."""
    for name, spec in specs.items():
        for dim, e in enumerate(spec):
            wide = [a for a in _axes(e) if mesh.shape[a] > 1]
            other = [a for a in wide if a not in SHARD_AXES]
            if other:
                raise NotImplementedError(
                    f"{name}: spec {spec} shards over {other}; the port lowers "
                    f"fsdp, expert and tensor entries only")
            if len(wide) > 1:
                raise NotImplementedError(
                    f"{name}: spec {spec} puts {wide} on one dim (FSDP2 would "
                    f"interleave them); the lowering places one axis a dim")
        for axis in MODEL_AXES:
            d, size = axis_dim(spec, axis), mesh.shape[axis]
            if d is not None and size > 1 and shapes[name][d] % size:
                raise ValueError(f"{name}: dim {d} of shape {shapes[name]} does "
                                 f"not divide by {axis}={size}")


def _split_over_model_axes(model: nn.Module, specs: dict[str, PartitionSpec],
                           mesh) -> None:
    """Each param whose spec names an axis of ``MODEL_AXES`` above 1 as a
    ``DTensor`` on the sub-mesh of those axes, ``Shard`` on each one's dim:
    this rank keeps its chunk (a copy: the whole is freed)."""
    from torch.distributed.tensor import Shard

    for name, spec in specs.items():
        axes = tuple(a for a in MODEL_AXES
                     if mesh.shape[a] > 1 and axis_dim(spec, a) is not None)
        if not axes:
            continue
        sub = mesh.device_mesh[axes]
        owner, attr = model, name
        if "." in name:
            path, attr = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        p = getattr(owner, attr)
        chunk = p.detach()
        for i, a in enumerate(axes):
            chunk = chunk.chunk(sub.size(i), axis_dim(spec, a))[sub.get_local_rank(i)]
        chunk = chunk.clone(memory_format=torch.contiguous_format)
        dt = DTensor.from_local(chunk, sub, [Shard(axis_dim(spec, a)) for a in axes],
                                run_check=False, shape=p.shape, stride=p.stride())
        owner.register_parameter(attr, nn.Parameter(dt, requires_grad=p.requires_grad))


def fully_shard_model(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """Lower ``rules`` onto ``model`` over ``mesh`` (the session's
    :class:`~.mesh.Mesh`): the ``expert`` and ``tensor`` entries to
    ``DTensor`` on their sub-mesh, then the ``fsdp`` entries with FSDP2 over the
    batch dims (``fully_shard`` once on each layer of its layer
    ``ModuleList``\\ s that holds such a param, then on the root, each on
    its rule's dim, every other param ignored). Works on a model on the
    meta device (then ``to_empty`` and draw the weights, as
    ``Trainer`` does). Returns the ``fsdp``-sharded params' dims by name;
    nothing is sharded (and nothing called) where the rules shard no
    param, as at ``fsdp``, ``expert`` and ``tensor`` 1. Raises where the module
    docstring says: it never falls back to replicas."""
    specs = _specs(model, rules, mesh)
    _check_placeable(specs, {n: tuple(p.shape) for n, p in model.named_parameters()},
                     mesh)
    dims = _dims(specs, mesh, AXIS_FSDP)
    split = any(_dims(specs, mesh, a) for a in MODEL_AXES)
    if not dims and not split:
        return {}
    if mesh.device_mesh is None:
        raise RuntimeError(
            f"mesh {mesh.shape} shards params but has no DeviceMesh: a sharded "
            f"mesh needs the gang's process group (launch through "
            f"`python -m distributeddeeplearningspark_tpu_torch.cli`)")
    if split:
        _split_over_model_axes(model, specs, mesh)
    if not dims:
        return {}
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard

    missing = ({"shard_placement_fn", "ignored_params"}
               - set(inspect.signature(fully_shard).parameters)) | (
        {"set_gradient_divide_factor", "set_force_sum_reduction_for_comms"}
        - set(dir(FSDPModule)))
    if missing:
        raise NotImplementedError(
            f"torch {torch.__version__}'s FSDP2 lacks {sorted(missing)}, which "
            f"the lowering needs: sharding needs a newer torch")
    batch = tuple(a for a in BATCH_AXES if mesh.shape[a] > 1)
    dp_mesh = mesh.device_mesh[batch]
    named = dict(model.named_parameters())
    by_param = {id(named[n]): d for n, d in dims.items()}
    ignored = {p for n, p in named.items() if n not in dims}
    units = [u for u in _layer_units(model)
             if any(id(p) in by_param for p in u.parameters())]
    for unit in units + [model]:
        fully_shard(unit, mesh=dp_mesh, ignored_params=ignored or None,
                    shard_placement_fn=lambda p: Shard(by_param[id(p)]))
        _sum_gradients(unit)
    return dims

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

A spec's only effect in the port is its ``fsdp`` entry: the mesh refuses
every other axis above 1, so a ``tensor`` entry (``llama_rules``) shards
nothing yet (ROADMAP Queue 1 item 5). :func:`fully_shard_model` lowers the
rules onto a module with FSDP2's ``fully_shard``, over the session's
``DeviceMesh``: once on each layer of the model's layer ``ModuleList``\\ s,
then on the root, each param sharded on the rule engine's dim
(``shard_placement_fn``), every param the rules leave replicated handed
over as ``ignored_params``. Those keep the data-parallel path: the train
step sums their gradients with ``collectives.all_reduce_grads``. The
sharded params' gradients arrive reduce-scattered, **summed** across the
ranks (FSDP2 averages by default; the train step's loss is already
weighed by each rank's share of the global batch, ``collectives.
weigh_loss``). A sharded param is a ``DTensor`` whose local shard is
``to_local()``; the train step, its optimizer and its guard work on those
shards, so the optimizer state is sharded like its params, as the JAX
``state_shardings`` lays it out.

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

from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_FSDP


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
    """

    rules: tuple[tuple[str, PartitionSpec], ...] = ()
    fsdp: bool = False
    fsdp_min_size: int = 2**14
    fsdp_exclude: tuple[str, ...] = ()

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


# -- the lowering to FSDP2 --------------------------------------------------------


def fsdp_dim(spec: PartitionSpec) -> int | None:
    """The dim a spec shards over ``fsdp``, None where it does not."""
    for i, e in enumerate(spec):
        if _mentions(e, AXIS_FSDP):
            return i
    return None


def shard_dims(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """The params the rules shard over ``fsdp`` on ``mesh``: name → dim."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    dims = {n: fsdp_dim(s) for n, s in rules.tree_specs(shapes, mesh).items()}
    return {n: d for n, d in dims.items() if d is not None}


def bytes_per_card(shapes: dict[str, tuple[int, ...]], itemsizes: dict[str, int],
                   rules: ShardingRules, mesh) -> int:
    """The rule engine's reckoning of the param bytes each card holds: a
    sharded param's bytes over the ``fsdp`` size, a replicated one's whole."""
    n = mesh.shape[AXIS_FSDP]
    total = 0
    for name, spec in rules.tree_specs(shapes, mesh).items():
        nbytes = math.prod(shapes[name]) * itemsizes[name]
        total += nbytes // n if fsdp_dim(spec) is not None else nbytes
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


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor, gathered from every rank (a
    collective: every rank calls it), any other tensor itself."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return t.full_tensor()


def assign(t: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` (any device, cast to ``t``'s dtype) into
    ``t`` in place; into its local shard when ``t`` is sharded, ``src``
    distributed over ``t``'s mesh by its placements (every rank calls it
    with the same ``src``)."""
    from torch.distributed.tensor import distribute_tensor

    with torch.no_grad():
        src = torch.as_tensor(src).detach().to(t.device, t.dtype)
        if isinstance(t, DTensor):
            shard = distribute_tensor(src, t.device_mesh, t.placements).to_local()
            t.to_local().copy_(shard)
        else:
            t.copy_(src)


def resident_param_bytes(model: nn.Module) -> int:
    """The param bytes this card holds: each sharded param's local shard,
    each replicated one whole."""
    return sum(local(p).numel() * p.element_size() for p in model.parameters())


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


def fully_shard_model(model: nn.Module, rules: ShardingRules, mesh) -> dict[str, int]:
    """Lower ``rules`` onto ``model`` over ``mesh`` (the session's
    :class:`~.mesh.Mesh`) with FSDP2: ``fully_shard`` once on each layer of
    its layer ``ModuleList``\\ s that holds a sharded param, then on the
    root, each sharded param on its rule's dim, every other param ignored
    (replicated). Returns the sharded params' dims by name; nothing is
    sharded (and nothing called) where the rules shard no param, as at
    ``fsdp`` 1. Raises where ``fsdp`` > 1 has no ``DeviceMesh`` (no process
    group) and where this torch's ``fully_shard`` lacks what the lowering
    needs: it never falls back to replicas."""
    dims = shard_dims(model, rules, mesh)
    if not dims:
        return {}
    if mesh.device_mesh is None:
        raise RuntimeError(
            f"mesh {mesh.shape} shards params over fsdp but has no DeviceMesh: "
            f"an fsdp mesh needs the gang's process group (launch through "
            f"`python -m distributeddeeplearningspark_tpu_torch.cli`)")
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
    named = dict(model.named_parameters())
    by_param = {id(named[n]): d for n, d in dims.items()}
    ignored = {p for n, p in named.items() if n not in dims}
    units = [u for u in _layer_units(model)
             if any(id(p) in by_param for p in u.parameters())]
    for unit in units + [model]:
        fully_shard(unit, mesh=mesh.device_mesh, ignored_params=ignored or None,
                    shard_placement_fn=lambda p: Shard(by_param[id(p)]))
        _sum_gradients(unit)
    return dims

"""Plans — one declarative layout object that the Trainer takes.

The port of the part of ``distributeddeeplearningspark_tpu/parallel/
plan.py`` that the ``Trainer`` uses: :class:`Plan` (logical axes → mesh
axes, plus the per-leaf :class:`~.sharding.ShardingRules`), its
validation against a mesh, its record (``to_record``/``from_record``, the
JAX format, so a plan saved by the JAX package loads here and keeps its
``signature``), ``save``/``load``/``describe``, the canned ``DP`` and
``FSDP_PLAN``, and ``plan_for_rules``. In the port a plan's layout is
lowered by :func:`.sharding.fully_shard_model`, not compiled: the JAX
``compile_step_with_plan`` has no counterpart.

A plan's ``seq_axis`` (context parallelism) makes the ``Trainer`` shard
each row's sequence over that axis, as JAX's ``seq_sharded``. Not ported,
and refused by :meth:`Plan.validate` naming the ROADMAP item: ``zero_axes``
(ZeRO weight-update sharding, ``zero_plan``, item 5) and
``style="shard_map"`` (bodies on the explicit collectives, compiled by
``compile_step_with_plan``, item 5). A plan's rules may carry the GPipe
pipeline's stage layout (``ShardingRules.stage_pattern``, the port's
form of JAX's ``P("pipe", ...)`` on stacked layers), which its record
keeps. :func:`stage_plan` builds the MPMD pipeline's per-stage layouts
(``replicated``, ``fsdp``, ``tensor``) as JAX's does, and refuses ``zero``
(item 5). Nor are the JAX
build's ``PlanTensorAxisWarning`` and ``DLS_PLAN_ALLOW_TENSOR``: they
guard against that jax's partitioner, which miscomputes losses on
``tensor`` meshes; the port lowers a plan's ``tensor`` entries to
``DTensor`` itself (:func:`.sharding.fully_shard_model`), so a plan with
``tensor`` validates like any other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping

from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_SEQ, BATCH_AXES
from distributeddeeplearningspark_tpu_torch.parallel.sharding import (
    REPLICATED,
    PartitionSpec,
    ShardingRules,
)

#: current on-disk plan format (Plan.save / Plan.load)
PLAN_FORMAT = 1


class PlanError(ValueError):
    """Base for plan-layer errors."""


class PlanValidationError(PlanError):
    """A plan cannot run on this mesh (axis mismatch, bad style, or a part
    of the plan layer the port does not have yet)."""


def _spec_entries(spec) -> list:
    """PartitionSpec → plain list (None | str | list[str]) for JSON."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _entries_spec(entries) -> PartitionSpec:
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _rules_record(rules: ShardingRules) -> dict:
    rec = {
        "rules": [[pat, _spec_entries(spec)] for pat, spec in rules.rules],
        "fsdp": bool(rules.fsdp),
        "fsdp_min_size": int(rules.fsdp_min_size),
        "fsdp_exclude": list(rules.fsdp_exclude),
    }
    if rules.stage_pattern is not None:  # the pipeline's stage layout
        rec.update(stage_pattern=rules.stage_pattern, num_layers=int(rules.num_layers))
    return rec


def _record_rules(rec: Mapping) -> ShardingRules:
    return ShardingRules(
        rules=tuple((pat, _entries_spec(entries))
                    for pat, entries in rec.get("rules", ())),
        fsdp=bool(rec.get("fsdp", False)),
        fsdp_min_size=int(rec.get("fsdp_min_size", 2**14)),
        fsdp_exclude=tuple(rec.get("fsdp_exclude", ())),
        stage_pattern=rec.get("stage_pattern"),
        num_layers=int(rec.get("num_layers", 0)),
    )


def _spec_axes(spec) -> set[str]:
    axes: set[str] = set()
    for e in spec:
        if e is None:
            continue
        if isinstance(e, str):
            axes.add(e)
        else:
            axes.update(e)
    return axes


@dataclasses.dataclass(frozen=True)
class Plan:
    """Declarative layout: logical axes → mesh axes + per-leaf rules.

    ``batch_axes`` — mesh axes the logical ``batch`` axis splits over.
    ``rules`` — the per-leaf param/optimizer sharding rule engine.
    ``model_hints`` — serializable model-config overrides a driver applies
    before building the model; the plan layer itself never reads them.
    ``seq_axis``, ``style``, ``zero_axes``, ``zero_min_size`` and
    ``donate_state`` are the JAX plan's, kept so that records and
    signatures match it; :meth:`validate` refuses the values the port
    cannot run.
    """

    name: str
    rules: ShardingRules = REPLICATED
    batch_axes: tuple[str, ...] = BATCH_AXES
    seq_axis: str | None = None
    style: str = "jit"
    zero_axes: tuple[str, ...] = ()
    zero_min_size: int = 2**11
    donate_state: bool = True
    model_hints: tuple[tuple[str, str], ...] = ()
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "batch_axes", tuple(self.batch_axes))
        object.__setattr__(self, "zero_axes", tuple(self.zero_axes))
        object.__setattr__(self, "model_hints",
                           tuple((str(k), str(v))
                                 for k, v in dict(self.model_hints).items()))

    @property
    def seq_sharded(self) -> bool:
        return self.seq_axis is not None

    # -- logical view --------------------------------------------------------

    def logical_axes(self) -> dict[str, tuple[str, ...]]:
        """The logical-axis → mesh-axis mapping this plan declares."""
        out: dict[str, tuple[str, ...]] = {"batch": self.batch_axes}
        if self.seq_axis:
            out["sequence"] = (self.seq_axis,)
        if self.zero_axes:
            out["weight_update"] = self.zero_axes
        param_axes: set[str] = set()
        for _, spec in self.rules.rules:
            param_axes.update(_spec_axes(spec))
        if self.rules.fsdp:
            param_axes.add("fsdp")
        if self.rules.stage_pattern is not None:
            param_axes.add("pipe")
        if param_axes:
            out["params"] = tuple(sorted(param_axes))
        return out

    def hints(self) -> dict[str, str]:
        return dict(self.model_hints)

    # -- validation ----------------------------------------------------------

    def validate(self, mesh) -> None:
        """Check this plan against ``mesh`` (anything with a ``shape``
        mapping of axis → size): every mesh axis it mentions exists, its
        batch axes are not empty, and it asks for nothing the port lacks."""
        if self.style not in ("jit", "shard_map"):
            raise PlanValidationError(
                f"plan {self.name!r}: style must be 'jit'|'shard_map', got "
                f"{self.style!r}")
        names = set(mesh.shape)
        mentioned: set[str] = set(self.batch_axes) | set(self.zero_axes)
        if self.seq_axis:
            mentioned.add(self.seq_axis)
        for _, spec in self.rules.rules:
            mentioned.update(_spec_axes(spec))
        missing = sorted(mentioned - names)
        if missing:
            raise PlanValidationError(
                f"plan {self.name!r} maps logical axes onto mesh axes "
                f"{missing} that do not exist on this mesh (axes: "
                f"{sorted(names)})")
        if not self.batch_axes:
            raise PlanValidationError(
                f"plan {self.name!r}: batch_axes must name at least one "
                f"mesh axis")
        if self.style == "shard_map":
            raise PlanValidationError(
                f"plan {self.name!r}: style='shard_map' (step bodies on the "
                f"explicit collectives, compiled by compile_step_with_plan) is "
                f"not ported yet: ROADMAP Queue 1 item 5")
        if self.seq_axis not in (None, AXIS_SEQ):
            raise PlanValidationError(
                f"plan {self.name!r}: seq_axis={self.seq_axis!r}: the ring and "
                f"Ulysses attention exchange over the {AXIS_SEQ!r} axis")
        if self.zero_axes:
            raise PlanValidationError(
                f"plan {self.name!r}: zero_axes={self.zero_axes} (ZeRO "
                f"weight-update sharding) is not ported yet: ROADMAP Queue 1 "
                f"item 5")

    # -- identity / serialization -------------------------------------------

    def to_record(self) -> dict:
        return {
            "plan_format": PLAN_FORMAT,
            "name": self.name,
            "description": self.description,
            "rules": _rules_record(self.rules),
            "batch_axes": list(self.batch_axes),
            "seq_axis": self.seq_axis,
            "style": self.style,
            "zero_axes": list(self.zero_axes),
            "zero_min_size": int(self.zero_min_size),
            "donate_state": bool(self.donate_state),
            "model_hints": dict(self.model_hints),
        }

    @classmethod
    def from_record(cls, rec: Mapping) -> "Plan":
        fmt = int(rec.get("plan_format", PLAN_FORMAT))
        if fmt > PLAN_FORMAT:
            raise PlanError(
                f"plan record format {fmt} is newer than this build's "
                f"{PLAN_FORMAT}")
        return cls(
            name=str(rec["name"]),
            description=str(rec.get("description", "")),
            rules=_record_rules(rec.get("rules", {})),
            batch_axes=tuple(rec.get("batch_axes", BATCH_AXES)),
            seq_axis=rec.get("seq_axis"),
            style=str(rec.get("style", "jit")),
            zero_axes=tuple(rec.get("zero_axes", ())),
            zero_min_size=int(rec.get("zero_min_size", 2**11)),
            donate_state=bool(rec.get("donate_state", True)),
            model_hints=tuple(dict(rec.get("model_hints", {})).items()),
        )

    def signature(self) -> str:
        """Stable content hash of everything layout-relevant (NOT the
        description): the JAX plan's, for the same record."""
        rec = self.to_record()
        rec.pop("description", None)
        return hashlib.blake2b(
            json.dumps(rec, sort_keys=True).encode(),
            digest_size=6).hexdigest()

    def save(self, path: str) -> None:
        """Serialize so a training run can pin a layout."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_record(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_record(json.load(f))

    def describe(self) -> str:
        la = ", ".join(f"{k}→{'×'.join(v)}"
                       for k, v in self.logical_axes().items())
        return (f"Plan({self.name} [{self.signature()}] {self.style}: {la}"
                + (f", hints={self.hints()}" if self.model_hints else "")
                + ")")


# -- canned plans -------------------------------------------------------------

#: Pure data parallelism — params/opt replicated, batch over (data, fsdp).
DP = Plan(name="dp", rules=REPLICATED,
          description="replicated params, batch over (data, fsdp)")

#: ZeRO-style FSDP: every large param (and its optimizer moments, which
#: follow the same rules) sharded over the ``fsdp`` axis.
FSDP_PLAN = Plan(name="fsdp", rules=ShardingRules(fsdp=True),
                 description="auto-FSDP params + moments over 'fsdp'")


def plan_for_rules(rules: ShardingRules, *, context_parallel: bool = False,
                   name: str | None = None) -> Plan:
    """Wrap a (rules, context_parallel) trainer config as a Plan."""
    if name is None:
        name = "fsdp" if rules.fsdp else ("dp" if not rules.rules else "rules")
        if context_parallel:
            name += "+seq"
    return Plan(name=name, rules=rules,
                seq_axis="seq" if context_parallel else None)


def stage_plan(name: str, cfg=None, *, fsdp_min_size: int = 2**14) -> Plan:
    """Per-stage pipeline layouts by name (``DLS_PIPE_SPEC``'s
    ``stage_plans``/``plan`` values, JAX's): ``replicated``; ``fsdp`` (wide
    sharded storage: every param of at least ``fsdp_min_size`` elements over
    the stage's ``fsdp`` axis); ``tensor`` (the Megatron splits of
    ``llama_rules(cfg, fsdp=False)``, so it needs the model cfg). ``zero``
    (replicated params, replica-sharded optimizer state) raises
    :class:`PlanError` naming ROADMAP Queue 1 item 5, as :meth:`Plan.validate`
    refuses ``zero_axes``."""
    if name == "replicated":
        return Plan(name="stage-replicated")
    if name == "fsdp":
        return Plan(name="stage-fsdp",
                    rules=ShardingRules(fsdp=True, fsdp_min_size=fsdp_min_size))
    if name == "tensor":
        if cfg is None:
            raise PlanError("stage_plan('tensor') needs the model cfg")
        from distributeddeeplearningspark_tpu_torch.models.llama import llama_rules

        return Plan(name="stage-tensor", rules=llama_rules(cfg, fsdp=False))
    if name == "zero":
        raise PlanError("stage_plan('zero') (ZeRO weight-update sharding) is not "
                        "ported yet: ROADMAP Queue 1 item 5")
    raise PlanError(
        f"unknown stage plan {name!r} (want replicated|fsdp|tensor|zero)")

"""TrainState — what the train step carries from one step to the next.

The port of ``distributeddeeplearningspark_tpu/train/state.py``. The JAX
state is an immutable pytree that the jitted step replaces; here the
params are the model's own ``nn.Parameter``s (by name, updated in place by
the optimizer), beside the optimizer's state, the host step counter and the
``torch.Generator`` that draws the dropout masks, and ``mutable``: the
model's named buffers (BatchNorm's running ``mean``/``var``), the
counterpart of ``state.mutable["batch_stats"]``. The forward updates them
in place in train mode; they are never params, so the optimizer and the
gradient norm never see them. ``embed_state`` is the row-sparse embedding
state of :mod:`.embed`, ``{spec name: {"row_accum": [V] f32}}``, updated
in place by the sparse step; empty when no table trains sparsely.

:meth:`TrainState.state_dict` is what a checkpoint holds: plain dicts,
lists, ints and tensors (``torch.load(weights_only=True)`` reads it), the
optimizer state flattened to its leaves in order (its counts, 0-d device
tensors, as host ints).
:meth:`TrainState.load_state_dict` writes such a dict back into the live
tensors in place, so the model's params stay the optimizer's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def leaves(tree: Any) -> list:
    """The leaves of a tree of tuples (NamedTuples too), lists and dicts,
    in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _refill(template: Any, saved: list) -> Any:
    """``template`` with its leaves taken from ``saved`` in order: a
    tensor leaf is copied into the template's tensor in place (a count,
    saved as an int, filled into its 0-d tensor), any other leaf replaced."""
    if isinstance(template, dict):
        return {k: _refill(v, saved) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        items = [_refill(v, saved) for v in template]
        if hasattr(template, "_fields"):  # a NamedTuple
            return type(template)(*items)
        return type(template)(items)
    new = saved.pop(0)
    if isinstance(template, torch.Tensor):
        if isinstance(new, int) and template.dim() == 0:
            return template.fill_(new)
        if not isinstance(new, torch.Tensor) or new.shape != template.shape:
            raise ValueError(f"optimizer state leaf {getattr(new, 'shape', new)} "
                             f"does not fit {tuple(template.shape)}")
        template.copy_(new)
        return template
    return new


def _host_count(x: Any) -> Any:
    """A 0-d integer tensor (an optimizer's count) as the host int a
    checkpoint holds; other leaves as they are."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dim() == 0 and not x.is_floating_point():
            return int(x)
    return x


def _copy_named(live: dict[str, torch.Tensor], saved: dict[str, torch.Tensor],
                what: str) -> None:
    if set(live) != set(saved):
        raise ValueError(f"{what} differ: missing {sorted(set(live) - set(saved))}, "
                         f"unexpected {sorted(set(saved) - set(live))}")
    with torch.no_grad():
        for name, t in live.items():
            if t.shape != saved[name].shape:
                raise ValueError(f"{what} {name}: shape {tuple(saved[name].shape)}, "
                                 f"want {tuple(t.shape)}")
            t.copy_(saved[name])


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.nn.Parameter]
    opt_state: Any
    generator: torch.Generator
    mutable: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    embed_state: dict[str, dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())

    def state_dict(self) -> dict[str, Any]:
        """The state as plain containers of tensors (live, not copies)."""
        return {
            "step": int(self.step),
            "params": {k: p.detach() for k, p in self.params.items()},
            "opt_state": [_host_count(x) for x in leaves(self.opt_state)],
            "generator": self.generator.get_state(),
            "mutable": {k: v.detach() for k, v in self.mutable.items()},
            "embed_state": {name: {k: v.detach() for k, v in s.items()}
                            for name, s in self.embed_state.items()},
        }

    def load_state_dict(self, sd: dict[str, Any]) -> "TrainState":
        """Write ``sd`` (a :meth:`state_dict`, on any device) into this
        state in place; returns self."""
        _copy_named(self.params, sd["params"], "params")
        _copy_named(self.mutable, sd["mutable"], "buffers")
        if set(self.embed_state) != set(sd["embed_state"]):
            raise ValueError(f"sparse tables differ: {sorted(sd['embed_state'])}, "
                             f"want {sorted(self.embed_state)}")
        for name, s in self.embed_state.items():
            _copy_named(s, sd["embed_state"][name], f"embed state {name}")
        saved = list(sd["opt_state"])
        if len(saved) != len(leaves(self.opt_state)):
            raise ValueError(f"optimizer state has {len(saved)} leaves, want "
                             f"{len(leaves(self.opt_state))}")
        with torch.no_grad():
            self.opt_state = _refill(self.opt_state, saved)
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])
        return self

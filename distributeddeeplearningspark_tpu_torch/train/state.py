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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


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

"""TrainState — what the train step carries from one step to the next.

The port of ``distributeddeeplearningspark_tpu/train/state.py``. The JAX
state is an immutable pytree that the jitted step replaces; here the
params are the model's own ``nn.Parameter``s (by name, updated in place by
the optimizer), beside the optimizer's state, the host step counter and the
``torch.Generator`` that draws the dropout masks. Mutable collections
(BatchNorm statistics) and row-sparse embedding state arrive with the
models that need them.
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

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.values())

"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked.

    The port's entry points default to ``"cuda"``. When CUDA is absent they
    raise rather than fall back: only a caller that passes ``device="cpu"``
    (the CPU tests do) runs on the CPU, where every kernel's wrapper takes
    its plain PyTorch version."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")

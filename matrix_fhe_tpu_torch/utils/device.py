"""Device policy of the port's constructors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Constructors default to the card;
    without one they raise here rather than build on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device; pass device='cpu' for the plain path")
    return dev

"""Device policy of the port's constructors, and its cached device constants."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Constructors default to the card;
    without one they raise here rather than build on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device; pass device='cpu' for the plain path")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(shape: tuple, values: tuple, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (an integer or an array-like of integers) as a tensor on
    ``device``, made once for each (values, dtype, device) and shared by
    every caller, which must not write to it.  Asked again, it copies
    nothing from the host: such a copy waits for the device, and inside a
    CUDA-graph capture it raises (``circuits/ckks/staged.py``).  An entry
    stays for the life of the process, since a captured graph that reads
    it holds no reference to it."""
    a = np.asarray(values)
    return _constant(a.shape, tuple(a.ravel().tolist()), dtype, torch.device(device))

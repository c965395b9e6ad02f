"""Device policy of the port's constructors, and its cached device constants."""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

# the most constants the shared cache keeps; the least recently used goes first
MAX_CONSTANTS = 4096

_cache: collections.OrderedDict = collections.OrderedDict()
_holders: list[dict] = []


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Constructors default to the card;
    without one they raise here rather than build on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device; pass device='cpu' for the plain path")
    return dev


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (an integer or an array-like of integers) as a tensor on
    ``device``, shared by every caller, which must not write to it.  Made
    once and kept in a cache of at most ``MAX_CONSTANTS`` entries: asked
    again while cached, it copies nothing from the host (such a copy waits
    for the device, and inside a CUDA-graph capture it raises).  Inside
    ``holding(held)`` it is also kept in ``held``, and found there first,
    so that a captured graph keeps every constant it reads
    (``circuits/ckks/staged.py``) whatever the cache drops."""
    a = np.asarray(values)
    key = (a.shape, tuple(a.ravel().tolist()), dtype, torch.device(device))
    t = next((h[key] for h in _holders if key in h), None)
    if t is None:
        t = _cache.pop(key, None)
        if t is None:
            t = torch.tensor(key[1], dtype=dtype, device=key[3]).reshape(key[0])
        _cache[key] = t
        if len(_cache) > MAX_CONSTANTS:
            _cache.popitem(last=False)
    for h in _holders:
        h[key] = t
    return t


@contextlib.contextmanager
def holding(held: dict):
    """Within: every constant ``constant`` returns is kept in ``held`` (and
    looked up there first) as long as ``held`` lives."""
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)


def cached_constants() -> int:
    """The number of constants the shared cache holds."""
    return len(_cache)


def clear_constants() -> None:
    """Drop every constant of the shared cache (a ``holding`` dict keeps its own)."""
    _cache.clear()

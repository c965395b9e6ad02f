"""Ciphertext / Plaintext elements and their metadata.

Counterpart of ``matrix_fhe_tpu/rlwe/elements.py`` (the reference's
core/rlwe/element.go, ciphertext.go, plaintext.go, metadata.go): frozen
dataclasses holding int64 word tensors [L, N], with host-side metadata.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch


@dataclasses.dataclass(frozen=True)
class MetaData:
    """PlaintextMetaData + CiphertextMetaData (core/rlwe/metadata.go:15,107).
    ``scale`` is an exact rational (the reference uses 128-bit big.Float)."""
    scale: Fraction = Fraction(1)
    log_dimensions: tuple[int, int] = (0, 0)
    is_batched: bool = True
    is_ntt: bool = True
    is_montgomery: bool = False

    def with_scale(self, scale) -> "MetaData":
        return dataclasses.replace(self, scale=Fraction(scale))


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """Degree-d RLWE ciphertext: value = (c_0, ..., c_d), each [L, N]
    (core/rlwe/ciphertext.go:11)."""
    value: tuple[torch.Tensor, ...]
    metadata: MetaData = MetaData()

    @property
    def degree(self) -> int:
        return len(self.value) - 1

    @property
    def level(self) -> int:
        return int(self.value[0].shape[-2]) - 1

    @property
    def scale(self) -> Fraction:
        return self.metadata.scale

    def with_value(self, value) -> "Ciphertext":
        return dataclasses.replace(self, value=tuple(value))

    def with_metadata(self, **kw) -> "Ciphertext":
        return dataclasses.replace(self, metadata=dataclasses.replace(self.metadata, **kw))


@dataclasses.dataclass(frozen=True)
class Plaintext:
    """Degree-0 element (core/rlwe/plaintext.go)."""
    value: torch.Tensor  # [L, N]
    metadata: MetaData = MetaData()

    @property
    def level(self) -> int:
        return int(self.value.shape[-2]) - 1

    @property
    def scale(self) -> Fraction:
        return self.metadata.scale

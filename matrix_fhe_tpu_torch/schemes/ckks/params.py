"""CKKS parameters (counterpart of ``matrix_fhe_tpu/schemes/ckks/params.py``,
the reference's schemes/ckks/params.go)."""

from __future__ import annotations

import dataclasses
from fractions import Fraction

from matrix_fhe_tpu_torch import rlwe
from matrix_fhe_tpu_torch.ops import rings as rg


@dataclasses.dataclass(frozen=True)
class CKKSParametersLiteral:
    """schemes/ckks/params.go:47-90: the RLWE literal + LogDefaultScale."""
    logn: int
    logq: tuple[int, ...] | None = None
    logp: tuple[int, ...] | None = None
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    log_default_scale: int = 45
    ring_type: str = rg.STANDARD
    xe: object = rlwe.params.DEFAULT_XE
    xs: object = rlwe.params.DEFAULT_XS


class CKKSParameters(rlwe.Parameters):
    """rlwe.Parameters + CKKS helpers (slots, default scale)."""

    def __init__(self, lit: CKKSParametersLiteral, device="cuda"):
        base = rlwe.new_parameters(rlwe.ParametersLiteral(
            logn=lit.logn, q=lit.q, p=lit.p, logq=lit.logq, logp=lit.logp,
            xe=lit.xe, xs=lit.xs, ring_type=lit.ring_type, ntt_flag=True,
            default_scale=float(1 << lit.log_default_scale)), device)
        self.__dict__.update(base.__dict__)
        self.log_default_scale = lit.log_default_scale

    @property
    def default_scale(self) -> Fraction:  # type: ignore[override]
        return Fraction(1 << self.log_default_scale)

    @default_scale.setter
    def default_scale(self, v) -> None:  # set by the base __init__; ignored
        pass

    @property
    def max_slots(self) -> int:
        """N/2 on the standard ring, N on the conjugate-invariant ring
        (schemes/ckks/params.go MaxSlots)."""
        return self.n if self.ring_type == rg.CONJUGATE_INVARIANT else self.n // 2

    @property
    def log_max_slots(self) -> int:
        return self.max_slots.bit_length() - 1

    def levels_consumed_per_rescaling(self) -> int:
        return 1  # PREC64 mode (schemes/ckks/params.go:27-32)

    def galois_element_for_rotation(self, k: int) -> int:
        return self.galois_element(k)

    def galois_element_for_conjugation(self) -> int:
        return self.galois_element_inverse()


def new_parameters(lit: CKKSParametersLiteral, device="cuda") -> CKKSParameters:
    return CKKSParameters(lit, device)

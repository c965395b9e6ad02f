"""FastRing: RNS ring over <2^23 moduli with int32 residues.

Counterpart of ``matrix_fhe_tpu/fast/fring.py``.  Residues are int32
tensors [..., L, N], canonical in [0, q) at op boundaries, so every output
here equals the JAX package's bit for bit.  Products are taken in int64,
where they are exact (< 2^46); there is no Montgomery domain
(``mul_coeffs_montgomery`` is a plain modular multiply), as in the JAX fast
path.

``ntt``/``intt`` dispatch on the tensor's device (``ops/ntt_cuda.py``): a
CUDA tensor goes through the hand-written kernel, a CPU tensor through the
plain torch version.  ``new_fast_ring`` puts a ring on the card unless asked
for another device.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import ntt_cuda
from matrix_fhe_tpu_torch.utils.device import constant, resolve_device

MAX_FAST_MODULUS = ntt_cuda.MAX_V2_MODULUS  # 2^23


# ---------------------------------------------------------------------------
# Scalar helpers (exact for q < 2^23).
# ---------------------------------------------------------------------------

def center(v: torch.Tensor, q) -> torch.Tensor:
    """[0, q) -> (-q/2, q/2]."""
    return torch.where(v > q >> 1, v - q, v)


def canon(v: torch.Tensor, q) -> torch.Tensor:
    """(-2q, 2q) -> [0, q)."""
    v = torch.where(v >= q, v - q, v)
    v = torch.where(v < 0, v + q, v)
    return torch.where(v < 0, v + q, v)


def reduce_once(v: torch.Tensor, q) -> torch.Tensor:
    """v mod q, in [0, q) (the JAX version leaves (-1.6q, 1.6q); both are
    canonicalized by ``canon`` to the same value)."""
    return torch.remainder(v, q)


def mulmod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a*b mod q in [0, q), int32; the product is exact in int64."""
    q64 = q.to(torch.int64) if isinstance(q, torch.Tensor) else q
    return torch.remainder(a.to(torch.int64) * b.to(torch.int64), q64).to(torch.int32)


def mulmod_lazy_centered(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a*b mod q, centered in (-q/2, q/2] (inside the JAX version's
    (-1.6q, 1.6q))."""
    return center(mulmod(a, b, q), q)


# ---------------------------------------------------------------------------
# FastRing.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FastRing:
    """RNS ring over int32 residues on one device."""

    n: int
    moduli_tuple: tuple[int, ...]
    moduli: torch.Tensor                   # int32 [L]
    tables: ntt_cuda.NTTTables | None      # None: moduli-only view, no NTT

    @property
    def device(self) -> torch.device:
        return self.moduli.device

    # -- level views ---------------------------------------------------------
    @property
    def level(self) -> int:
        return len(self.moduli_tuple) - 1

    @property
    def num_limbs(self) -> int:
        return len(self.moduli_tuple)

    def at_level(self, level: int) -> "FastRing":
        if level == self.level:
            return self
        if level > self.level:
            raise ValueError(
                f"at_level({level}) above the built level {self.level}")
        return self.limbs(0, level + 1)

    def limbs(self, start: int, end: int) -> "FastRing":
        """View of limbs [start, end), tables sliced alike."""
        s = slice(start, end)
        return dataclasses.replace(
            self, moduli_tuple=self.moduli_tuple[s], moduli=self.moduli[s],
            tables=None if self.tables is None else self.tables.sliced(s))

    def _q(self) -> torch.Tensor:
        return self.moduli[:, None]

    # -- elementwise ops (int32 [.., L, N] canonical in [0, q)) --------------
    def add(self, p1, p2):
        s = p1 + p2
        return torch.where(s >= self._q(), s - self._q(), s)

    def sub(self, p1, p2):
        d = p1 - p2
        return torch.where(d < 0, d + self._q(), d)

    def neg(self, p1):
        return torch.where(p1 == 0, p1, self._q() - p1)

    # no Montgomery domain: the u64 ring's forms are the identity here
    def mform(self, p1):
        return p1

    def imform(self, p1):
        return p1

    def reduce(self, p1):
        return reduce_once(p1, self._q())

    def mul_coeffs_montgomery(self, p1, p2):
        return mulmod(p1, p2, self._q())

    def mul_coeffs_montgomery_then_add(self, p1, p2, p3):
        return self.add(self.mul_coeffs_montgomery(p1, p2), p3)

    def mul_coeffs_montgomery_then_sub(self, p1, p2, p3):
        return self.sub(p3, self.mul_coeffs_montgomery(p1, p2))

    def mul_coeffs_barrett(self, p1, p2):
        return mulmod(p1, p2, self._q())

    def mul_scalar_montgomery(self, p1, scalar):
        """scalar: [L] per-limb values (plain domain)."""
        return mulmod(p1, self._scalar_limbs(scalar)[:, None], self._q())

    def add_scalar(self, p1, scalar):
        return self.add(p1, self._scalar_limbs(scalar)[:, None].expand_as(p1))

    def sub_scalar(self, p1, scalar):
        return self.sub(p1, self._scalar_limbs(scalar)[:, None].expand_as(p1))

    def _scalar_limbs(self, scalar) -> torch.Tensor:
        if isinstance(scalar, torch.Tensor):
            return scalar.to(device=self.device, dtype=torch.int32)
        if isinstance(scalar, int):
            scalar = [scalar % q for q in self.moduli_tuple]
        return constant(scalar, torch.int32, self.device)

    # -- NTT -----------------------------------------------------------------
    def ntt(self, p: torch.Tensor) -> torch.Tensor:
        return ntt_cuda.ntt_fwd(p.contiguous(), self._tables())

    def intt(self, p: torch.Tensor) -> torch.Tensor:
        return ntt_cuda.ntt_bwd(p.contiguous(), self._tables())

    def _tables(self) -> ntt_cuda.NTTTables:
        if self.tables is None:
            raise ValueError("this ring view has no NTT tables")
        return self.tables


def find_fast_primes(n: int, count: int) -> list[int]:
    """NTT-friendly primes < 2^23 for degree n, largest first."""
    return ntt_cuda.find_v2_primes(n, count)


def new_fast_ring(n: int, moduli: list[int], device="cuda") -> FastRing:
    """Standard (power-of-two negacyclic) fast ring over <2^23 primes,
    with its tables on ``device``."""
    device = resolve_device(device)
    if n < 16 or n & (n - 1):
        raise ValueError("N must be a power of two >= 16")
    for q in moduli:
        if q >= MAX_FAST_MODULUS:
            raise ValueError(f"modulus {q} too large for the fast path")
    if len(set(moduli)) != len(moduli):
        raise ValueError("moduli must be distinct")
    return FastRing(
        n=n, moduli_tuple=tuple(moduli),
        moduli=torch.tensor(moduli, dtype=torch.int32, device=device),
        tables=ntt_cuda.build_tables(n, moduli, device))

"""WideRing: the RNS ring over 41-61-bit moduli, on 64-bit words.

Counterpart of ``matrix_fhe_tpu/fast/wring.py``.  The JAX ring holds a
residue as a centered int32 pair over digit planes and runs its NTT as int8
matmuls (``ops/wide_ntt.py``); here a residue is one int64 word in [0, q)
(``ops/wide.py``) and the ring is the u64 ring of ``ops/rings.py`` in the
plain domain: its NTT is kernel B4 on a CUDA tensor (``ops/ntt64_cuda.py``)
and the torch-op NTT on the CPU.  The surface is the JAX ring's
(``at_level``, ``limb_band``, ``modulus_at_level``, add/sub/neg, the
``mul_*`` family, the scalar ops, ``ntt``/``intt``, ``new_poly``), so the
fckks-style composites and the CKKS evaluator run on it unchanged.

There is no Montgomery domain: ``mform`` and ``imform`` are the identity
(as in the JAX ring) and every product is a*b mod q (Barrett), which is
what the u64 ring's Montgomery product of an MForm operand gives.  Outputs
are canonical, and equal ``wide.unpack_pair`` of the JAX ring's outputs.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rings, wide


@dataclasses.dataclass(frozen=True)
class WideRing(rings.Ring):
    """``rings.Ring`` in the plain domain, over moduli in [2^41, 2^61 + 2^55).
    ``pair31`` is the JAX mode of the ring's parameter set (``wide.use_pair31``
    over its q and p moduli): how a JAX pair of this ring is read."""

    pair31: bool = False

    def limb_band(self, start: int, end: int) -> "WideRing":
        """View of limbs [start, end) (the decomposer's digit bands)."""
        return self.limbs(start, end)

    def neg(self, p1):
        return wide.neg(self._c(self.moduli), p1)

    def mform(self, p1):
        return p1

    def imform(self, p1):
        return p1

    def mul_coeffs_montgomery(self, p1, p2):
        return self.mul_coeffs_barrett(p1, p2)

    def mul_scalar_montgomery(self, p1, scalar):
        """scalar: per-limb plain values ([L] list or array), or a Python int
        taken mod each q."""
        s = self._c(self._scalar_limbs(scalar))
        return mm.bred(p1, s, self._c(self.moduli), self._c(self.bhi), self._c(self.blo))

    def new_poly(self, batch: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch + (self.num_limbs, self.n), dtype=torch.int64,
                           device=self.device)


def new_wide_ring(n: int, moduli, pair31: bool | None = None, device="cuda") -> WideRing:
    """The wide ring of degree ``n`` over ``moduli`` (NTT-friendly primes in
    [2^41, 2^61 + 2^55)), on ``device`` (the card unless told otherwise).
    ``pair31`` as ``wide.use_pair31`` over the whole parameter set (None:
    over ``moduli``)."""
    moduli = wide.check_moduli(moduli)
    if pair31 is None:
        pair31 = wide.use_pair31(moduli)
    ring = rings.new_ring(n, list(moduli), device=device, max_modulus=wide.MAX_WIDE_MODULUS)
    return WideRing(**{f.name: getattr(ring, f.name) for f in dataclasses.fields(ring)},
                    pair31=bool(pair31))


"""RLWE parameters: moduli chains, rings, Galois algebra, key-switching
tables.

Counterpart of ``matrix_fhe_tpu/rlwe/params.py`` (the reference's
core/rlwe/params.go and params_3n.go) for the three ring types: the
standard and the conjugate-invariant ring (``ParametersLiteral``), and the
fork's 3N ring (``Parameters3NLiteral``, N = 2^order2 3^order3, NthRoot =
3N).  Moduli generation mirrors GenModuli (params.go:902-950: one
NTT-friendly generator per distinct bit size, downstream for 61 bits,
alternating otherwise) and, on the 3N ring, the JAX package's deterministic
Gen3NModuli (successive primes = 1 mod 3N above 2^bits), so a literal
gives the same chain as the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

from matrix_fhe_tpu_torch.ops import rings as rg
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import resolve_device

GALOIS_GEN = 5  # ring/ring.go:19

DEFAULT_XE = smp.DiscreteGaussian(sigma=3.2, bound=19.2)  # core/rlwe/security.go
DEFAULT_XS = smp.Ternary(p=2 / 3.0)


@dataclasses.dataclass(frozen=True)
class ParametersLiteral:
    """core/rlwe/params.go:57-75 ParametersLiteral: exactly one of (q, logq)
    and at most one of (p, logp)."""
    logn: int
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    logq: tuple[int, ...] | None = None
    logp: tuple[int, ...] | None = None
    xe: smp.DiscreteGaussian = DEFAULT_XE
    xs: smp.Ternary | smp.DiscreteGaussian = DEFAULT_XS
    ring_type: str = rg.STANDARD
    ntt_flag: bool = True
    default_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Parameters3NLiteral:
    """core/rlwe/params_3n.go:31-59: N = 2^order2 * 3^order3, NthRoot = 3N."""
    order2: int
    order3: int
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    logq: tuple[int, ...] | None = None
    logp: tuple[int, ...] | None = None
    xe: smp.DiscreteGaussian = DEFAULT_XE
    xs: smp.Ternary | smp.DiscreteGaussian = DEFAULT_XS
    ntt_flag: bool = True
    default_scale: float = 1.0


def gen_moduli(log_nth_root: int, logq: Sequence[int], logp: Sequence[int]
               ) -> tuple[list[int], list[int]]:
    """GenModuli (core/rlwe/params.go:902-950), the same enumeration."""
    sizes: dict[int, int] = {}
    for b in list(logq) + list(logp):
        sizes[b] = sizes.get(b, 0) + 1
    pools: dict[int, list[int]] = {}
    for bits, count in sizes.items():
        g = pr.NTTFriendlyPrimesGenerator(bits, 1 << log_nth_root)
        pools[bits] = (g.next_downstream_primes(count) if bits == 61
                       else g.next_alternating_primes(count))
    q = [pools[b].pop(0) for b in logq]
    p = [pools[b].pop(0) for b in logp]
    return q, p


def gen_3n_moduli(n: int, logq: Sequence[int], logp: Sequence[int]
                  ) -> tuple[list[int], list[int]]:
    """The 3N moduli chain: for each bit size, successive primes = 1 mod 3N
    (core/rlwe/params.go:953 Gen3NModuli's semantics, with the JAX
    package's deterministic enumeration instead of the reference's seeded
    retry loop)."""
    sizes: dict[int, int] = {}
    for b in list(logq) + list(logp):
        sizes[b] = sizes.get(b, 0) + 1
    pools = {bits: pr.find_3n_rns_primes(n, bits, count) for bits, count in sizes.items()}
    q = [pools[b].pop(0) for b in logq]
    p = [pools[b].pop(0) for b in logp]
    return q, p


class Parameters:
    """Host-side parameter object owning the rings (on ``device``) and the
    key-switching tables, built per level at first use
    (core/rlwe/params.go:75 Parameters)."""

    def __init__(self, *, n: int, nth_root: int, q: list[int], p: list[int],
                 xe, xs, ring_type: str, ntt_flag: bool, default_scale: float,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n = n
        self.nth_root = nth_root
        self.q = list(q)
        self.p = list(p)
        self.xe = xe
        self.xs = xs
        self.ring_type = ring_type
        self.ntt_flag = ntt_flag
        self.default_scale = default_scale

        self.ring_q = rg.new_ring(n, self.q, ring_type, self.device)
        self.ring_p = rg.new_ring(n, self.p, ring_type, self.device) if p else None
        self._decomposers: dict[tuple[int, int], rt.Decomposer] = {}
        self._moddown: dict[tuple[int, int], rt.ModDownConstants] = {}

    # -- levels ----------------------------------------------------------
    @property
    def max_level(self) -> int:
        return len(self.q) - 1

    @property
    def max_level_p(self) -> int:
        return len(self.p) - 1

    def big_q(self, level: int | None = None) -> int:
        return self.ring_q.modulus_at_level(self.max_level if level is None else level)

    def big_p(self) -> int:
        return self.ring_p.modulus_at_level() if self.ring_p is not None else 1

    # -- key-switching tables, one set per (level_q, level_p) ---------------
    def decomposer(self, level_q: int | None = None, level_p: int | None = None
                   ) -> rt.Decomposer:
        key = (self.max_level if level_q is None else level_q,
               self.max_level_p if level_p is None else level_p)
        if key not in self._decomposers:
            self._decomposers[key] = rt.gen_decomposer(
                self.q[:key[0] + 1], self.p[:key[1] + 1], self.device)
        return self._decomposers[key]

    def moddown_constants(self, level_q: int | None = None, level_p: int | None = None
                          ) -> rt.ModDownConstants:
        key = (self.max_level if level_q is None else level_q,
               self.max_level_p if level_p is None else level_p)
        if key not in self._moddown:
            self._moddown[key] = rt.gen_moddown_constants(
                self.q[:key[0] + 1], self.p[:key[1] + 1], self.device)
        return self._moddown[key]

    def base_rns_decomposition_vector_size(self, level_q: int,
                                           level_p: int | None = None) -> int:
        """ceil(#Qi / #Pi) (core/rlwe/params.go:635-642)."""
        lp = self.max_level_p if level_p is None else level_p
        if lp == -1:
            return level_q + 1
        return (level_q + lp + 1) // (lp + 1)

    # -- Galois element algebra (core/rlwe/params.go:662-727) -------------
    def galois_element(self, k: int) -> int:
        return pow(GALOIS_GEN, k & (self.nth_root - 1), self.nth_root)

    def galois_elements(self, ks: Sequence[int]) -> list[int]:
        return [self.galois_element(k) for k in ks]

    def mod_inv_galois_element(self, gal_el: int) -> int:
        return pow(gal_el, -1, self.nth_root)

    def galois_element_inverse(self) -> int:
        """GaloisGen^{-1}: the conjugation element 2N-1 (params.go:683-689)."""
        if self.ring_type == rg.CONJUGATE_INVARIANT:
            raise ValueError("undefined for the conjugate-invariant ring")
        return self.nth_root - 1

    @functools.cached_property
    def log_n(self) -> int:
        return self.n.bit_length() - 1


def new_parameters(lit: ParametersLiteral, device="cuda") -> Parameters:
    """Parameters of a literal, with the rings on ``device`` (the card
    unless told otherwise)."""
    n = 1 << lit.logn
    nth_root = 2 * n if lit.ring_type == rg.STANDARD else 4 * n
    if lit.q is not None:
        q, p = list(lit.q), list(lit.p or ())
    else:
        q, p = gen_moduli(nth_root.bit_length() - 1, lit.logq, lit.logp or ())
    return Parameters(n=n, nth_root=nth_root, q=q, p=p, xe=lit.xe, xs=lit.xs,
                      ring_type=lit.ring_type, ntt_flag=lit.ntt_flag,
                      default_scale=lit.default_scale, device=device)


def new_parameters_3n(lit: Parameters3NLiteral, device="cuda") -> Parameters:
    """Parameters of a 3N literal, with the rings on ``device`` (the card
    unless told otherwise)."""
    n = (1 << lit.order2) * 3 ** lit.order3
    if lit.q is not None:
        q, p = list(lit.q), list(lit.p or ())
    else:
        q, p = gen_3n_moduli(n, lit.logq, lit.logp or ())
    return Parameters(n=n, nth_root=3 * n, q=q, p=p, xe=lit.xe, xs=lit.xs,
                      ring_type=rg.MATRIX, ntt_flag=lit.ntt_flag,
                      default_scale=lit.default_scale, device=device)

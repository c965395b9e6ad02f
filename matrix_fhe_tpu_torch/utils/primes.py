"""Host-side prime search and primitive roots (pure Python big ints).

A copy of the parts of ``matrix_fhe_tpu/utils/primes.py`` that the port
needs: exact primality, factoring, the smallest primitive root, the
NTT-friendly prime generator, and the 3N ring's primes and primitive roots.
They follow the reference's conventions (ring/primes.go, ring/primes_3n.go,
ring/subring.go), so the moduli chains and NTT tables they produce are the
JAX package's, bit for bit.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

MASK64 = (1 << 64) - 1

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Exact primality for n < 3.3e24 (deterministic Miller-Rabin bases)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def factor(n: int) -> list[int]:
    """Distinct prime factors of n, sorted (Pollard rho)."""
    out: set[int] = set()

    def _rho(m: int) -> int:
        if m % 2 == 0:
            return 2
        rng = random.Random(0xC0FFEE ^ m)
        while True:
            x = rng.randrange(2, m)
            y, c, d = x, rng.randrange(1, m), 1
            while d == 1:
                x = (x * x + c) % m
                y = (y * y + c) % m
                y = (y * y + c) % m
                d = math.gcd(abs(x - y), m)
            if d != m:
                return d

    def _fac(m: int) -> None:
        if m == 1:
            return
        if is_prime(m):
            out.add(m)
            return
        d = _rho(m)
        _fac(d)
        _fac(m // d)

    _fac(n)
    return sorted(out)


def primitive_root(q: int, factors: list[int] | None = None) -> tuple[int, list[int]]:
    """Smallest primitive root (>= 3) of prime q, and the factors of q - 1.

    The search starts at g = 3, as ring/subring.go:216-251 does."""
    if factors is None:
        factors = factor(q - 1)
    g = 2
    while True:
        g += 1
        for f in factors:
            if pow(g, (q - 1) // f, q) == 1:
                break
        else:
            return g, factors


def find_3n_primitive_root(q: int, nth_root: int, factors: list[int] | None = None
                           ) -> tuple[int, list[int]]:
    """The 3N-th primitive root omega = g^((q-1)/3N), g the smallest
    primitive root: ring/subring.go:253-290's contract (exact order 3N)
    without its random base, so the tables are reproducible."""
    if (q - 1) % nth_root != 0:
        raise ValueError(f"(q-1) not divisible by NthRoot={nth_root}")
    g, factors = primitive_root(q, factors)
    omega = pow(g, (q - 1) // nth_root, q)
    if multiplicative_order(omega, q) != nth_root:
        raise ValueError("derived omega does not have exact order 3N")
    return omega, factors


def multiplicative_order(g: int, q: int) -> int:
    """Multiplicative order of g mod the prime q (ring/primes_3n.go:78-90)."""
    order = q - 1
    for f in factor(q - 1):
        while order % f == 0 and pow(g, order // f, q) == 1:
            order //= f
    return order


def find_3n_rns_primes(n: int, bit_size: int, count: int,
                       search_budget: int = 1_000_000) -> list[int]:
    """``count`` primes p = 1 mod 3N from 2^bit_size upward, in steps of 3N
    (ring/primes_3n.go:11-43).  A "b-bit" 3N prime lies just above 2^b, so
    b = 61 gives moduli the u64 path refuses (``ops/modmath.py``)."""
    if n <= 0 or bit_size <= 2 or count <= 0:
        raise ValueError("invalid args")
    three_n = 3 * n
    start = ((((1 << bit_size) - 1) // three_n) + 1) * three_n
    candidate = start + 1
    out: list[int] = []
    steps = 0
    while steps < search_budget and len(out) < count:
        if candidate % three_n == 1 and is_prime(candidate) and candidate not in out:
            out.append(candidate)
        if candidate > MASK64 - three_n:
            break
        candidate += three_n
        steps += 1
    if len(out) < count:
        raise ValueError(f"could not find enough 3N-friendly primes (found {len(out)}/{count})")
    return out


@dataclass
class NTTFriendlyPrimesGenerator:
    """Primes 2^bit_size +/- k*nth_root + 1, enumerated in the reference's
    order (ring/primes.go:64-277), with the same 0.5-bit cutoffs."""

    bit_size: int
    nth_root: int
    next_prime: int = field(init=False)
    prev_prime: int = field(init=False)
    check_next: bool = field(init=False, default=True)
    check_prev: bool = field(init=False, default=True)

    def __post_init__(self) -> None:
        self.next_prime = (1 << self.bit_size) + 1
        self.prev_prime = (1 << self.bit_size) + 1
        if self.next_prime > MASK64 - self.nth_root:
            self.check_next = False
        if self.prev_prime < self.nth_root:
            self.check_prev = False
        self.prev_prime -= self.nth_root

    def next_upstream_prime(self) -> int:
        while True:
            if not self.check_next:
                raise ValueError("upstream primes exhausted")
            if math.log2(self.next_prime) - self.bit_size >= 0.5:
                self.check_next = False
                raise ValueError("upstream primes exhausted")
            p, self.next_prime = self.next_prime, self.next_prime + self.nth_root
            if is_prime(p):
                return p

    def next_downstream_prime(self) -> int:
        while True:
            if not self.check_prev:
                raise ValueError("downstream primes exhausted")
            if (self.bit_size - math.log2(self.prev_prime) >= 0.5
                    or self.prev_prime < self.nth_root):
                self.check_prev = False
                raise ValueError("downstream primes exhausted")
            p, self.prev_prime = self.prev_prime, self.prev_prime - self.nth_root
            if is_prime(p):
                return p

    def next_alternating_prime(self) -> int:
        while True:
            if not (self.check_next or self.check_prev):
                raise ValueError("up- and downstream primes exhausted")
            if self.check_next:
                if (math.log2(self.next_prime) - self.bit_size >= 0.5
                        or self.next_prime > MASK64 - self.nth_root):
                    self.check_next = False
                elif is_prime(self.next_prime):
                    p = self.next_prime
                    self.next_prime += self.nth_root
                    return p
                else:
                    self.next_prime += self.nth_root
            if self.check_prev:
                if (self.bit_size - math.log2(self.prev_prime) >= 0.5
                        or self.prev_prime < self.nth_root):
                    self.check_prev = False
                elif is_prime(self.prev_prime):
                    p = self.prev_prime
                    self.prev_prime -= self.nth_root
                    return p
                else:
                    self.prev_prime -= self.nth_root

    def next_upstream_primes(self, k: int) -> list[int]:
        return [self.next_upstream_prime() for _ in range(k)]

    def next_downstream_primes(self, k: int) -> list[int]:
        return [self.next_downstream_prime() for _ in range(k)]

    def next_alternating_primes(self, k: int) -> list[int]:
        return [self.next_alternating_prime() for _ in range(k)]

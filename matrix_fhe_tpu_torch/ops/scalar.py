"""RNS scalar arithmetic (ring/scalar.go:1-76); numpy, a copy of
``matrix_fhe_tpu/ops/scalar.py``.

An RNS scalar is one residue per prime of the ring's modulus chain — the
representation of a big-integer constant that multiplies a polynomial
limb-wise.  Host-side (numpy/int) helpers; device-side use is via the ring's
``mul_scalar_*`` ops which broadcast the per-limb residues.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def new_rns_scalar(moduli: Sequence[int], value: int = 0) -> np.ndarray:
    """NewRNSScalarFromUInt64 / NewRNSScalar (ring/scalar.go:8-24)."""
    return np.array([value % q for q in moduli], dtype=np.uint64)


def from_bigint(moduli: Sequence[int], value: int) -> np.ndarray:
    """Reduce a (possibly negative) big integer into each residue."""
    return np.array([value % q for q in moduli], dtype=np.uint64)


def to_bigint(moduli: Sequence[int], s: np.ndarray) -> int:
    """CRT reconstruction of the scalar (inverse of :func:`from_bigint`)."""
    big_q = 1
    for q in moduli:
        big_q *= q
    acc = 0
    for q, r in zip(moduli, s.tolist()):
        qi = big_q // q
        acc += int(r) * qi * pow(qi, -1, q)
    return acc % big_q


def add(moduli: Sequence[int], a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """AddRNSScalar (ring/scalar.go:27-33)."""
    m = np.asarray(moduli, dtype=np.uint64)
    return (a + b) % m


def sub(moduli: Sequence[int], a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SubRNSScalar (ring/scalar.go:36-44)."""
    m = np.asarray(moduli, dtype=np.uint64)
    return (a + m - b) % m


def neg(moduli: Sequence[int], a: np.ndarray) -> np.ndarray:
    """NegRNSScalar (ring/scalar.go:47-53)."""
    m = np.asarray(moduli, dtype=np.uint64)
    return np.where(a == 0, a, m - a)


def mul(moduli: Sequence[int], a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """MulRNSScalar (ring/scalar.go:56-64) — exact via Python ints (the
    reference uses Montgomery form; host scalars don't need the form)."""
    return np.array([(int(x) * int(y)) % q
                     for x, y, q in zip(a.tolist(), b.tolist(), moduli)],
                    dtype=np.uint64)


def inverse(moduli: Sequence[int], a: np.ndarray) -> np.ndarray:
    """Per-residue modular inverse (used by the Shamir combiner,
    multiparty/threshold.go:186-215)."""
    return np.array([pow(int(x), -1, q) for x, q in zip(a.tolist(), moduli)],
                    dtype=np.uint64)


def mform(moduli: Sequence[int], a: np.ndarray) -> np.ndarray:
    """Montgomery form of each residue (ring/scalar.go:67-76)."""
    return np.array([(int(x) << 64) % q for x, q in zip(a.tolist(), moduli)],
                    dtype=np.uint64)

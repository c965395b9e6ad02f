"""Wide-modulus (41-61-bit) residues as 64-bit words.

Counterpart of ``matrix_fhe_tpu/ops/wide.py``.  The JAX package holds a
wide residue as a centered int32 pair with 5 or 6 balanced base-2^12 digit
planes, because the TPU has no 64-bit (nor widening 32x32) multiplier.  The
card has a 64-bit multiply-high, and the port already computes exactly on
64-bit words for moduli below 2^61 (``ops/modmath.py``), so here a wide
residue is one int64 word in [0, q): the form ``unpack_pair`` gives of the
JAX package's pairs.  The contract at every op boundary is

    port words == unpack_pair(JAX output, moduli).

Kept, by the JAX names: the range constants, ``use_pair31`` (the JAX mode
rule, which decides how ``pack_pair``/``unpack_pair`` read a pair),
``pack_pair``/``unpack_pair`` in numpy (for ``carry.py`` and the tests),
``check_moduli`` (``build_wide_tables``' range check) and the elementwise
ops ``add``/``sub``/``neg``/``mulmod``/``canon`` over words, through
``ops/modmath.py``'s Barrett reduction.  There is no Montgomery domain on
the wide path: a product is a*b mod q.  The plane helpers (``_bal12``,
``pair_to_planes``, ``fold_excess``, ``mac_planes``, ``planes_to_pair``,
``const_planes``, ``center_lift``, ...) and their tables have no
counterpart: a word needs none of them.

The range is the JAX package's pair31 range, [2^41, 2^61 + 2^55): its
"61-bit" primes alternate around 2^61.  Every lazy value of the wide path
stays below 4q < 2^64 and is read unsigned (``ops/modmath.py``), and a
modular sum folds 3 terms a round from 2^61 on (``modmath.sum_fold``).
The u64 rings keep ``modmath.MAX_MODULUS`` = 2^61.
"""

from __future__ import annotations

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import modmath as mm

MIN_WIDE_MODULUS = 1 << 41
PAIR25_MAX_MODULUS = 3 << 54        # 1.5 * 2^55: the JAX pair25 mode's limit
MAX_WIDE_MODULUS = (1 << 61) + (1 << 55)  # the JAX package's pair31 limit


def use_pair31(moduli) -> bool:
    """The JAX mode rule: pair31 (base 2^31) iff any modulus exceeds pair25
    capacity.  It decides how a JAX pair is read, nothing here."""
    return any(int(q) >= PAIR25_MAX_MODULUS for q in moduli)


def check_moduli(moduli) -> tuple[int, ...]:
    """The moduli as ints, each in [2^41, 2^61 + 2^55), or raise (the JAX
    package's ``build_wide_tables`` condition in its pair31 mode)."""
    moduli = tuple(int(q) for q in moduli)
    for q in moduli:
        if not MIN_WIDE_MODULUS <= q < MAX_WIDE_MODULUS:
            raise ValueError(f"modulus {q} outside the wide path range "
                             f"[2^41, {MAX_WIDE_MODULUS}) (2^61 + 2^55)")
    return moduli


# ---------------------------------------------------------------------------
# Pair <-> word conversion (numpy, exact), as the JAX package's.
# ---------------------------------------------------------------------------

def pack_pair(x: np.ndarray, moduli, pair31: bool | None = None) -> np.ndarray:
    """uint64 [.., L, N] canonical [0, q) -> int32 [.., 2, L, N] centered
    pair of the JAX package (``pair31`` as there: None derives it from
    ``moduli``)."""
    if pair31 is None:
        pair31 = use_pair31(moduli)
    shift = 31 if pair31 else 25
    bias, mask = 1 << (shift - 1), (1 << shift) - 1
    x = np.asarray(x, dtype=np.uint64).astype(np.int64)
    q = np.array([int(m) for m in moduli], dtype=np.int64).reshape(
        (1,) * (x.ndim - 2) + (-1, 1))
    c = np.where(x > q // 2, x - q, x)
    lo = ((c + bias) & mask) - bias
    hi = (c - lo) >> shift
    out = np.stack([lo, hi], axis=-3)
    assert np.all(np.abs(out) < (1 << 31))
    return out.astype(np.int32)


def unpack_pair(p: np.ndarray, moduli, pair31: bool | None = None) -> np.ndarray:
    """int32 [.., 2, L, N] pair (any bounded representative) -> uint64
    canonical [0, q): the port's words."""
    if pair31 is None:
        pair31 = use_pair31(moduli)
    shift = 31 if pair31 else 25
    p = np.asarray(p).astype(np.int64)
    lo, hi = p[..., 0, :, :], p[..., 1, :, :]
    q = np.array([int(m) for m in moduli], dtype=np.int64).reshape(
        (1,) * (lo.ndim - 2) + (-1, 1))
    return (((lo + (hi << shift)) % q) % q).astype(np.uint64)


# ---------------------------------------------------------------------------
# Elementwise ops on words [.., L, N]; q, bhi, blo broadcast as [L, 1].
# ---------------------------------------------------------------------------

def add(q, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mm.cred(a + b, q)


def sub(q, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mm.cred(a + q - b, q)


def neg(q, a: torch.Tensor) -> torch.Tensor:
    """-a mod q, canonical (0 stays 0, as the JAX pair's -0 unpacks)."""
    return mm.cred(q - a, q)


def mulmod(q, bhi, blo, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod q for any 64-bit words a, b (the 128-bit Barrett reduction)."""
    return mm.bred(a, b, q, bhi, blo)


def canon(q, bhi, a: torch.Tensor) -> torch.Tensor:
    """Any 64-bit word -> its canonical residue in [0, q)."""
    return mm.bred_add(a, q, bhi)

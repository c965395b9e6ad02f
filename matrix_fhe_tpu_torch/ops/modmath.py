"""64-bit modular arithmetic on int64 tensors (the u64 parity path).

Counterpart of ``matrix_fhe_tpu/ops/modmath.py`` (the reference's
ring/modular_reduction.go:9-205), vectorized over any broadcast shapes:

  * ``mred(x, y, q, qinv)``       = x*y*2^-64 mod q            (MRed)
  * ``mred_lazy``                 = same, output in [0, 2q)     (MRedLazy)
  * ``bred(x, y, q, bhi, blo)``   = x*y mod q                   (BRed)
  * ``bred_add(a, q, bhi)``       = a mod q for any 64-bit a    (BRedAdd)
  * ``mform(a, q, bhi, blo)``     = a*2^64 mod q                (MForm)
  * ``imform(a, q, qinv)``        = a*2^-64 mod q               (IMForm)
  * ``cred(a, q)``                = a mod q for a in [0, 2q)    (CRed)

torch has no usable uint64 (no ``remainder``, few kernels), so a word is an
int64 tensor holding the same 64 bits.  int64 ``*``, ``+`` and ``-`` wrap
modulo 2^64 like their uint64 counterparts, so products and sums keep the
exact low word.  What differs from uint64, and how it is handled here:

  * ``>>`` is arithmetic: every right shift is masked, ``(x >> 32) & M32``;
  * ``<`` is signed: an unsigned compare flips the top bit of both sides
    first (``_ult``), as ``add64_carry`` needs;
  * ``cred`` tests the sign of a - q, which is right for every a in
    [0, q + 2^63) read as unsigned, so for its [0, 2q) at any q < 2^63.
    The lazy values of [0, 4q) that some callers form (a + 2q - b, the
    3N and rescale sums) go only into a Montgomery product or a Barrett
    reduction, which read all 64 bits unsigned.  ``modsum`` folds 4 terms
    of [0, 2q) a round below 2^61 and 3 from there on (``sum_fold``).

Two ranges of moduli: ``MAX_MODULUS`` = 2^61 for the u64 rings, the 3N
ring, the sharded NTT and BGV (``check_modulus``, as the JAX package's u64
path), and the wide path's 2^61 + 2^55 (``ops/wide.py:MAX_WIDE_MODULUS``,
passed to ``check_modulus`` by ``fast/wring.py``), where 4q < 2^64 still
holds for every lazy range above.

Host-side constants (``gen_mred_constant``, ``gen_bred_constant``) are
Python big ints, as in the reference (GenMRedConstant, GenBRedConstant);
``signed`` turns one into the int64 that holds its bits.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.utils.device import constant

MASK64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)
MAX_MODULUS = 1 << 61  # the u64 path's moduli (4 lazy terms of [0, 2q) a modsum round)


def signed(v: int) -> int:
    """The int64 value with the bits of the unsigned 64-bit word ``v``."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def unsigned(v: int) -> int:
    """The unsigned 64-bit word held by the int64 value ``v``."""
    return v & MASK64


def check_modulus(q: int, limit: int = MAX_MODULUS) -> None:
    """Raise unless 1 < q < limit (``MAX_MODULUS``, or the wide path's
    ``wide.MAX_WIDE_MODULUS``)."""
    if not 1 < q < limit:
        raise ValueError(f"modulus {q} outside (1, {limit}) (2^61 for the u64 path, "
                         f"2^61 + 2^55 for the wide one)")


def sum_fold(moduli) -> int:
    """Terms of [0, 2q) that ``modsum`` adds a round for ``moduli``: 4 below
    2^61 (8q < 2^64), 3 up to the wide path's 2^61 + 2^55 (6q < 2^64)."""
    return 4 if max(int(q) for q in moduli) < MAX_MODULUS else 3


# ---------------------------------------------------------------------------
# Host-side constants (Python big ints, exact).
# ---------------------------------------------------------------------------

def gen_mred_constant(q: int) -> int:
    """(q^-1) mod 2^64 (Newton iteration, ring/modular_reduction.go:68-75)."""
    qinv = 1
    for _ in range(6):  # Newton: doubles correct bits; 6 iters > 64 bits
        qinv = (qinv * (2 - q * qinv)) & MASK64
    if (q * qinv) & MASK64 != 1:
        raise ValueError(f"modulus {q} is even: no inverse mod 2^64")
    return qinv


def gen_bred_constant(q: int) -> tuple[int, int]:
    """(floor(2^128/q) >> 64, floor(2^128/q) mod 2^64)
    (ring/modular_reduction.go:97-107)."""
    big_r = (1 << 128) // q
    return (big_r >> 64) & MASK64, big_r & MASK64


# ---------------------------------------------------------------------------
# Device-side primitives on int64 words.  All inputs broadcast.
# ---------------------------------------------------------------------------

def _hi32(x: torch.Tensor) -> torch.Tensor:
    """Logical x >> 32 of a 64-bit word."""
    return (x >> 32) & M32


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of two 64-bit words."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def mul64_hi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the 128-bit product a*b (bits.Mul64 high word)."""
    a0, a1 = a & M32, _hi32(a)
    b0, b1 = b & M32, _hi32(b)
    lo_lo = a0 * b0
    hi_lo = a1 * b0
    lo_hi = a0 * b1
    # cross < 2^64: (2^32-2) + (2^32-1) + (2^32-1)^2 < 2^64
    cross = _hi32(lo_lo) + (hi_lo & M32) + lo_hi
    return a1 * b1 + _hi32(hi_lo) + _hi32(cross)


def mul64_hi_lo(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 64-bit words of a*b (bits.Mul64)."""
    return mul64_hi(a, b), a * b  # the wrapping product is the low word


def add64_carry(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum mod 2^64, carry) (bits.Add64)."""
    s = a + b
    return s, _ult(s, a).to(torch.int64)


def cred(a: torch.Tensor, q) -> torch.Tensor:
    """a mod q for a in [0, 2q), any q < 2^63: a - q is negative as a signed
    word exactly when a < q, for every a in [0, q + 2^63) read unsigned."""
    d = a - q
    return torch.where(d >= 0, d, a)


def mred_lazy(x, y, q, qinv):
    """x*y*2^-64 mod q, output in [0, 2q)."""
    mhi, mlo = mul64_hi_lo(x, y)
    hhi = mul64_hi(mlo * qinv, q)
    return mhi - hhi + q


def mred(x, y, q, qinv):
    """x*y*2^-64 mod q, fully reduced."""
    return cred(mred_lazy(x, y, q, qinv), q)


def imform(a, q, qinv):
    """a*2^-64 mod q (Montgomery -> standard domain)."""
    r = mul64_hi(a * qinv, q)
    return cred(q - r, q)


def mform_lazy(a, q, bhi, blo):
    """a*2^64 mod q, output in [0, 2q) (ring/modular_reduction.go:40)."""
    mhi = mul64_hi(a, blo)
    return -((a * bhi + mhi) * q)


def mform(a, q, bhi, blo):
    """a*2^64 mod q (standard -> Montgomery domain)."""
    return cred(mform_lazy(a, q, bhi, blo), q)


def bred_add_lazy(x, q, bhi):
    """x mod q in [0, 2q) for any 64-bit x (BRedAddLazy)."""
    return x - mul64_hi(x, bhi) * q


def bred_add(a, q, bhi):
    """a mod q for any 64-bit a (BRedAdd)."""
    return cred(bred_add_lazy(a, q, bhi), q)


def bred_lazy(x, y, q, bhi, blo):
    """x*y mod q in [0, 2q) (full 128-bit Barrett, BRedLazy :166-197)."""
    mhi, mlo = mul64_hi_lo(x, y)
    r = mhi * bhi
    hhi, hlo = mul64_hi_lo(mlo, bhi)
    r = r + hhi
    lhi = mul64_hi(mlo, blo)
    s0, carry = add64_carry(hlo, lhi)
    r = r + carry
    hhi2, hlo2 = mul64_hi_lo(mhi, blo)
    r = r + hhi2
    _, carry2 = add64_carry(hlo2, s0)
    r = r + carry2
    return mlo - r * q


def bred(x, y, q, bhi, blo):
    """x*y mod q, fully reduced (BRed)."""
    return cred(bred_lazy(x, y, q, bhi, blo), q)


def modsum(x: torch.Tensor, q, bhi, dim: int = -1, fold: int = 4) -> torch.Tensor:
    """Sum of values < 2q along ``dim``, mod q.

    Tree reduction folding ``fold`` terms a round (fold * 2q < 2^64: 4 for
    q < 2^61, 3 for the wide path's moduli up to 2^61 + 2^55, ``sum_fold``;
    the int64 sum wraps to the same 64-bit word, read unsigned) with a
    Barrett reduction, to [0, 2q), between rounds.  ``q``/``bhi`` broadcast
    against ``x`` with ``dim`` removed."""
    x = torch.movedim(x, dim, -1)
    q, bhi = (v.to(x.device) if isinstance(v, torch.Tensor) else constant(v, torch.int64, x.device)
              for v in (q, bhi))
    qe, be = q[..., None], bhi[..., None]
    while x.shape[-1] > 1:
        n = x.shape[-1]
        pad = (-n) % fold
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        x = x.reshape(x.shape[:-1] + ((n + pad) // fold, fold)).sum(dim=-1, dtype=torch.int64)
        x = bred_add_lazy(x, qe, be)
    return bred_add(x[..., 0], q, bhi)

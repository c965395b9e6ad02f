"""Complex products on the host whose float64 results do not depend on the
machine or the numpy build.

numpy's complex multiply is not the same function everywhere: numpy 2.0 on
an AVX-512 host computes (ar + i ai)(br + i bi) as
``re = fma(ar, br, -(ai bi))``, ``im = fma(ar, bi, ai br)`` (one rounding
saved in each part), other builds and hosts round ``ar br - ai bi`` twice.
The CKKS encoder's special IFFT and the DFT matrices' factors are built from
such products and then rounded to integers, so a last-bit difference moves a
coefficient and changes the encoded words.  ``cmul`` computes the fused form
exactly with float64 additions and multiplications alone, which IEEE 754
rounds the same on every host; ``fma`` is correctly rounded (Boldo and
Melquiond's emulation through round-to-odd), given no overflow or underflow
in the products, as holds for the bounded values of an FFT.
"""

from __future__ import annotations

import numpy as np

_SPLIT = float((1 << 27) + 1)  # Veltkamp's splitter for 53-bit significands


def _two_sum(a, b):
    """s, e with s = RN(a + b) and s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p, e with p = RN(a b) and p + e == a b exactly (Dekker)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(a, b):
    """a + b rounded to odd: exact sums as they are, else the neighbour of
    RN(a + b) toward the exact sum when RN(a + b) has an even significand."""
    s, e = _two_sum(a, b)
    s, e = np.array(s, dtype=np.float64), np.asarray(e)
    inexact = np.flatnonzero(e)  # few: the sums are mostly exact
    if inexact.size:
        flat, err = s.reshape(-1), e.reshape(-1)[inexact]
        near = flat[inexact]
        even = (near.view(np.int64) & 1) == 0
        flat[inexact] = np.where(even, np.nextafter(near, np.where(err > 0, np.inf, -np.inf)),
                                 near)
    return s


def fma(a, b, c) -> np.ndarray:
    """RN(a b + c) elementwise over float64 arrays (broadcast)."""
    uh, ul = _two_prod(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))
    th, tl = _two_sum(np.asarray(c, dtype=np.float64), uh)
    return th + _add_odd(tl, ul)


def cmul(a, b) -> np.ndarray:
    """a b over complex128 arrays (broadcast) in the fused form above."""
    a, b = np.asarray(a, dtype=np.complex128), np.asarray(b, dtype=np.complex128)
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    re = fma(ar, br, -(ai * bi))
    im = fma(ar, bi, ai * br)
    out = np.empty(re.shape, dtype=np.complex128)
    out.real, out.imag = re, im
    return out

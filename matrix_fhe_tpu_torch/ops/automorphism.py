"""Galois automorphisms X^i -> X^(i*k) as gathers.

Counterpart of ``matrix_fhe_tpu/ops/automorphism.py`` (ring/automorphism.go)
for the standard ring: in the NTT domain the automorphism is a pure
permutation of slots (``automorphism_ntt_index``, :12-34); in the
coefficient domain a permutation with sign flips (:111-176).  The 3N-ring
index is not ported yet (ROADMAP A8)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops.tables import bit_reverse_array


@functools.lru_cache(maxsize=None)
def automorphism_ntt_index(n: int, nth_root: int, gal_el: int) -> np.ndarray:
    """int32 [N] permutation for the NTT-domain automorphism:
    out[i] = in[index[i]]."""
    if n & (n - 1) or nth_root & (nth_root - 1):
        raise ValueError("N and NthRoot must be powers of two")
    # bits.Len64(NthRoot-1) - 1 == log2(NthRoot) - 1 (ring/automorphism.go:23)
    log_nth = (nth_root - 1).bit_length() - 1
    mask = nth_root - 1
    i = np.arange(n, dtype=np.uint64)
    tmp1 = 2 * bit_reverse_array(i, log_nth) + 1
    tmp2 = ((np.uint64(gal_el) * tmp1 & np.uint64(mask)) - 1) >> np.uint64(1)
    idx = bit_reverse_array(tmp2, log_nth).astype(np.int32)
    idx.setflags(write=False)  # cached: shared by every caller
    return idx


def _gather(p: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    return p[..., torch.from_numpy(np.asarray(src, dtype=np.int64)).to(p.device)]


def _negate_where(ring, g: torch.Tensor, flip: np.ndarray) -> torch.Tensor:
    """g with the coefficients at ``flip`` negated mod q (fully reduced)."""
    q = ring.moduli[:, None]
    neg = torch.where(g == 0, g, q - g)
    return torch.where(torch.from_numpy(flip == 1).to(g.device), neg, g)


def automorphism_ntt(ring, p: torch.Tensor, gal_el: int) -> torch.Tensor:
    """NTT-domain automorphism on a standard ring: a gather."""
    return _gather(p, automorphism_ntt_index(ring.n, ring.nth_root, gal_el))


def automorphism_coeff(ring, p: torch.Tensor, gal_el: int) -> torch.Tensor:
    """Coefficient-domain automorphism on a standard ring
    (ring/automorphism.go:111-176): out[(i*k) mod N] = (-1)^floor(i*k/N) in[i],
    fully reduced (the reference may leave q for -0)."""
    n = ring.n
    i = np.arange(n, dtype=np.uint64)
    raw = i * np.uint64(gal_el)
    dst = (raw & np.uint64(n - 1)).astype(np.int64)
    sign = ((raw >> np.uint64(n.bit_length() - 1)) & np.uint64(1)).astype(np.int64)
    src = np.zeros(n, dtype=np.int64)
    src[dst] = np.arange(n)  # gal_el odd: a bijection
    flip = np.zeros(n, dtype=np.int64)
    flip[dst] = sign
    return _negate_where(ring, _gather(p, src), flip)


def shift(p: torch.Tensor, k: int) -> torch.Tensor:
    """Cyclic coefficient shift (ring/operations.go:278)."""
    return torch.roll(p, -k, dims=-1)


def mult_by_monomial(ring, p: torch.Tensor, k: int) -> torch.Tensor:
    """p * X^k in Z_q[X]/(X^N+1) (ring/operations.go:306): out[j] =
    (-1)^w p[i] with i = (j - k) mod N, w = floor((i + m)/N) & 1, m = k mod 2N."""
    n = ring.n
    m = k % (2 * n)
    src = (np.arange(n, dtype=np.int64) - m) % n
    flip = ((src + m) // n) & 1
    return _negate_where(ring, _gather(p, src), flip)

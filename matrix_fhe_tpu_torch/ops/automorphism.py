"""Galois automorphisms X^i -> X^(i*k) as gathers.

Counterpart of ``matrix_fhe_tpu/ops/automorphism.py`` (ring/automorphism.go)
for the three ring types: in the NTT domain the automorphism is a pure
permutation of slots (``automorphism_ntt_index``, :12-34, for the
power-of-two rings; ``automorphism_ntt_index_3n``, a permutation of the
totatives of 3N, for the 3N ring); in the coefficient domain a permutation
with sign flips (:111-176, the CI ring's through its 2N-degree cover).  The
reference defines no coefficient-domain automorphism on the 3N ring."""

from __future__ import annotations

import functools
import math

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


@functools.lru_cache(maxsize=None)
def automorphism_ntt_index_3n(n: int, nth_root: int, gal_el: int) -> np.ndarray:
    """int32 [N] permutation for the NTT-domain automorphism of the 3N ring:
    the transform evaluates at x_k = omega^E[k] (E the sorted totatives of
    3N, ring/ntt_3n.go:234-243), and X -> X^g takes the evaluation at x to
    the one at x^g, a permutation of the totatives."""
    if math.gcd(gal_el, nth_root) != 1:
        raise ValueError(f"galois element {gal_el} not coprime to {nth_root}")
    E = [e for e in range(1, nth_root) if math.gcd(e, nth_root) == 1]
    pos = {e: k for k, e in enumerate(E)}
    idx = np.array([pos[(E[i] * gal_el) % nth_root] for i in range(n)], dtype=np.int32)
    idx.setflags(write=False)  # cached: shared by every caller
    return idx


def ntt_index(ring_type: str, n: int, nth_root: int, gal_el: int) -> np.ndarray:
    """The NTT-domain permutation of ``gal_el`` on a ring of this type."""
    if ring_type == "matrix":
        return automorphism_ntt_index_3n(n, nth_root, gal_el)
    return automorphism_ntt_index(n, nth_root, gal_el)


def _negate_where(ring, g: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """g with the coefficients where ``flip`` is true negated mod q (fully
    reduced)."""
    q = ring.moduli[:, None]
    neg = torch.where(g == 0, g, q - g)
    return torch.where(flip, neg, g)


@functools.lru_cache(maxsize=None)
def _device_index(ring_type: str, n: int, nth_root: int, gal_el: int,
                  device: torch.device) -> torch.Tensor:
    """``ntt_index`` as an int64 tensor on ``device``, moved there once: a
    gather then copies nothing from the host (a copy from pageable host
    memory waits for the device)."""
    idx = ntt_index(ring_type, n, nth_root, gal_el)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def automorphism_ntt(ring, p: torch.Tensor, gal_el: int) -> torch.Tensor:
    """NTT-domain automorphism: a gather."""
    return p[..., _device_index(ring.ring_type, ring.n, ring.nth_root, gal_el, p.device)]


@functools.lru_cache(maxsize=None)
def _ci_coeff_map(n: int, gal_el: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, flip) of the CI ring's coefficient-domain automorphism, folded
    through the 2N-degree cover (ring/automorphism.go:122-154)."""
    two_n = 2 * n
    mask = two_n - 1
    logn = mask.bit_length()
    src = np.zeros(n, dtype=np.int64)
    flip = np.zeros(n, dtype=np.int64)
    for i in range(two_n):
        raw = i * gal_el
        index = raw & mask
        tmp = (raw >> logn) & 1
        if index < n:
            idx = i
            if idx >= n:
                idx = two_n - idx
                tmp ^= 1
            src[index] = idx
            flip[index] = tmp
    return src, flip


@functools.lru_cache(maxsize=None)
def _coeff_map(ring_type: str, n: int, gal_el: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, flip) of the coefficient-domain automorphism: out[i] =
    (-1)^flip[i] in[src[i]], as tensors on ``device``, moved there once."""
    if ring_type == "conjugate_invariant":
        src, flip = _ci_coeff_map(n, gal_el)
    else:
        i = np.arange(n, dtype=np.uint64)
        raw = i * np.uint64(gal_el)
        dst = (raw & np.uint64(n - 1)).astype(np.int64)
        sign = ((raw >> np.uint64(n.bit_length() - 1)) & np.uint64(1)).astype(np.int64)
        src = np.zeros(n, dtype=np.int64)
        src[dst] = np.arange(n)  # gal_el odd: a bijection
        flip = np.zeros(n, dtype=np.int64)
        flip[dst] = sign
    return torch.from_numpy(src).to(device), torch.from_numpy(flip == 1).to(device)


def automorphism_coeff(ring, p: torch.Tensor, gal_el: int) -> torch.Tensor:
    """Coefficient-domain automorphism (ring/automorphism.go:111-176), fully
    reduced (the reference may leave q for -0).  Standard ring:
    out[(i*k) mod N] = (-1)^floor(i*k/N) in[i]; CI ring: the same on the
    2N-degree cover, folded back."""
    if ring.ring_type not in ("standard", "conjugate_invariant"):
        raise NotImplementedError("automorphism on 3N rings is not defined by the reference")
    src, flip = _coeff_map(ring.ring_type, ring.n, gal_el, p.device)
    return _negate_where(ring, p[..., src], flip)


def shift(p: torch.Tensor, k: int) -> torch.Tensor:
    """Cyclic coefficient shift (ring/operations.go:278)."""
    return torch.roll(p, -k, dims=-1)


def mult_by_monomial(ring, p: torch.Tensor, k: int) -> torch.Tensor:
    """p * X^k in Z_q[X]/(X^N+1) (ring/operations.go:306): out[j] =
    (-1)^w p[i] with i = (j - k) mod N, w = floor((i + m)/N) & 1, m = k mod 2N
    (the indices made on p's device, so nothing is copied from the host)."""
    n = ring.n
    m = k % (2 * n)
    src = torch.remainder(torch.arange(n, device=p.device) - m, n)
    flip = torch.bitwise_and(torch.div(src + m, n, rounding_mode="floor"), 1) == 1
    return _negate_where(ring, p[..., src], flip)

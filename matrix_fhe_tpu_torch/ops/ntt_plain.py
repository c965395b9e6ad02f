"""The negacyclic NTT in plain torch: a four-step product of exact matmuls.

Counterpart of ``matrix_fhe_tpu/ops/mxu_ntt.py``, and the plain version of
the CUDA kernel in ``ops/ntt_cuda.py`` (one transform, or ``ntt_chain_plain``
for k chained ones) and ``ops/ntt_w22.py``: CPU tensors take this path, and
the kernel is held against it on the card.  With N = R*C and X = x viewed [R, C]:

    forward:  out = (T .* (A @ X)) @ B^T
    inverse:  x   = Ainv @ (Tinv .* (out @ Binv^T))

with the factors of ``four_step_factors``.  The output is in the reference's
bit-reversed order, out[i] = x(psi^(2 brv(i) + 1)), canonical in [0, q).

Exactness: the operands of each matmul are centered residues, |v| < 2^22, so
every product is below 2^44 and every partial sum of K <= 256 products is an
integer below 2^52.  float64 holds all of them exactly, whatever order the
matmul sums in, so the matmuls run in float64 (on the CPU and on the card;
torch has no integer matmul on CUDA).  Each stage is reduced in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops.tables import bit_reverse, psi_powers

# float64 sums of K centered products stay exact while K * 2^44 < 2^53.
MAX_PLAIN_SPLIT = 1 << 8


def four_step_factors(n: int, q: int, psi: int):
    """Closed-form four-step factors for modulus q and 2N-th root psi.

    Returns (A, T, B, Ainv, Binv, Tinv) as int64 numpy arrays in [0, q):
        A[ihi, j1]   = psi^(C (2 brv(ihi) + 1) j1)          [R, R]
        T[ihi, j0]   = psi^((2 brv(ihi) + 1) j0)            [R, C]
        B[ilo, j0]   = psi^(2R brv(ilo) j0)                 [C, C]
        Ainv[j1, i]  = R^-1 psi^(-C (2 brv(i) + 1) j1)      [R, R]
        Binv[j0, i]  = C^-1 psi^(-2R brv(i) j0)             [C, C]
        Tinv[ihi, j0] = psi^(-(2 brv(ihi) + 1) j0)          [R, C]
    with R = 2^floor(logN/2), C = N/R (N^-1 = R^-1 C^-1 split across the
    two inverse factors)."""
    logn = n.bit_length() - 1
    a_bits = logn // 2
    b_bits = logn - a_bits
    R, C = 1 << a_bits, 1 << b_bits
    two_n = 2 * n
    pows = psi_powers(n, q, psi)

    e_hi = np.array([2 * bit_reverse(i, a_bits) + 1 for i in range(R)],
                    dtype=np.int64)
    brv_c = np.array([bit_reverse(i, b_bits) for i in range(C)],
                     dtype=np.int64)
    j1 = np.arange(R, dtype=np.int64)
    j0 = np.arange(C, dtype=np.int64)
    rinv = pow(R, q - 2, q)
    cinv = pow(C, q - 2, q)

    A = pows[(C * e_hi[:, None] * j1[None]) % two_n]
    T = pows[(e_hi[:, None] * j0[None]) % two_n]
    B = pows[(2 * R * brv_c[:, None] * j0[None]) % two_n]
    # object ints: a psi power times R^-1 may overflow int64 for wide moduli
    Ainv = (pows[(-C * j1[:, None] * e_hi[None]) % two_n].astype(object)
            * rinv % q).astype(np.int64)
    Binv = (pows[(-2 * R * j0[:, None] * brv_c[None]) % two_n].astype(object)
            * cinv % q).astype(np.int64)
    Tinv = pows[(-e_hi[:, None] * j0[None]) % two_n]
    return A, T, B, Ainv, Binv, Tinv


def _centered_f64(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.where(v > q >> 1, v - q, v).to(torch.float64)


def _matmul_mod(m: torch.Tensor, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact (m @ v) mod q for float64 centered operands -> int64 [0, q)."""
    return torch.remainder(torch.bmm(m, v).to(torch.int64), q)


def _limb_major(x: torch.Tensor, R: int, C: int):
    """[..., L, N] -> int64 [L, R, B, C] (B = product of the leading dims)."""
    *lead, L, N = x.shape
    B = int(np.prod(lead, dtype=np.int64))
    return x.reshape(B, L, R, C).permute(1, 2, 0, 3).to(torch.int64), B


def _back(y: torch.Tensor, shape, dtype) -> torch.Tensor:
    """int64 [L, R, B, C] -> [..., L, N] of ``dtype``."""
    return y.permute(2, 0, 1, 3).reshape(shape).to(dtype)


def ntt_fwd_plain(x: torch.Tensor, tabs) -> torch.Tensor:
    """Forward NTT of int32 [..., L, N] canonical residues (limb l of the
    last-but-one axis under modulus tabs.moduli[l])."""
    R, C = tabs.rows, tabs.cols
    L = x.shape[-2]
    q = tabs.moduli.to(torch.int64).reshape(L, 1, 1)
    xm, B = _limb_major(x, R, C)
    y = _matmul_mod(tabs.fs_a, _centered_f64(xm, q[..., None]).reshape(L, R, B * C), q)
    w = torch.remainder(y.reshape(L, R, B, C) * tabs.fs_t[:, :, None, :], q[..., None])
    out = _matmul_mod(_centered_f64(w, q[..., None]).reshape(L, R * B, C), tabs.fs_bt, q)
    return _back(out.reshape(L, R, B, C), x.shape, x.dtype)


def ntt_bwd_plain(x: torch.Tensor, tabs) -> torch.Tensor:
    """Inverse of ``ntt_fwd_plain`` (N^-1 included)."""
    R, C = tabs.rows, tabs.cols
    L = x.shape[-2]
    q = tabs.moduli.to(torch.int64).reshape(L, 1, 1)
    xm, B = _limb_major(x, R, C)
    v = _matmul_mod(_centered_f64(xm, q[..., None]).reshape(L, R * B, C), tabs.fs_binvt, q)
    w = torch.remainder(v.reshape(L, R, B, C) * tabs.fs_tinv[:, :, None, :], q[..., None])
    out = _matmul_mod(tabs.fs_ainv, _centered_f64(w, q[..., None]).reshape(L, R, B * C), q)
    return _back(out.reshape(L, R, B, C), x.shape, x.dtype)


def ntt_chain_plain(x: torch.Tensor, tabs, k: int, fwd: bool = True) -> torch.Tensor:
    """The forward (``fwd``) or inverse transform applied ``k`` times."""
    step = ntt_fwd_plain if fwd else ntt_bwd_plain
    for _ in range(k):
        x = step(x, tabs)
    return x

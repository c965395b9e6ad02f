"""The factorized NTT of the 3N ring Z_q[X]/(X^N - X^{N/2} + 1), as torch ops.

Counterpart of ``matrix_fhe_tpu/ops/ntt_3n.py`` (the fork's ring/ntt_3n.go,
N = 2^a 3^b): the transform evaluates a degree-N polynomial at the N
primitive 3N-th roots of unity omega^e, e running over the totatives E of
3N in ascending order, in four steps:

1. cyclotomic split: X^N - X^{N/2} + 1 = (X^M - z)(X^M - z^5) with M = N/2
   and z = omega^M, so x folds into two branches, lo + z hi and lo + z^5 hi;
2. twist: the branch coefficients times omega^{+i} / omega^{-i} turn each
   branch into a cyclic DFT of size M;
3. four-step DFT_M with M = R C: an [R, R] Montgomery mod-matmul, a twiddle,
   a [C, C] mod-matmul, the output in the order k = k1 + R k2;
4. the closed-form permutation to the E-sorted order.

The inverse runs the exact inverse of each step (1/M folded into the
inverse R-side matrix, the untwist, a 2x2 CRT solve).  Words are int64
tensors holding 64-bit residues canonical in [0, q) (``ops/modmath.py``),
so every output equals the JAX package's bit for bit.

This is the plain version of kernel B5 (``ops/ntt3n_cuda.py``,
``csrc/ntt3n.cu``); the tables are built on the host with Python big ints
and live on the ring's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.utils.device import resolve_device


def split_rc(m: int) -> tuple[int, int]:
    """M = R * C with R <= C, R the largest divisor of M not above sqrt(M)."""
    best = (1, m)
    r = 1
    while r * r <= m:
        if m % r == 0:
            best = (r, m // r)
        r += 1
        while r * r <= m and m % r:
            r += 1
    return best


def _mont(v: int, q: int) -> int:
    return (v << 64) % q


def _powers(base: int, count: int, q: int) -> list[int]:
    out, acc = [], 1
    for _ in range(count):
        out.append(acc)
        acc = acc * base % q
    return out


# the [L, ...] tables, sliced by limb
LIMB_FIELDS = ("z_pow", "tw1", "tw2", "wr", "wc", "twid", "wri", "wci", "twidi",
               "untw1", "untw2", "inv_diff")


@dataclasses.dataclass(frozen=True)
class NTT3NTables:
    """Per-limb constants of the factorized transform, all in Montgomery
    form, int64 tensors on one device."""
    n: int
    rows: int                # R
    cols: int                # C (R * C = N/2)
    z_pow: torch.Tensor      # [L, 2]    MForm(z), MForm(z^5)
    tw1: torch.Tensor        # [L, M]    MForm(omega^i)
    tw2: torch.Tensor        # [L, M]    MForm(omega^-i)
    wr: torch.Tensor         # [L, R, R] DFT_R (omega_M^C powers)
    wc: torch.Tensor         # [L, C, C] DFT_C (omega_M^R powers)
    twid: torch.Tensor       # [L, R, C] omega_M^{k1 j0}
    wri: torch.Tensor        # [L, R, R] inverse DFT_R, 1/M folded in
    wci: torch.Tensor        # [L, C, C] inverse DFT_C
    twidi: torch.Tensor      # [L, R, C] omega_M^{-k1 j0}
    untw1: torch.Tensor      # [L, M]    MForm(omega^-i)
    untw2: torch.Tensor      # [L, M]    MForm(omega^i)
    inv_diff: torch.Tensor   # [L]       MForm((z - z^5)^-1)
    perm: torch.Tensor       # int64 [N] (branch, slot) -> E-sorted position
    iperm: torch.Tensor      # int64 [N] E-sorted position -> (branch, slot)

    def limbs(self, s: slice) -> "NTT3NTables":
        """The tables of the limbs in ``s`` (views, contiguous for a step-1 slice)."""
        return dataclasses.replace(self, **{f: getattr(self, f)[s] for f in LIMB_FIELDS})


def build_tables(n: int, moduli, omegas, device="cuda") -> NTT3NTables:
    """The tables on ``device`` (the card unless told otherwise);
    ``omegas[l]`` is the primitive 3N-th root of ``moduli[l]`` the ring's
    dense transform uses (``rings._gen_3n_tables``)."""
    device = resolve_device(device)
    three_n, m = 3 * n, n // 2
    R, C = split_rc(m)
    if R < 2:
        raise ValueError(f"N={n}: M={m} has no nontrivial R*C split")
    E = [e for e in range(1, three_n) if math.gcd(e, three_n) == 1]
    assert len(E) == n
    # branch points: omega^{1 + 6 mm} (branch 0) and omega^{-1 + 6 mm}
    # (branch 1); E is sorted, so a point's position is its index in E
    pos = {e: k for k, e in enumerate(E)}
    perm = [pos[(1 + 6 * j) % three_n] for j in range(m)] + \
           [pos[(-1 + 6 * j) % three_n] for j in range(m)]
    iperm = [0] * n
    for i, p in enumerate(perm):
        iperm[p] = i

    cols = {f: [] for f in LIMB_FIELDS}
    for q, omega in zip(moduli, omegas):
        q, omega = int(q), int(omega)
        assert pow(omega, three_n, q) == 1 and pow(omega, three_n // 2, q) != 1
        z = pow(omega, m, q)             # primitive 6th root
        w_m = pow(omega, 6, q)           # order M
        w_r, w_c = pow(w_m, C, q), pow(w_m, R, q)
        oinv = pow(omega, q - 2, q)
        minv = pow(m, q - 2, q)
        w_ri, w_ci, w_mi = pow(w_r, q - 2, q), pow(w_c, q - 2, q), pow(w_m, q - 2, q)
        mont = lambda vs: [_mont(v, q) for v in vs]  # noqa: E731
        fwd, inv = mont(_powers(omega, m, q)), mont(_powers(oinv, m, q))
        pr_, pc_ = _powers(w_r, R, q), _powers(w_c, C, q)
        pri, pci = _powers(w_ri, R, q), _powers(w_ci, C, q)
        cols["z_pow"].append(mont([z, pow(z, 5, q)]))
        cols["tw1"].append(fwd)
        cols["tw2"].append(inv)
        cols["untw1"].append(inv)
        cols["untw2"].append(fwd)
        cols["wr"].append([mont(pr_[(k * j) % R] for j in range(R)) for k in range(R)])
        cols["wc"].append([mont(pc_[(k * j) % C] for j in range(C)) for k in range(C)])
        cols["twid"].append([mont(_powers(pow(w_m, k, q), C, q)) for k in range(R)])
        cols["wri"].append([mont(minv * pri[(k * j) % R] % q for j in range(R))
                            for k in range(R)])
        cols["wci"].append([mont(pci[(k * j) % C] for j in range(C)) for k in range(C)])
        cols["twidi"].append([mont(_powers(pow(w_mi, k, q), C, q)) for k in range(R)])
        cols["inv_diff"].append(_mont(pow((z - pow(z, 5, q)) % q, q - 2, q), q))

    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return NTT3NTables(n=n, rows=R, cols=C, perm=t(perm), iperm=t(iperm),
                       **{f: t(v) for f, v in cols.items()})


# ---------------------------------------------------------------------------
# The transform (layouts [.., L, X]; q, qinv, bhi are the ring's [L] words).
# ---------------------------------------------------------------------------

def _matmul_mod(x, w, q, qinv, bhi):
    """x [.., L, A, B] against w [L, K, A] -> [.., L, K, B]:
    out[k, b] = sum_a w[k, a] x[a, b], Montgomery products summed mod q."""
    prod = mm.mred(x[..., None, :, :], w[..., :, :, None],
                   q[:, None, None, None], qinv[:, None, None, None])
    return mm.modsum(prod, q[:, None, None], bhi[:, None, None], dim=-2)


def _contract_last(a, w, q, qinv, bhi):
    """out[.., i, o] = sum_j w[o, j] a[.., i, j] (w [L, O, J])."""
    prod = mm.mred(a[..., :, None, :], w[..., None, :, :],
                   q[:, None, None, None], qinv[:, None, None, None])
    return mm.modsum(prod, q[:, None, None], bhi[:, None, None], dim=-1)


def _dft_m(y, t: NTT3NTables, q, qinv, bhi):
    """Size-M cyclic DFT of y [.., L, M] (four-step), output order
    k = k1 + R k2."""
    R, C = t.rows, t.cols
    y = y.reshape(y.shape[:-1] + (R, C))           # [.., L, j1, j0]
    a = _matmul_mod(y, t.wr, q, qinv, bhi)         # [.., L, k1, j0]
    a = mm.mred(a, t.twid, q[:, None, None], qinv[:, None, None])
    z = _contract_last(a, t.wc, q, qinv, bhi)      # [.., L, k1, k2]
    return z.transpose(-1, -2).reshape(z.shape[:-2] + (R * C,))


def _idft_m(y, t: NTT3NTables, q, qinv, bhi):
    """The exact inverse of ``_dft_m`` (k = k1 + R k2 in, j = j1 C + j0 out)."""
    R, C = t.rows, t.cols
    y = y.reshape(y.shape[:-1] + (C, R)).transpose(-1, -2)   # [.., L, k1, k2]
    a = _contract_last(y, t.wci, q, qinv, bhi)     # [.., L, k1, j0]
    a = mm.mred(a, t.twidi, q[:, None, None], qinv[:, None, None])
    z = _matmul_mod(a, t.wri, q, qinv, bhi)        # [.., L, j1, j0], with 1/M
    return z.reshape(z.shape[:-2] + (R * C,))


def ntt_fwd(x: torch.Tensor, t: NTT3NTables, q, qinv, bhi) -> torch.Tensor:
    """x [.., L, N] coefficients -> evaluations at the E-sorted primitive
    3N-th roots."""
    half = t.n // 2
    lo, hi = x[..., :half], x[..., half:]
    qq, qi = q[:, None], qinv[:, None]
    u = mm.cred(lo + mm.mred(hi, t.z_pow[:, 0:1], qq, qi), qq)
    w = mm.cred(lo + mm.mred(hi, t.z_pow[:, 1:2], qq, qi), qq)
    u = mm.mred(u, t.tw1, qq, qi)
    w = mm.mred(w, t.tw2, qq, qi)
    both = torch.cat([_dft_m(u, t, q, qinv, bhi), _dft_m(w, t, q, qinv, bhi)], dim=-1)
    return both[..., t.iperm]


def ntt_bwd(x: torch.Tensor, t: NTT3NTables, q, qinv, bhi) -> torch.Tensor:
    """The exact inverse of ``ntt_fwd``."""
    half = t.n // 2
    qq, qi = q[:, None], qinv[:, None]
    both = x[..., t.perm]
    u = mm.mred(_idft_m(both[..., :half], t, q, qinv, bhi), t.untw1, qq, qi)
    w = mm.mred(_idft_m(both[..., half:], t, q, qinv, bhi), t.untw2, qq, qi)
    # CRT solve: hi = (u - w) / (z - z^5); lo = u - z hi
    hi = mm.mred(mm.cred(u + qq - w, qq), t.inv_diff[:, None], qq, qi)
    lo = mm.cred(u + qq - mm.mred(hi, t.z_pow[:, 0:1], qq, qi), qq)
    return torch.cat([lo, hi], dim=-1)

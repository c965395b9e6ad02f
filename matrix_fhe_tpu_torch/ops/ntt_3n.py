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
and live on the ring's device.  ``build_tables`` also builds the tables
the kernel reads (``kfwd``/``kbwd``/``kidx``): the kernel computes each
branch's DFT_M as a mixed-radix FFT, not as the matmuls here, from the
same omega (``kernel_layout``).
"""

from __future__ import annotations

import dataclasses
import functools
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
# kernel B5's [L, ...] tables (the JAX package has none)
KERNEL_FIELDS = ("kfwd", "kbwd")

# Kernel B5's tables (csrc/ntt3n.cu).  Each branch's DFT_M, M = 2^p 3^b, is
# a decimation-in-frequency FFT in place: p radix-2 stages, then b radix-3
# stages; the stage whose blocks are Ms words long (Ms = M / 2^s for the
# radix-2 stage s, 3^(b-k) for the radix-3 stage k) multiplies by powers of
# omega_Ms = omega^(6 M / Ms).  A limb's row holds (value, Shoup quotient)
# pairs of 64-bit words: KERNEL_HEADER pairs (q, the fold's z, the cube
# root of unity, the inverse's (z - z^5)^-1), the M twist pairs of each
# branch, then each stage's twiddles, the stage of block size Ms from pair
# KERNEL_HEADER + 3M - Ms on: omega_Ms^j for j < Ms/2 (radix 2), or
# omega_Ms^j, omega_Ms^2j for j < Ms/3 (radix 3).  3M + KERNEL_HEADER - 1
# pairs in all.
KERNEL_HEADER = 4


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
    # kernel B5 (``kernel_layout``): [L, 2 W] words, W the pairs of a row;
    # built by ``kernel_tables`` (``build_tables`` and ``carry`` call it)
    kfwd: torch.Tensor  # forward: z, omega_3, twists omega^+-j, omega_Ms^j
    kbwd: torch.Tensor  # inverse: z, omega_3^-1, (z - z^5)^-1,
                        #   untwists M^-1 omega^-+j, omega_Ms^-j
    kidx: torch.Tensor  # int32 [N] (branch, FFT position) -> E-sorted position

    def limbs(self, s: slice) -> "NTT3NTables":
        """The tables of the limbs in ``s`` (views, contiguous for a step-1 slice)."""
        return dataclasses.replace(self, **{f: getattr(self, f)[s]
                                            for f in LIMB_FIELDS + KERNEL_FIELDS})


@functools.lru_cache(maxsize=None)
def radix_counts(m: int) -> tuple[int, int]:
    """(p, b) with M = 2^p 3^b; ValueError for any other M."""
    p = b = 0
    while m % 2 == 0:
        m, p = m // 2, p + 1
    while m % 3 == 0:
        m, b = m // 3, b + 1
    if m != 1:
        raise ValueError("M is not of the form 2^p 3^b")
    return p, b


def kernel_layout(n: int) -> dict:
    """The kernel's FFT of each branch at degree N: M, (p, b), the block
    size of each stage in order (the radix-2 stages, then the radix-3
    ones), and the pairs of a limb's table row."""
    m = n // 2
    p, b = radix_counts(m)
    blocks = [m >> s for s in range(p)] + [3 ** (b - k) for k in range(b)]
    return {"m": m, "p": p, "b": b, "blocks": blocks, "pairs": 3 * m + KERNEL_HEADER - 1}


def stage_pair(m: int, ms: int) -> int:
    """First pair of the twiddles of the stage whose blocks are ``ms`` words."""
    return KERNEL_HEADER + 3 * m - ms


def fft_order(m: int) -> list[int]:
    """The DFT index X[k] that the in-place FFT leaves at each position:
    position sum_i d_i M / (r_1 .. r_i) holds k = d_1 + r_1 d_2 + r_1 r_2 d_3
    + .. (a mixed-radix digit reversal, radices r_i = 2, .., 2, 3, .., 3)."""
    p, b = radix_counts(m)
    k, rem, block, weight = [0] * m, list(range(m)), m, 1
    for r in [2] * p + [3] * b:
        block //= r
        for i in range(m):
            d, rem[i] = divmod(rem[i], block)
            k[i] += d * weight
        weight *= r
    return k


def _kernel_rows(m: int, q: int, omega: int, z: int) -> tuple[list[int], list[int]]:
    """One limb's forward and inverse rows of kernel B5 (``kernel_layout``)."""
    p, b = radix_counts(m)
    w_m = pow(omega, 6, q)
    pw = _powers(w_m, m, q)                       # omega_M^e
    pwi = [pw[-e % m] for e in range(m)]          # omega_M^-e
    oinv = pow(omega, q - 2, q)
    minv = pow(m, q - 2, q)
    twist, itwist = _powers(omega, m, q), _powers(oinv, m, q)
    w3 = pw[m // 3] if b else 0
    fwd = [q, z, w3, 0] + twist + itwist
    bwd = [q, z, pwi[m // 3] if b else 0, pow((z - pow(z, 5, q)) % q, q - 2, q)]
    bwd += [v * minv % q for v in itwist] + [v * minv % q for v in twist]
    for i, ms in enumerate(kernel_layout(2 * m)["blocks"]):
        step = m // ms
        if i < p:
            fwd += [pw[step * j] for j in range(ms // 2)]
            bwd += [pwi[step * j] for j in range(ms // 2)]
        else:
            for j in range(ms // 3):
                fwd += [pw[step * j], pw[2 * step * j]]
                bwd += [pwi[step * j], pwi[2 * step * j]]

    def pairs(vals):
        out = []
        for v in vals:
            out += [v, (v << 64) // q if v < q else 0]
        return out

    return pairs(fwd), pairs(bwd)


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
                       **{f: t(v) for f, v in cols.items()},
                       **kernel_tables(n, moduli, omegas, perm, device))


def kernel_tables(n: int, moduli, omegas, perm, device="cuda") -> dict:
    """Kernel B5's tables ``kfwd``, ``kbwd`` and ``kidx`` on ``device``,
    from the limbs' moduli and primitive 3N-th roots and the table ``perm``
    ((branch, slot) -> E-sorted position)."""
    device = resolve_device(device)
    m = n // 2
    kfwd, kbwd = [], []
    for q, omega in zip(moduli, omegas):
        q, omega = int(q), int(omega)
        kf, kb = _kernel_rows(m, q, omega, pow(omega, m, q))
        kfwd.append([mm.signed(v) for v in kf])
        kbwd.append([mm.signed(v) for v in kb])
    perm = [int(v) for v in perm]
    order = fft_order(m)
    kidx = [perm[k] for k in order] + [perm[m + k] for k in order]
    return {"kfwd": torch.tensor(kfwd, dtype=torch.int64, device=device),
            "kbwd": torch.tensor(kbwd, dtype=torch.int64, device=device),
            "kidx": torch.tensor(kidx, dtype=torch.int32, device=device)}


def modulus_and_root(tw1) -> tuple[int, int]:
    """(q, omega) of a limb from its twist row ``tw1`` (u64 words
    MForm(omega^i) = omega^i 2^64 mod q, i < M, M >= 4): q divides 2^64 -
    MForm(1) and each MForm(omega^i) MForm(omega^j) - MForm(omega^(i+j))
    MForm(1); ValueError if their gcd is not a modulus that omega is a
    primitive 3N-th root of (N = 2M)."""
    w = [int(v) for v in tw1]
    m = len(w)
    q = (1 << 64) - w[0]
    for i in range(1, min(m, 8)):
        for j in range(i, min(m, 8) - i):
            q = math.gcd(q, w[i] * w[j] - w[i + j] * w[0])
    omega = w[1] * pow(1 << 64, -1, q) % q if q > max(w) else 0
    if m < 4 or not omega or pow(omega, 6 * m, q) != 1 or pow(omega, 3 * m, q) == 1 \
            or [_mont(v, q) for v in _powers(omega, m, q)] != w:
        raise ValueError("the twist row is not MForm(omega^i) of a modulus q < 2^64")
    return q, omega


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

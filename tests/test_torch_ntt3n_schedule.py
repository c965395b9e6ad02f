"""PyTorch port, kernel B5's pass schedule and B4's fused CI fold, on the CPU.

``csrc/ntt3n.cu`` and ``csrc/ntt64.cu`` cannot run here, so this file holds
numpy models of what they compute, in their lazy 64-bit arithmetic (words
wrap mod 2^64, products are Shoup products, values stay in [0, 2q) or
[0, 4q) between passes and are reduced once at the store; the models
assert those ranges):

* B5 (the 3N ring's NTT): the fold by z and the twist on load, each
  branch's DFT_M as an in-place decimation-in-frequency FFT (the radix-2
  stages, then the radix-3 ones) on the tables ``ntt_3n.build_tables`` hands
  the kernel, the row split over a cluster of C CTAs (the first log2 C
  stages as one pass across the cluster, a loop over ranks here, then each
  CTA's local passes of up to 3 radix-2 stages, shorter first, and one
  radix-3 stage a pass), and the store through the composed index
  ``kidx``; the inverse runs the mirror (the gather through ``kidx``, the
  local passes last first, the cross pass, the untwist and the CRT solve in
  registers).  Held bit-exact against the plain ``ntt_3n.ntt_fwd`` /
  ``ntt_bwd`` at N = 48 to 27648 and every cluster size the kernel takes.
* B4 on the CI ring: the fold x[j] - F x[N - j] on load (forward) and
  (2N)^-1 (y[j] - F y[N - j]) on store (inverse), each thread taking the
  pair of bases b and NL - b of the radix-C pass across the cluster (or the
  pair of words j and N - j without one), so both words of a fold lie in
  its registers; the butterfly stages between are the standard ones.  Held
  against ``rings._ntt_ci`` / ``_intt_ci`` at N = 16 to 2^14.
"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda, ntt_3n, rings
from matrix_fhe_tpu_torch.utils import primes as pr

U = np.uint64
M32 = U(0xFFFFFFFF)


# -- 64-bit words ------------------------------------------------------------------

def mulhi(a, b):
    """High 64 bits of the 128-bit product of uint64 arrays (``__umul64hi``)."""
    a, b = np.asarray(a, U), np.asarray(b, U)
    al, ah, bl, bh = a & M32, a >> U(32), b & M32, b >> U(32)
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> U(32)) + (lh & M32) + (hl & M32)
    return hh + (lh >> U(32)) + (hl >> U(32)) + (mid >> U(32))


def shoup(x, w, ws, q):
    """w x mod q in [0, 2q) for any 64-bit x (the kernels' ``shoup_mul``)."""
    return np.asarray(w, U) * np.asarray(x, U) - mulhi(ws, x) * q


def csub(x, m):
    return np.minimum(x, x - m)


def below(x, bound, what):
    assert (np.asarray(x, U) < bound).all(), f"{what}: a word left its lazy range"
    return x


# -- B5 ------------------------------------------------------------------------------

def local_passes(n2: int) -> list[int]:
    """Stages of each local radix-2 pass of a CTA's n2 radix-2 stages:
    ceil(n2 / 3) passes of at most 3, as even as possible, the shorter first
    (csrc/ntt3n.cu:pass_len, B4's rule)."""
    if n2 == 0:
        return []
    count = (n2 + 2) // 3
    longer_from = (count - n2 % count) * (n2 // count)
    out, s0 = [], 0
    while s0 < n2:
        out.append(n2 // count + (s0 >= longer_from))
        s0 += out[-1]
    return out


class Row:
    """One limb's kernel row: (value, quotient) pairs, as the kernel reads it."""

    def __init__(self, words, m):
        pairs = np.asarray(words).view(U).reshape(-1, 2)
        self.w, self.ws, self.m = pairs[:, 0], pairs[:, 1], m
        self.q = self.w[0]

    def pair(self, i):
        return self.w[i], self.ws[i]

    def stage(self, ms, idx):
        """The twiddle pairs at ``idx`` of the stage whose blocks are ms words."""
        base = ntt_3n.stage_pair(self.m, ms)
        return self.w[base + idx], self.ws[base + idx]


def dif2(x, row, ms, jj, S):
    """R = log2(len(x)) radix-2 DIF stages (Gentleman-Sande) on the group
    x[k] = word base + k S, the first of block size ms: sub-stage d pairs k
    with k + 2^(R-1-d) (that bit of k clear) under omega_(ms/2^d)^(jj + S u),
    u = k mod 2^(R-1-d)."""
    q = row.q
    R = len(x).bit_length() - 1
    for d in range(R):
        half = 1 << (R - 1 - d)
        for k in range(len(x)):
            if k & half:
                continue
            w, ws = row.stage(ms >> d, jj + S * (k & (half - 1)))
            u, v = x[k], x[k + half]
            x[k] = csub(u + v, 2 * q)
            x[k + half] = shoup(u + 2 * q - v, w, ws, q)
    return x


def dit2(x, row, ms, jj, S):
    """The inverse of ``dif2`` up to the factor 2^R: the same pairs, last
    sub-stage first, Cooley-Tukey under the inverse twiddles; [0, 4q)."""
    q = row.q
    R = len(x).bit_length() - 1
    for d in range(R - 1, -1, -1):
        half = 1 << (R - 1 - d)
        for k in range(len(x)):
            if k & half:
                continue
            w, ws = row.stage(ms >> d, jj + S * (k & (half - 1)))
            a = csub(x[k], 2 * q)
            b = shoup(x[k + half], w, ws, q)
            x[k], x[k + half] = a + b, a + 2 * q - b
    return x


def dif3(a, b, c, row, ms, jj):
    """A radix-3 DIF butterfly and its two twiddles: 3 products."""
    q = row.q
    w3, w3s = row.pair(2)
    w1, w1s = row.stage(ms, 2 * jj)
    w2, w2s = row.stage(ms, 2 * jj + 1)
    y0 = csub(csub(a + b + c, 4 * q), 2 * q)
    t = shoup(b + 2 * q - c, w3, w3s, q)
    return (y0, shoup(a + 2 * q - c + t, w1, w1s, q), shoup(a + 4 * q - b - t, w2, w2s, q))


def dit3(y0, y1, y2, row, ms, jj):
    """The inverse of ``dif3`` times 3 (its twiddles and the cube root inverted)."""
    q = row.q
    w3, w3s = row.pair(2)
    w1, w1s = row.stage(ms, 2 * jj)
    w2, w2s = row.stage(ms, 2 * jj + 1)
    a1, a2 = shoup(y1, w1, w1s, q), shoup(y2, w2, w2s, q)
    a0 = csub(y0, 2 * q)
    t = shoup(a1 + 2 * q - a2, w3, w3s, q)
    return (csub(a0 + a1 + a2, 4 * q), csub(a0 + 2 * q - a2 + t, 4 * q),
            csub(a0 + 4 * q - a1 - t, 4 * q))


def fold_twist(lo, hi, row, j):
    """Forward load: (lo + z hi) omega^j and (lo + z^5 hi) omega^-j, with
    z^5 = 1 - z (z a primitive 6th root): 3 products."""
    q, m = row.q, row.m
    z, zs = row.pair(1)
    t = shoup(hi, z, zs, q)
    w0, w0s = row.pair(ntt_3n.KERNEL_HEADER + j)
    w1, w1s = row.pair(ntt_3n.KERNEL_HEADER + m + j)
    return shoup(lo + t, w0, w0s, q), shoup(lo + hi + 2 * q - t, w1, w1s, q)


def untwist_crt(a0, a1, row, j):
    """Inverse store: u = M^-1 omega^-j a0, w = M^-1 omega^j a1, then
    hi = (u - w) / (z - z^5), lo = u - z hi, both canonical."""
    q, m = row.q, row.m
    z, zs = row.pair(1)
    d, ds = row.pair(3)
    u = shoup(a0, *row.pair(ntt_3n.KERNEL_HEADER + j), q)
    w = shoup(a1, *row.pair(ntt_3n.KERNEL_HEADER + m + j), q)
    hi = csub(shoup(u + 2 * q - w, d, ds, q), q)
    lo = csub(csub(u + 2 * q - shoup(hi, z, zs, q), 2 * q), q)
    return lo, hi


def local_schedule(row, p, b, c, Q):
    """(radix, first stage's block size, stride, groups a branch) of each
    local pass of a CTA holding Q words a branch, forward order."""
    out, s = [], c
    for r in local_passes(p - c):
        ms = row.m >> s
        out.append((1 << r, ms, ms >> r, Q >> r))
        s += r
    for k in range(b):
        ms = 3 ** (b - k)
        out.append((3, ms, ms // 3, Q // 3))
    return out


def groups(radix, ms, S, G):
    """(branch-local base, jj) of each group of a pass: group g is in
    block g // S, at jj = g mod S; its words are base + t S."""
    g = np.arange(G)
    blk, jj = g // S, g % S
    return blk * (S * radix) + jj, jj


def b5_forward(x, t, cluster):
    """The kernel's forward on one [L, N] input (row r on limb r)."""
    n = t.n
    lay = ntt_3n.kernel_layout(n)
    m, p, b = lay["m"], lay["p"], lay["b"]
    c = cluster.bit_length() - 1
    Q = m // cluster
    out = np.zeros_like(x)
    kidx = t.kidx.numpy()
    for r in range(x.shape[0]):
        row = Row(t.kfwd[r].numpy(), m)
        q = row.q
        src = x[r]
        buf = np.zeros((cluster, 2, Q), U)          # each CTA's two branches
        if cluster == 1:
            j = np.arange(m)
            buf[0, 0], buf[0, 1] = fold_twist(src[j], src[m + j], row, j)
        else:                                       # the cross pass, rank by rank
            for rank in range(cluster):
                jj = np.arange(rank * Q // cluster, (rank + 1) * Q // cluster)
                x0, x1 = [], []
                for tt in range(cluster):
                    j = jj + Q * tt
                    a0, a1 = fold_twist(src[j], src[m + j], row, j)
                    x0.append(a0)
                    x1.append(a1)
                for br, xs in enumerate((x0, x1)):
                    for k, v in enumerate(dif2(xs, row, m, jj, Q)):
                        buf[k, br, jj] = below(v, 2 * q, "cross")
        for rank in range(cluster):
            for radix, ms, S, G in local_schedule(row, p, b, c, Q):
                base, jj = groups(radix, ms, S, G)
                for br in range(2):
                    a = buf[rank, br]
                    xs = [a[base + k * S] for k in range(radix)]
                    ys = dif3(*xs, row, ms, jj) if radix == 3 else dif2(xs, row, ms, jj, S)
                    for k, v in enumerate(ys):
                        a[base + k * S] = below(v, 2 * q, f"radix-{radix} pass")
            for br in range(2):
                dst = kidx[br * m + rank * Q + np.arange(Q)]
                out[r, dst] = csub(buf[rank, br], q)
    return out


def b5_inverse(x, t, cluster):
    """The kernel's inverse on one [L, N] input."""
    n = t.n
    lay = ntt_3n.kernel_layout(n)
    m, p, b = lay["m"], lay["p"], lay["b"]
    c = cluster.bit_length() - 1
    Q = m // cluster
    out = np.zeros_like(x)
    kidx = t.kidx.numpy()
    for r in range(x.shape[0]):
        row = Row(t.kbwd[r].numpy(), m)
        q = row.q
        buf = np.zeros((cluster, 2, Q), U)
        for rank in range(cluster):
            for br in range(2):
                a = buf[rank, br]
                a[:] = x[r, kidx[br * m + rank * Q + np.arange(Q)]]
                for radix, ms, S, G in reversed(local_schedule(row, p, b, c, Q)):
                    base, jj = groups(radix, ms, S, G)
                    xs = [a[base + k * S] for k in range(radix)]
                    ys = dit3(*xs, row, ms, jj) if radix == 3 else dit2(xs, row, ms, jj, S)
                    for k, v in enumerate(ys):
                        a[base + k * S] = below(v, 4 * q, f"inverse radix-{radix} pass")
        if cluster == 1:
            j = np.arange(m)
            out[r, j], out[r, m + j] = untwist_crt(buf[0, 0], buf[0, 1], row, j)
            continue
        for rank in range(cluster):                 # the cross pass, then the CRT
            jj = np.arange(rank * Q // cluster, (rank + 1) * Q // cluster)
            ys = [dit2([buf[k, br, jj] for k in range(cluster)], row, m, jj, Q)
                  for br in range(2)]
            for tt in range(cluster):
                j = jj + Q * tt
                below(ys[0][tt], 4 * q, "inverse cross")
                out[r, j], out[r, m + j] = untwist_crt(ys[0][tt], ys[1][tt], row, j)
    return out


def _ring3n(n, bits=(45, 55, 60)):
    moduli = [pr.find_3n_rns_primes(n, b, 1)[0] for b in bits]
    return rings.new_ring(n, moduli, rings.MATRIX, device="cpu")


def _words(moduli, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, lead + (n,), dtype=np.int64) for q in moduli], axis=-2)
    x.reshape(-1, n)[0, :3] = [moduli[0] - 1, 0, 1]
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [48, 96, 1152, 1536, 12288, 27648])
def test_b5_schedule_matches_plain(n):
    # the plain transform's matmuls take seconds at the largest N on the
    # CPU: there one 60-bit prime, the one nearest the lazy ranges' limit
    ring = _ring3n(n, bits=(45, 55, 60) if n < 12288 else (60,))
    t = ring.ntt3n
    x = _words(ring.moduli_tuple, n, n)
    want_f = ntt3n_cuda.ntt_fwd_plain(x, ring)
    want_b = ntt3n_cuda.ntt_bwd_plain(x, ring)
    p = ntt_3n.kernel_layout(n)["p"]
    xs = x.numpy().view(U)
    for cluster in (1, 2, 4, 8):
        if cluster > 1 << p:
            continue
        got_f = b5_forward(xs, t, cluster).view(np.int64)
        np.testing.assert_array_equal(got_f, want_f.numpy(), err_msg=f"forward, C={cluster}")
        got_b = b5_inverse(xs, t, cluster).view(np.int64)
        np.testing.assert_array_equal(got_b, want_b.numpy(), err_msg=f"inverse, C={cluster}")


@pytest.mark.parametrize("n", [8, 12, 18, 54, 64, 162])
def test_b5_schedule_edge_radices(n):
    """No radix-3 stage (N = 8, 64), no radix-2 stage (M = 9, 27, 81), and
    the smallest split: the same model against the plain transform."""
    ring = _ring3n(n, bits=(40, 50))
    x = _words(ring.moduli_tuple, n, 7)
    xs = x.numpy().view(U)
    p = ntt_3n.kernel_layout(n)["p"]
    for cluster in (1, 2, 4, 8):
        if cluster > 1 << p:
            continue
        np.testing.assert_array_equal(b5_forward(xs, ring.ntt3n, cluster).view(np.int64),
                                      ntt3n_cuda.ntt_fwd_plain(x, ring).numpy())
        np.testing.assert_array_equal(b5_inverse(xs, ring.ntt3n, cluster).view(np.int64),
                                      ntt3n_cuda.ntt_bwd_plain(x, ring).numpy())


def test_b5_tables_and_layout():
    """The row layout: header, twists, each stage's twiddles at
    ``stage_pair``, the Shoup quotients, and the composed index."""
    n = 96
    ring = _ring3n(n, bits=(50,))
    t = ring.ntt3n
    lay = ntt_3n.kernel_layout(n)
    m = lay["m"]
    assert (lay["p"], lay["b"], lay["blocks"]) == (4, 1, [48, 24, 12, 6, 3])
    assert t.kfwd.shape == t.kbwd.shape == (1, 2 * lay["pairs"])
    row = Row(t.kfwd[0].numpy(), m)
    q = int(row.q)
    assert [int(v) for v in row.ws[1:]] == [(int(w) << 64) // q for w in row.w[1:]]
    omega = ring.ntt3n and rings._gen_3n_tables(ring.nth_root, q)["omega"]
    w_m = pow(omega, 6, q)
    assert int(row.w[1]) == pow(omega, m, q)
    assert int(row.w[ntt_3n.KERNEL_HEADER + 5]) == pow(omega, 5, q)
    assert int(row.w[ntt_3n.KERNEL_HEADER + m + 5]) == pow(omega, -5, q)
    assert int(row.stage(24, 7)[0]) == pow(w_m, 2 * 7, q)
    assert int(row.stage(3, 1)[0]) == 1
    assert ntt_3n.stage_pair(m, 3) + 2 == lay["pairs"]
    inv = Row(t.kbwd[0].numpy(), m)
    assert int(inv.w[ntt_3n.KERNEL_HEADER + 5]) == pow(omega, -5, q) * pow(m, -1, q) % q
    assert sorted(t.kidx.tolist()) == list(range(n))
    assert t.kidx.dtype == torch.int32
    order = ntt_3n.fft_order(m)
    assert t.kidx[:m].tolist() == [t.perm[k].item() for k in order]


def test_local_passes():
    assert local_passes(0) == []
    assert local_passes(8) == [2, 3, 3]
    assert local_passes(11) == [2, 3, 3, 3]
    assert local_passes(4) == [2, 2]
    assert [sum(local_passes(k)) for k in range(16)] == list(range(16))
    assert max(max(local_passes(k), default=1) for k in range(16)) == 3


# -- B4's fused CI fold ------------------------------------------------------------------

def _pairs(n, C, rank):
    """The (j, partner) index arrays a CTA of rank ``rank`` folds: without a
    cluster, words j <= N/2 and their partners N - j; with one, the bases
    b of its share of [0, NL/2] (the last rank also NL/2) and NL - b."""
    if C == 1:
        j = np.arange(n // 2 + 1)
        return j, (n - j) % n
    nl = n // C
    per = nl // (2 * C)
    b = np.arange(rank * per, (rank + 1) * per + (rank == C - 1))
    return b, (nl - b) % nl


def _fold_words(n, C, rank):
    """(word, partner word) index arrays of every fold a CTA computes, as
    the kernel finds them: without a cluster, words j and N - j of a pair
    (j >= 1) and the other way round; with one, word b + k NL of base b
    and word (NL - b) + (C - 1 - k) NL of its partner base (the other way
    round unless b = NL - b), or, for b = 0, word (C - k) NL (k >= 1)."""
    j, j2 = _pairs(n, C, rank)
    if C == 1:
        one = j >= 1
        two = one & (j2 != j)
        return np.concatenate([j[one], j2[two]]), np.concatenate([j2[one], j[two]])
    nl = n // C
    words, partners = [], []
    for k in range(C):
        rest = j != 0
        pair = rest & (j2 != j)
        words += [j[rest] + k * nl, j2[pair] + k * nl]
        partners += [j2[rest] + (C - 1 - k) * nl, j[pair] + (C - 1 - k) * nl]
        if k and (j == 0).any():
            words.append(np.array([k * nl]))
            partners.append(np.array([(C - k) * nl]))
    return np.concatenate(words), np.concatenate(partners)


def ci_fold_load(x, row_f, q, C):
    """The forward kernel's load: y[j] = x[j] - F x[N - j] (j >= 1), y[0] =
    x[0], in (0, 3q), computed where the words are read (``_fold_words``).
    Returns y in natural order; asserts each word is folded once."""
    n = x.shape[-1]
    F, Fs = row_f
    y = np.zeros_like(x)
    seen = np.zeros(n, int)
    for rank in range(C):
        w, pw = _fold_words(n, C, rank)
        y[w] = x[w] + 2 * q - shoup(x[pw], F, Fs, q)
        seen[w] += 1
    y[0] = x[0]
    seen[0] += 1
    assert (seen == 1).all()
    return below(y, 4 * q, "CI load")


def ci_fold_store(y, row_b, scale, q, C):
    """The inverse kernel's store: out[j] = (2N)^-1 (y[j] - F y[N - j]),
    out[0] = (2N)^-1 2 y[0], canonical, from the stages' outputs in
    [0, 2q), paired as on load."""
    n = y.shape[-1]
    F, Fs = row_b
    s, ss = scale
    below(y, 2 * q, "CI inverse stages")
    out = np.zeros_like(y)
    for rank in range(C):
        w, pw = _fold_words(n, C, rank)
        out[w] = csub(shoup(y[w] + 2 * q - shoup(y[pw], F, Fs, q), s, ss, q), q)
    out[0] = csub(shoup(y[0:1] + y[0:1], s, ss, q), q)[0]
    return out


def _ci_ring(n):
    moduli = pr.NTTFriendlyPrimesGenerator(55, 4 * n).next_alternating_primes(2)
    return rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device="cpu")


@pytest.mark.parametrize("logn", [4, 6, 10, 12, 14])
def test_ci_fused_fold_matches_ci_transform(logn):
    """The fused fold, then the standard stages (forward), or the stages,
    then the fused fold (inverse), equal the CI transform, at every
    cluster size B4 has at this N (C > 1 from N = 2^10 on)."""
    n = 1 << logn
    ring = _ci_ring(n)
    x = _words(ring.moduli_tuple, n, logn, (2,))
    want_f, want_b = rings._ntt_ci(x, ring), rings._intt_ci(x, ring)
    fold = ring.fold_row.numpy().view(U)
    # B4's inverse stages on the CI table, unscaled (its scale is 1 here)
    stages_b = rings._gs_stages(x, ring.roots_bwd, ring.moduli, ring.qinv, 1)
    for C in ntt64_cuda.clusters(n):
        folded = np.zeros(x.shape, U)
        got_b = np.zeros(x.shape, U)
        for i in range(2):
            for limb, q in enumerate(ring.moduli_tuple):
                q, f = U(q), fold[limb]
                folded[i, limb] = ci_fold_load(x[i, limb].numpy().view(U), (f[0], f[1]), q, C)
                got_b[i, limb] = ci_fold_store(stages_b[i, limb].numpy().view(U),
                                               (f[2], f[3]), (f[4], f[5]), q, C)
        # the stages take a lazy input in [0, 4q); the plain stages take
        # canonical words, so reduce here (the kernel does not need to)
        qq = ring.moduli.numpy().view(U)[:, None]
        canon = torch.from_numpy(csub(csub(folded, 2 * qq), qq).view(np.int64))
        got_f = rings._ct_stages(canon, ring.roots_fwd, ring.moduli, ring.qinv, 1)
        assert torch.equal(got_f, want_f), f"CI forward, C={C}"
        assert torch.equal(torch.from_numpy(got_b.view(np.int64)), want_b), f"CI inverse, C={C}"


def test_ci_fold_row():
    """The ring's fold row: F = psi^N and psi^-N (roots_fwd[:, 1] and
    roots_bwd[:, 1] out of Montgomery form) and (2N)^-1, with quotients."""
    n = 64
    ring = _ci_ring(n)
    q = ring.moduli[:, None]
    f = ring.fold_row
    assert f.shape == (2, 6)
    assert torch.equal(f[:, 0:1], rings.mm.imform(ring.roots_fwd[:, 1:2], q, ring.qinv[:, None]))
    assert torch.equal(f[:, 2:3], rings.mm.imform(ring.roots_bwd[:, 1:2], q, ring.qinv[:, None]))
    for limb, qq in enumerate(ring.moduli_tuple):
        vals = [int(v) for v in f[limb].numpy().view(U)]
        assert vals[4] == pow(2 * n, -1, qq)
        assert vals[1::2] == [(v << 64) // qq for v in vals[0::2]]
    assert torch.equal(ring.limbs(1, 2).fold_row, f[1:2])

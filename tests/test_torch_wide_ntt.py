"""PyTorch port, the NTT of 64-bit words (kernel B4's plain version and its
schedule), on the CPU.

* The plain u64 NTT (``ntt64_cuda.ntt_fwd_plain``/``ntt_bwd_plain``, the
  torch-op transform of ``ops/rings.py``) equals ``wide.unpack_pair`` of the
  JAX package's wide NTT (``ops/wide_ntt.py``, digit-plane matmuls) on the
  same primes: tests/test_wide_ntt.py's shapes and the NTT cases of
  tests/test_wide61.py (60/61/56-bit primes, pair31), batched, and at the
  extreme values.  ``Ring.ntt``/``intt`` on a CPU tensor is that version.
* ``csrc/ntt64.cu`` cannot run here: its geometry rule
  (``ntt64_cuda.geometry``) and a numpy model of its schedule, with its
  lazy 64-bit Shoup arithmetic, are held here: the radix-C pass across the
  cluster (rank r's bases, thread t's b = r N/C^2 + t + i T), then the
  local radix-2^R passes (R <= 3, shorter first; group t + i T of thread
  t), the inverse the mirror with N^-1 where stage 0 is; every group's
  words and twiddle indices, read from the ring's paired table (each
  twiddle beside its Shoup quotient).  The model asserts the lazy ranges
  ([0, 4q) forward, [0, 2q) inverse, [0, 2q) a product), that every thread
  and rank split covers each word once, and equals the plain version at
  logN 4-16 and every cluster size the kernel is built for (C = 1, 2, 4, 8,
  16 with N / C <= 2^14).  Beside it: the pass schedule, the threads, the
  twiddles a thread holds ahead of a pass, the shared-memory padding's bank
  conflicts and size, all read from the kernel source's one-line
  ``constexpr`` functions.
"""

import functools
import re

import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import wide as jwide
from matrix_fhe_tpu.ops import wide_ntt
from matrix_fhe_tpu_torch.ops import ntt64_cuda, rings
from matrix_fhe_tpu_torch.ops import wide as pwide
from matrix_fhe_tpu_torch.utils import primes as pr

H100_SMS = 132
U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def _moduli(n, bits, count):
    return pr.NTTFriendlyPrimesGenerator(bits, 2 * n).next_alternating_primes(count)


def _port_ntt(x, moduli, fwd=True):
    n = x.shape[-1]
    ring = rings.new_ring(n, moduli, device="cpu")
    t = torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.int64))
    out = ring.ntt(t) if fwd else ring.intt(t)
    assert torch.equal(out, (ntt64_cuda.ntt_fwd_plain if fwd else ntt64_cuda.ntt_bwd_plain)(t, ring))
    return out.numpy().astype(np.uint64)


def _jax_ntt(x, moduli, fwd=True):
    tabs = wide_ntt.build_tables(x.shape[-1], moduli)
    f = wide_ntt.ntt_fwd if fwd else wide_ntt.ntt_bwd
    return jwide.unpack_pair(np.asarray(f(jwide.pack_pair(x, moduli), tabs)), moduli)


def _draw(n, moduli, seed, lead=()):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64) for q in moduli], axis=-2)


@pytest.mark.parametrize("n, bits", [(64, 45), (256, 45), (256, 55), (256, 60), (256, 61),
                                     (1024, 56)])
def test_plain_ntt_matches_wide_ntt(n, bits):
    """tests/test_wide_ntt.py's (64, 45), (256, 45), (256, 55) and
    tests/test_wide61.py's (256, 60), (256, 61), (1024, 56) with a 45-bit limb."""
    moduli = _moduli(n, bits, 3 if bits < 56 else 2)
    if bits >= 56:
        moduli.append(_moduli(n, 45, 1)[0])
    x = _draw(n, moduli, 0)
    f = _port_ntt(x, moduli)
    np.testing.assert_array_equal(f, _jax_ntt(x, moduli))
    b = _port_ntt(f, moduli, fwd=False)
    np.testing.assert_array_equal(b, _jax_ntt(f, moduli, fwd=False))
    np.testing.assert_array_equal(b, x)


def test_plain_ntt_batched():
    n = 256
    moduli = _moduli(n, 45, 2)
    x = _draw(n, moduli, 1, lead=(4,))                   # [B, L, N]
    np.testing.assert_array_equal(_port_ntt(x, moduli), _jax_ntt(x, moduli))


@pytest.mark.parametrize("moduli", [[0x2000000A0001, 0x80000000080001],
                                    [pr.NTTFriendlyPrimesGenerator(61, 512).next_alternating_prime(),
                                     pr.NTTFriendlyPrimesGenerator(60, 512).next_alternating_prime()]])
def test_plain_ntt_extreme_values(moduli):
    """All coefficients at q-1 and q/2 (the worst-case digits of the pairs)."""
    n = 256
    x = np.stack([np.full(n, q - 1, dtype=np.uint64) for q in moduli])
    x[:, ::2] = np.array([q // 2 for q in moduli], dtype=np.uint64)[:, None]
    np.testing.assert_array_equal(_port_ntt(x, moduli), _jax_ntt(x, moduli))


def test_wrappers_check_their_input():
    ring = rings.new_ring(64, _moduli(64, 45, 2), device="cpu")
    with pytest.raises(TypeError):
        ntt64_cuda.ntt_fwd(torch.zeros(2, 64, dtype=torch.int32), ring)
    with pytest.raises(ValueError):
        ntt64_cuda.ntt_bwd(torch.zeros(3, 64, dtype=torch.int64), ring)
    with pytest.raises(ValueError):
        ntt64_cuda.ntt_fwd(torch.zeros(2, 32, dtype=torch.int64), ring)
    with pytest.raises(ValueError, match="2\\^61"):
        pwide.check_moduli([(1 << 61) + (1 << 55)])


# -- geometry ------------------------------------------------------------------

@pytest.mark.parametrize("rows, logn, c", [
    (7, 14, 8), (9, 14, 8), (4 * 9, 14, 8), (2 * 9, 14, 8),   # the wide step at logN 14
    (21, 14, 8), (1, 14, 8), (17, 14, 8), (42, 14, 8),        # bootstrap-sized launches
    (49, 14, 8), (50, 14, 4), (153, 14, 4),                   # keygen-sized launches
    (1, 6, 1), (300, 10, 1), (6, 13, 8), (300, 13, 2), (100, 13, 2),
    (1, 15, 16), (4, 15, 16), (5, 15, 16), (640, 15, 8), (1, 16, 16), (640, 16, 8),
    (7, 15, 16), (8, 15, 8), (5, 16, 16), (7, 16, 16), (8, 16, 8)])
def test_geometry(rows, logn, c):
    """The rule the sweep measured (``ntt64_cuda.geometry``'s docstring)."""
    assert ntt64_cuda.geometry(rows, 1 << logn, H100_SMS) == c


def test_geometry_floor_and_refusal():
    # on a card of few SMs the smallest cluster still holds N / 2^14 words a CTA
    assert ntt64_cuda.geometry(1000, 1 << 13, 12) == 2
    assert ntt64_cuda.geometry(1000, 1 << 14, 12) == 4
    assert ntt64_cuda.geometry(1000, 1 << 16, 12) == 8
    for logn in range(4, 17):
        for rows in (1, 5, 49, 50, 1000):
            c = ntt64_cuda.geometry(rows, 1 << logn, H100_SMS)
            assert c in ntt64_cuda.clusters(1 << logn), (rows, logn, c)
    with pytest.raises(NotImplementedError):
        ntt64_cuda.geometry(1, 1 << 17, H100_SMS)


# -- the kernel's schedule, modelled ------------------------------------------------

def _kernel_constexpr(*names):
    """csrc/ntt64.cu's one-line ``constexpr`` functions ``names``, evaluated
    as Python (integer ``/`` is ``//``)."""
    src = ntt64_cuda.SOURCE.read_text()
    env = {}
    for name in names:
        m = re.search(r"constexpr \w+ " + name + r"\(([^)]*)\) \{\s*return ([^;?]*);\s*\}", src)
        assert m, f"{name} not found as a one-line constexpr in {ntt64_cuda.SOURCE}"
        args = ", ".join(a.split()[-1] for a in m.group(1).split(","))
        exec(f"def {name}({args}): return {m.group(2).replace('/', '//')}", env)
    return [env[name] for name in names]


_pass_from, _pass_to, _phys, _threads, _iters, _held = _kernel_constexpr(
    "pass_count", "longer_from", "pass_from", "pass_to", "phys", "threads_for", "iters_for",
    "held")[2:]
SMEM_PER_CTA = 232448   # bytes of shared memory a CTA may use on the H100


def _passes(lognl):
    out, s0 = [], 0
    while s0 < lognl:
        out.append(_pass_from(lognl, s0))
        s0 += out[-1]
    return out


def _passes_bwd(lognl):
    out, end = [], lognl
    while end > 0:
        out.append(_pass_to(lognl, end))
        end -= out[-1]
    return out


def _mul64_hi(a, b):
    """High 64 bits of a * b for uint64 arrays (32-bit halves, as
    ``__umul64hi``)."""
    a0, a1, b0, b1 = a & M32, a >> U64(32), b & M32, b >> U64(32)
    lo_lo, hi_lo, lo_hi = a0 * b0, a1 * b0, a0 * b1
    cross = (lo_lo >> U64(32)) + (hi_lo & M32) + lo_hi
    return a1 * b1 + (hi_lo >> U64(32)) + (cross >> U64(32))


class _Row64:
    """Rows [B, N] of uint64 words with their limb's B4 tables, read from
    the ring's [L, N, 2] pairs as the kernel reads them: pair j is
    (w_j, floor(w_j 2^64 / q))."""

    def __init__(self, x, ring, fwd):
        rows = x.reshape(-1, ring.n)
        limb = np.arange(rows.shape[0]) % ring.num_limbs
        pairs = (ring.psi2 if fwd else ring.ipsi2).numpy().view(np.uint64)[limb]
        self.a = rows.numpy().view(np.uint64).copy()
        self.q = ring.moduli.numpy().view(np.uint64)[limb][:, None]
        self.w, self.ws = pairs[..., 0], pairs[..., 1]
        self.ni = ring.ninv_plain.numpy().view(np.uint64)[limb][:, None]
        self.nis = ring.ninv_shoup.numpy().view(np.uint64)[limb][:, None]

    def shoup(self, x, w, ws):
        """w x - umul64hi(ws, x) q, wrapping at 2^64: [0, 2q)."""
        with np.errstate(over="ignore"):
            out = w * x - _mul64_hi(ws, x) * self.q
        assert (out < 2 * self.q).all()
        return out

    def csub(self, x, m):
        return np.where(x >= m, x - m, x)

    def radix(self, x, idx, r, fwd):
        """R stages on the words x[k] (k < 2^R) of each group: stage d pairs
        k and k + 2^(R-1-d) with the twiddle at table index idx(d, p),
        p = k >> (R - d); Cooley-Tukey in [0, 4q) forward, Gentleman-Sande in
        [0, 2q) inverse."""
        q2 = 2 * self.q
        top = 4 * self.q if fwd else q2
        with np.errstate(over="ignore"):
            for d in (range(r) if fwd else range(r - 1, -1, -1)):
                half = 1 << (r - 1 - d)
                for k in range(1 << r):
                    if k & half:
                        continue
                    i = idx(d, k >> (r - d))
                    w = np.take_along_axis(self.w, i, axis=1)
                    ws = np.take_along_axis(self.ws, i, axis=1)
                    u, v = x[k], x[k + half]
                    if fwd:
                        a_ = self.csub(u, q2)
                        b_ = self.shoup(v, w, ws)
                        x[k], x[k + half] = a_ + b_, a_ + q2 - b_
                    else:
                        x[k] = self.csub(u + v, q2)
                        x[k + half] = self.shoup(u + q2 - v, w, ws)
                    assert (x[k] < top).all() and (x[k + half] < top).all()
        return x


def _thread_groups(lognl, r):
    """The groups of a pass of r stages: thread t takes groups t + i T,
    i < iters_for (those below the group count); by iteration, then thread
    (16 in a row: a half-warp's)."""
    T, it, G = _threads(lognl), _iters(lognl, r), 1 << (lognl - r)
    gid = np.arange(T)[None, :] + T * np.arange(it)[:, None]
    assert (gid[:-1] < G).all() and it == -(-G // T) and T % 16 == 0
    gid = gid[gid < G]
    assert np.array_equal(np.sort(gid), np.arange(G)), "each group once"
    return gid


def _pass_words(lognl, s0, r):
    """Local words [G, 2^R] and twiddle group offsets hi [G] of the pass of
    stages s0 .. s0+r-1, in ``_thread_groups``' order."""
    a_ = lognl - s0 - r
    gid = _thread_groups(lognl, r)
    hi, lo = gid >> a_, gid & ((1 << a_) - 1)
    base = (hi << (a_ + r)) | lo
    local = base[:, None] + (np.arange(1 << r) << a_)[None]
    assert (_phys(local) == _phys(base)[:, None] + _phys(np.arange(1 << r) << a_)[None]).all()
    assert np.array_equal(np.sort(local.ravel()), np.arange(1 << lognl)), "each word once"
    return local, hi


def _local(row, logn, c, s0, r, fwd, scale):
    """One local pass of every CTA of every row's cluster."""
    lognl = logn - (c.bit_length() - 1)
    local, hi = _pass_words(lognl, s0, r)
    for rank in range(c):
        words = (rank << lognl) + local                          # [G, 2^R]
        g = ((c + rank) << s0) + hi                              # [G]
        idx = lambda d, p: np.broadcast_to(((g << d) + p)[k_of], shape)  # noqa: E731
        k_of = np.arange(words.shape[0])
        shape = (row.a.shape[0], words.shape[0])
        assert ((g << (r - 1)) + (1 << (r - 1)) - 1 < 1 << logn).all()
        x = row.radix([row.a[:, words[:, k]] for k in range(1 << r)], idx, r, fwd)
        if scale:
            x = [row.shoup(v, row.ni, row.nis) for v in x]
        for k in range(1 << r):
            row.a[:, words[:, k]] = x[k]


def _cross(row, logn, c, fwd):
    """The radix-C pass: rank r's thread t takes the bases
    r NL/C + t + i T (T threads, NL = N/C) and their words b + k NL."""
    lc = c.bit_length() - 1
    nl = 1 << (logn - lc)
    T = _threads(logn - lc)
    per = nl // c
    bases = []
    for rank in range(c):
        b = rank * per + np.arange(T)[:, None] + T * np.arange(-(-per // T))[None, :]
        bases.append(b[b < (rank + 1) * per])
    bases = np.concatenate(bases)
    assert np.array_equal(np.sort(bases), np.arange(nl))
    x = [row.a[:, bases + k * nl] for k in range(c)]
    idx = lambda d, p: np.full((row.a.shape[0], len(bases)), (1 << d) + p)  # noqa: E731
    x = row.radix(x, idx, lc, fwd)
    if not fwd:
        x = [row.shoup(v, row.ni, row.nis) for v in x]
    for k in range(c):
        row.a[:, bases + k * nl] = x[k]


def _model(x, ring, c, fwd):
    """One transform of int64 words [..., L, N] in the kernel's order."""
    logn = ring.n.bit_length() - 1
    lognl = logn - (c.bit_length() - 1)
    row = _Row64(x, ring, fwd)
    if fwd:
        if c > 1:
            _cross(row, logn, c, True)
        s0 = 0
        for r in _passes(lognl):
            _local(row, logn, c, s0, r, True, False)
            s0 += r
    else:
        end = lognl
        for r in _passes_bwd(lognl):
            end -= r
            _local(row, logn, c, end, r, False, c == 1 and end == 0)
        if c > 1:
            _cross(row, logn, c, False)
    q = row.q
    out = row.csub(row.csub(row.a, 2 * q), q) if fwd else row.csub(row.a, q)
    return torch.from_numpy(out.view(np.int64).reshape(x.shape))


_BUILT = [(logn, c) for logn in range(4, 17) for c in ntt64_cuda.clusters(1 << logn)]


@functools.lru_cache(maxsize=None)
def _plain(logn):
    """A ring of 45-, 55- and 61-bit primes (at 2^14 the 45- and 61-bit
    ones, from 2^15 on the 61-bit one, one row: the torch-op reference takes
    seconds there), an input with the top residue in it, and its plain
    forward and inverse transforms."""
    n = 1 << logn
    moduli = [_moduli(n, 45, 1)[0], _moduli(n, 55, 1)[0],
              pr.NTTFriendlyPrimesGenerator(61, 2 * n).next_downstream_prime()]
    lead = (2,)
    if logn >= 14:
        moduli, lead = [moduli[0], moduli[2]] if logn == 14 else [moduli[2]], (1,)
    ring = rings.new_ring(n, moduli, device="cpu")
    x = torch.from_numpy(_draw(n, moduli, logn, lead=lead).astype(np.int64))
    x[0, -1] = moduli[-1] - 1
    return ring, x, ntt64_cuda.ntt_fwd_plain(x, ring), ntt64_cuda.ntt_bwd_plain(x, ring)


@pytest.mark.parametrize("logn, c", _BUILT)
def test_stage_order_model_matches_plain(logn, c):
    ring, x, fwd, bwd = _plain(logn)
    assert torch.equal(_model(x, ring, c, True), fwd), (logn, c)
    assert torch.equal(_model(x, ring, c, False), bwd), (logn, c)


def test_pass_schedule():
    """ceil(lognl / 3) passes of at most 3 stages, as even as possible,
    shorter first; the inverse walks them backwards; one thread a group of
    8 words (32 to 256 threads); a CTA holds at most 2^14 words (139 KB
    padded, within 227 KB); a thread holds the twiddles of a pass ahead of it
    where its share is at most 16 words, and then takes at most two groups."""
    assert _passes(11) == [2, 3, 3, 3]
    assert _passes(14) == [2, 3, 3, 3, 3]
    assert _passes(13) == [2, 2, 3, 3, 3]
    for lognl in range(4, 15):
        p = _passes(lognl)
        assert sum(p) == lognl and len(p) == -(-lognl // 3) and max(p) <= 3
        assert p == sorted(p) and max(p) - min(p) <= 1
        assert _passes_bwd(lognl) == p[::-1]
        assert _threads(lognl) == min(max((1 << lognl) // 8, 32), 256)
        for r in set(p):
            assert _held(lognl, r) == (_iters(lognl, r) << r <= 16)
            assert not _held(lognl, r) or _iters(lognl, r) <= 2
        assert all(_held(lognl, r) for r in p) == (lognl <= 12)
    assert 8 * _phys(1 << 14) <= SMEM_PER_CTA < 8 * _phys(1 << 15)


def test_paired_table_layout():
    """The ring's B4 tables are [L, N, 2] int64, contiguous: pair j holds the
    bit-reversed psi power w_j = roots_fwd[j] out of Montgomery form and
    floor(w_j 2^64 / q), 16 bytes; the same for psi^-1; a limb slice keeps
    the pairs whole."""
    n = 256
    moduli = _moduli(n, 45, 1) + [pr.NTTFriendlyPrimesGenerator(61, 2 * n).next_downstream_prime()]
    ring = rings.new_ring(n, moduli, device="cpu")
    for pairs, roots in ((ring.psi2, ring.roots_fwd), (ring.ipsi2, ring.roots_bwd)):
        assert pairs.shape == (2, n, 2) and pairs.is_contiguous()
        assert pairs.stride() == (2 * n, 2, 1)
        for limb, q in enumerate(moduli):
            w = [int(v) for v in pairs[limb, :, 0].numpy().view(np.uint64)]
            ws = [int(v) for v in pairs[limb, :, 1].numpy().view(np.uint64)]
            mont = [int(v) for v in roots[limb].numpy().view(np.uint64)]
            assert w == [m * pow(1 << 64, -1, q) % q for m in mont]
            assert ws == [(v << 64) // q for v in w]
    assert torch.equal(ring.limbs(1, 2).psi2, ring.psi2[1:2])


@pytest.mark.parametrize("lognl", range(4, 15))
def test_shared_memory_banks(lognl):
    """A half-warp's 16 64-bit shared accesses (one word k of each thread's
    group) fall in 16 distinct 8-byte slots of the 32 banks, one wavefront,
    in every pass but the one whose group's words are 8 apart (A = 3), where
    at most two share a slot (a 2-way conflict; the parent's pad word every
    32 had it there and in the last pass too).  The cross pass's accesses
    are consecutive words."""
    s0 = 0
    for r in _passes(lognl):
        local, _ = _pass_words(lognl, s0, r)
        worst = 1
        for h in range(0, local.shape[0], 16):
            for k in range(1 << r):
                worst = max(worst, np.bincount(_phys(local[h:h + 16, k]) % 16).max())
        assert worst <= (2 if lognl - s0 - r == 3 else 1), (lognl, s0, r, worst)
        s0 += r

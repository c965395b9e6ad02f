"""PyTorch port, the NTT kernel's geometry and stage order, on the CPU.

``csrc/ntt.cu`` cannot run here, so this file holds two things it relies on:

* the wrapper's geometry rule (``ntt_cuda.geometry``): the cluster size C a
  launch splits each row over, at the shapes of the CKKS step, the NTT bench
  (one transform and the chain) and the w22 test, and its refusal of
  N > 2^15;
* a numpy model of the kernel's stage order, with its lazy uint32
  arithmetic: for the forward, the radix-C pass across the cluster (words
  N/C apart), then in each CTA's chunk of N/C words the local radix-2^R
  passes (R <= 4, shorter passes first), a thread's group of 2^R words at a
  compile-time stride with its twiddles from one table index g; the inverse
  is the mirror, N^-1 applied in the pass that holds stage 0.  The model is
  held exact against the plain version (``ntt_plain``) at logN 4-12 and
  C = 1, 2, 4, 8, so an index error in the partition shows here before the
  kernel runs on a card.

The pass schedule (``pass_from``/``pass_to``) and the padded layout
(``phys``) are the kernel's own: their one-line ``constexpr`` definitions
are read from ``csrc/ntt.cu`` and evaluated here.
"""

import functools
import re

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain

MASK = np.uint64(0xFFFFFFFF)
H100_SMS = 132


# -- geometry ------------------------------------------------------------------

@pytest.mark.parametrize("lead, k, c", [
    ((19,), 1, 8), ((17,), 1, 8), ((7, 19), 1, 8), ((7, 3), 1, 8), ((2, 3), 1, 8),
    ((2, 19), 1, 8),                            # the CKKS step's six shapes
    ((1, 19), 1, 8), ((1, 3), 1, 8),            # [1, L, N]
    ((64, 10), 1, 8),                           # bench.py's dispatch form
    ((24, 10), 500, 1),                         # bench.py's chain
    ((8, 3), 3, 8), ((2, 19), 5, 8), ((7, 19), 2, 1), ((8, 10), 2, 2),  # shorter chains
    ((8, 4), 1, 8)])                            # the w22 test shape
def test_geometry_at_the_path_shapes(lead, k, c):
    assert ntt_cuda.geometry(int(np.prod(lead)), 1 << 14, k, H100_SMS) == c


@pytest.mark.parametrize("rows, logn, k, c", [
    (6, 10, 1, 1), (40, 10, 1, 1), (130, 10, 1, 1), (640, 10, 1, 1), (6, 12, 1, 1),
    (40, 13, 1, 8), (130, 13, 1, 2), (640, 13, 1, 1),
    (130, 14, 1, 8), (640, 14, 1, 8), (130, 15, 1, 8), (640, 15, 1, 8),  # one transform
    (24, 10, 100, 1), (24, 12, 100, 1), (24, 13, 100, 8), (24, 15, 100, 8),
    (240, 15, 100, 1)])                               # a chain
def test_geometry_at_the_measured_sizes(rows, logn, k, c):
    """Launches timed at every C by tools/ntt_cluster_sweep.py."""
    assert ntt_cuda.geometry(rows, 1 << logn, k, H100_SMS) == c


def test_geometry_small_rings_other_cards_and_refusal():
    assert ntt_cuda.geometry(1, 1 << 9, 1, H100_SMS) == 1       # no cluster below 2^10
    assert ntt_cuda.geometry(1, 1 << 9, 7, H100_SMS) == 1
    assert ntt_cuda.geometry(1, 1 << 10, 1, H100_SMS) == 1       # nor below 2^13
    assert ntt_cuda.geometry(1, 1 << 13, 1, H100_SMS) == 8
    assert ntt_cuda.geometry(640, 1 << 15, 1, H100_SMS) == 8
    assert ntt_cuda.geometry(132, 1 << 15, 2, H100_SMS) == 1
    assert ntt_cuda.geometry(6, 1 << 14, 2, 12) == 2            # smallest C covering the SMs
    assert ntt_cuda.geometry(0, 1 << 14, 2, H100_SMS) == 8
    with pytest.raises(NotImplementedError):
        ntt_cuda.geometry(1, 1 << 16, 1, H100_SMS)


# -- the kernel's stage order, modelled ------------------------------------------

def _kernel_constexpr(*names):
    """The kernel's one-line ``constexpr`` functions ``names``, read from
    csrc/ntt.cu and evaluated as Python (integer ``/`` is ``//``)."""
    src = ntt_cuda.SOURCE.read_text()
    env = {}
    for name in names:
        m = re.search(r"constexpr \w+ " + name + r"\(([^)]*)\) \{\s*return ([^;?]*);\s*\}", src)
        assert m, f"{name} not found as a one-line constexpr in {ntt_cuda.SOURCE}"
        args = ", ".join(a.split()[-1] for a in m.group(1).split(","))
        exec(f"def {name}({args}): return {m.group(2).replace('/', '//')}", env)
    return [env[name] for name in names]


_pass_from, _pass_to, _phys = _kernel_constexpr(
    "pass_count", "longer_from", "pass_from", "pass_to", "phys")[2:]


def _passes(lognl):
    """Stages of each local forward pass, in order (``fwd_local``)."""
    out, s0 = [], 0
    while s0 < lognl:
        out.append(_pass_from(lognl, s0))
        s0 += out[-1]
    return out


def _passes_bwd(lognl):
    """Stages of each local inverse pass, last stage first (``bwd_local``)."""
    out, end = [], lognl
    while end > 0:
        out.append(_pass_to(lognl, end))
        end -= out[-1]
    return out


@functools.lru_cache(maxsize=None)
def _tables(logn):
    n = 1 << logn
    return ntt_cuda.build_tables(n, ntt_cuda.find_v2_primes(n, 2), "cpu")


class _Row:
    """Rows [B, N] as uint64 words below 2^32, with their limb's tables."""

    def __init__(self, x, tabs, fwd):
        rows = x.reshape(-1, tabs.n)
        limb = np.arange(rows.shape[0]) % tabs.num_limbs
        u32 = lambda t: t.numpy().view(np.uint32).astype(np.uint64)[limb]
        self.a = rows.numpy().astype(np.uint64)
        self.q = u32(tabs.moduli)[:, None]
        self.w = u32(tabs.psi if fwd else tabs.ipsi)
        self.ws = u32(tabs.psi_shoup if fwd else tabs.ipsi_shoup)
        self.ni = u32(tabs.ninv)[:, None]
        self.nis = u32(tabs.ninv_shoup)[:, None]

    def shoup(self, x, w, ws):
        """The kernel's w x - umulhi(ws, x) q, wrapping at 2^32: [0, 2q)."""
        out = (w * x - ((ws * x) >> np.uint64(32)) * self.q) & MASK
        assert (out < 2 * self.q).all()
        return out

    def csub(self, x, m):
        return np.where(x >= m, x - m, x)


def _radix(row, x, idx_of_twiddle, r, fwd):
    """R stages on x[k] (arrays [B, G]); stage d pairs k and k + 2^(R-1-d)
    with the twiddle at table index idx_of_twiddle(d, k >> (R - d))."""
    q2 = 2 * row.q
    order = range(r) if fwd else range(r - 1, -1, -1)
    for d in order:
        half = 1 << (r - 1 - d)
        for k in range(1 << r):
            if k & half:
                continue
            i = idx_of_twiddle(d, k >> (r - d))
            w, ws = np.take_along_axis(row.w, i, 1), np.take_along_axis(row.ws, i, 1)
            u, v = x[k], x[k + half]
            if fwd:
                a, b = row.csub(u, q2), row.shoup(v, w, ws)
                x[k], x[k + half] = a + b, a + q2 - b
                assert (x[k] < 4 * row.q).all() and (x[k + half] < 4 * row.q).all()
            else:
                x[k], x[k + half] = row.csub(u + v, q2), row.shoup(u + q2 - v, w, ws)


def _local_pass(row, logn, c, s0, r, fwd, scale):
    """Stages s0 .. s0+r-1 of every CTA's chunk: group (hi, lo) holds words
    base + k 2^A, its twiddles from g = (C + rank) 2^s0 + hi."""
    lc = c.bit_length() - 1
    lognl = logn - lc
    a_ = lognl - s0 - r
    gid = np.arange(1 << (lognl - r))
    hi, lo = gid >> a_, gid & ((1 << a_) - 1)
    base = (hi << (a_ + r)) | lo
    k = np.arange(1 << r)
    local = base[:, None] + (k << a_)[None]                        # [G, 2^R]
    assert (_phys(local) == _phys(base)[:, None] + _phys(k << a_)[None]).all()
    rank = np.arange(c)[:, None, None]
    words = (rank << lognl) + local[None]                          # [C, G, 2^R]
    g = ((c + rank[:, :, 0]) << s0) + hi[None]                     # [C, G]
    assert np.array_equal(np.sort(words.ravel()), np.arange(1 << logn))
    words, g = words.reshape(-1, 1 << r), g.reshape(-1)
    x = [row.a[:, words[:, kk]] for kk in range(1 << r)]
    _radix(row, x, lambda d, p: np.broadcast_to((g << d) + p, x[0].shape), r, fwd)
    if scale:
        x = [row.shoup(v, row.ni, row.nis) for v in x]
    for kk in range(1 << r):
        row.a[:, words[:, kk]] = x[kk]


def _cross_pass(row, logn, c, fwd):
    """Global stages 0 .. log2(C)-1 on the words b + k N/C, rank r taking
    the bases [r N/C^2, (r+1) N/C^2); the inverse applies N^-1."""
    lc = c.bit_length() - 1
    nl = 1 << (logn - lc)
    bases = np.concatenate([np.arange(r * nl // c, (r + 1) * nl // c) for r in range(c)])
    assert np.array_equal(bases, np.arange(nl))
    x = [row.a[:, bases + kk * nl] for kk in range(c)]
    _radix(row, x, lambda d, p: np.full(x[0].shape, (1 << d) + p), lc, fwd)
    if not fwd:
        x = [row.shoup(v, row.ni, row.nis) for v in x]
    for kk in range(c):
        row.a[:, bases + kk * nl] = x[kk]


def _model(x, tabs, c, fwd, k):
    """k chained transforms of int32 [..., L, N] in the kernel's order."""
    logn = tabs.n.bit_length() - 1
    lognl = logn - (c.bit_length() - 1)
    row = _Row(x, tabs, fwd)
    starts = np.cumsum([0] + _passes(lognl))
    for _ in range(k):
        if fwd:
            if c > 1:
                _cross_pass(row, logn, c, True)
            for s0, r in zip(starts[:-1], _passes(lognl)):
                _local_pass(row, logn, c, int(s0), r, True, False)
        else:
            end = lognl
            for r in _passes_bwd(lognl):
                end -= r
                _local_pass(row, logn, c, end, r, False, c == 1 and end == 0)
            if c > 1:
                _cross_pass(row, logn, c, False)
    q = row.q
    out = row.csub(row.csub(row.a, 2 * q), q) if fwd else row.csub(row.a, q)
    return torch.from_numpy(out.astype(np.int32).reshape(x.shape))


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("logn", range(4, 13))
def test_stage_order_model_matches_plain(logn, c):
    tabs = _tables(logn)
    n, moduli = tabs.n, tabs.moduli.numpy().astype(np.int64)
    rng = np.random.default_rng(logn * 8 + c)
    x = torch.from_numpy((rng.integers(0, 1 << 62, (2, 2, n)) % moduli[:, None]).astype(np.int32))
    x[0, 0] = tabs.moduli[0] - 1                                    # the top residue
    k = 2 if logn in (10, 12) else 1
    for fwd in (True, False):
        want = ntt_plain.ntt_chain_plain(x, tabs, k, fwd)
        assert torch.equal(_model(x, tabs, c, fwd, k), want), (logn, c, fwd)


@pytest.mark.parametrize("lognl", range(5, 16))
def test_padded_row_bank_conflicts(lognl):
    """Each local pass's shared-memory accesses (one word k of its group a
    lane, 32 consecutive groups a warp) hit a bank at most twice (four times
    in one pass of a 2^9-word chunk), and only one pass of a chunk hits a
    bank more than once."""
    worst, s0 = [], 0
    for r in _passes(lognl):
        a_ = lognl - s0 - r
        gid = np.arange(1 << (lognl - r)).reshape(-1, 32) if lognl - r >= 5 else \
            np.arange(1 << (lognl - r))[None]
        base = ((gid >> a_) << (a_ + r)) | (gid & ((1 << a_) - 1))
        banks = _phys(base[..., None] + (np.arange(1 << r) << a_)) % 32   # [warp, lane, k]
        per = [max(np.bincount(banks[w, :, k]).max() for w in range(banks.shape[0]))
               for k in range(1 << r)]
        worst.append(max(per))
        s0 += r
    assert max(worst) <= (4 if lognl == 9 else 2), worst
    assert sum(w > 1 for w in worst) <= 1, worst


def test_pass_schedule():
    """The kernel's passes: ceil(lognl / 4) of at most 4 stages, as even as
    possible, shorter first; the inverse walks the same passes backwards."""
    assert _passes(14) == [3, 3, 4, 4]
    assert _passes(11) == [3, 4, 4]
    for lognl in range(1, 16):
        p = _passes(lognl)
        assert sum(p) == lognl and len(p) == -(-lognl // 4) and max(p) <= 4
        assert p == sorted(p) and max(p) - min(p) <= 1
        assert _passes_bwd(lognl) == p[::-1]

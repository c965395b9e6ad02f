"""PyTorch port, kernel B6's schedule (csrc/ntt_sharded.cu), as a numpy model.

The tiled kernel's index logic, from ``ntt_sharded_cuda.geometry``'s
geometry and the thread arithmetic of ``tiled_kernel``, on the CPU: at
N = 2^4 to 2^16 and k = 1, 2, 4 and 8 shards,

  * every output (i, j) of a (lead, limb) block is written once, by one
    thread's 2 x 2 tile of step 2, and every word of W = (A @ x) .* T once
    in step 1's meeting of the partials;
  * every sum covers each of its terms once: a W word's R terms over the
    stages and the s1 threads sharing its tile, an output's c terms over the
    stages of B^T;
  * a thread adds at most ``CHUNK`` terms to a 128-bit sum between two
    reductions, so it stays below 2^128 for q < 2^61 (each term < q^2);
  * the stages, A's rows and the partials fit the kernel's shared memory,
    and every thread owns at most one 2 x cn tile (cn = 2 or 4) of each
    product.

``CHUNK`` and ``STAGE_WORDS`` are read back from the source's constants
(the ring holds two stages);
the simple kernel (c = 1) has one output row a CTA and is held by the GPU
tests.
"""

import re

import numpy as np
import pytest

from matrix_fhe_tpu_torch.ops import ntt_sharded_cuda as nc

SMEM_BYTES = 232448  # a CTA's shared memory on an H100 (227 KB)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", nc.SOURCE.read_text())
    return int(m.group(1))


def test_constants_match_the_source():
    assert nc.CHUNK == _constant("kChunk")
    assert nc.STAGE_WORDS == _constant("kStageWords")
    assert nc.MAX_COLS == _constant("kMaxCols")
    for threads in nc.THREADS:
        for cn in (2, 4):
            assert f"tiled_kernel<{threads}, {cn}>" in nc.SOURCE.read_text()


def _drains(lengths):
    """The 128-bit sum's terms between reductions, for slices of ``lengths``
    terms: a reduction first where the next slice would pass CHUNK (the
    kernel's ``terms`` counter), and one at the end."""
    out, terms = [], 0
    for n in lengths:
        if terms + n > nc.CHUNK:
            out.append(terms)
            terms = 0
        terms += n
    return out + [terms]


def tile_of(index, width: int, cn: int):
    """``tile_of<cn>``: a thread's rows r, r + 1 and columns j + p seg + e."""
    seg = width // (cn // 2)
    return 2 * (index // (seg // 2)), 2 * (index % (seg // 2)), seg


def tile_cols(j, seg, cn):
    return [j + p * seg + e for p in range(cn // 2) for e in (0, 1)]


def schedule(R: int, C: int, c: int, threads: int, ti: int, cn: int, kc1: int, s1: int,
             kc2: int):
    """(W term counts [R, c, R], output term counts [R, C, c], output writes
    [R, C], the largest sum between reductions), over every CTA of one
    (lead, limb) block and every thread of each."""
    t = np.arange(threads)
    tiles1 = (ti // 2) * (c // cn)
    on1 = t < tiles1 * s1
    p1, len1 = t // tiles1, kc1 // s1
    r1, j1, seg1 = tile_of(t % tiles1, c, cn)
    on2 = t < (ti // 2) * (C // cn)
    r2, j2, seg2 = tile_of(t, C, cn)
    w_idx, o_idx, writes = [], [], []
    for i0 in range(0, R, ti):
        for st in range(R // kc1):  # step 1: stage st, thread slice p1
            k = st * kc1 + p1[on1, None] * len1 + np.arange(len1)
            for dr in (0, 1):
                for col in tile_cols(j1[on1, None], seg1, cn):
                    rows = i0 + r1[on1, None] + dr
                    w_idx.append(((rows * c + col) * R + k).ravel())
        for st in range(c // kc2):  # step 2: stage st of B^T's rows
            m = st * kc2 + np.arange(kc2)
            for dr in (0, 1):
                for col in tile_cols(j2[on2, None], seg2, cn):
                    rows = i0 + r2[on2, None] + dr
                    o_idx.append(((rows * C + col) * c + m).ravel())
        for dr in (0, 1):  # the stores at the end
            for col in tile_cols(j2[on2], seg2, cn):
                writes.append((i0 + r2[on2] + dr) * C + col)
    w = np.bincount(np.concatenate(w_idx), minlength=R * c * R).reshape(R, c, R)
    o = np.bincount(np.concatenate(o_idx), minlength=R * C * c).reshape(R, C, c)
    wr = np.bincount(np.concatenate(writes), minlength=R * C).reshape(R, C)
    longest = max(max(_drains([len1] * (R // kc1))), max(_drains([kc2] * (c // kc2))))
    return w, o, wr, longest


# (log2 N, k, cn): the rule's tiles (cn None), and 2 x 2 and 2 x 4 tiles
# where c allows
CASES = [(logn, k, cn) for logn in range(4, 17) for k in (1, 2, 4, 8) for cn in (None, 2, 4)
         if (1 << (logn - logn // 2)) // k >= max(2, cn or 2)]


@pytest.mark.parametrize("logn, k, cn", CASES)
def test_tiled_schedule(logn, k, cn):
    R, C = 1 << (logn // 2), 1 << (logn - logn // 2)
    c = C // k
    threads, ti, cn, kc1, s1, kc2 = g = nc.geometry(R, C, c, cn=cn)
    assert threads in nc.THREADS and cn in (2, 4) and c % cn == 0, g
    assert R % ti == 0 and ti * C <= 2 * cn * threads, g
    # the limits mfhe_ntt_sharded_local checks
    assert R % kc1 == 0 and kc1 % s1 == 0 and kc1 <= nc.CHUNK * s1, g
    assert (ti // 2) * (c // cn) * s1 <= threads and c % kc2 == 0 and kc2 <= nc.CHUNK, g
    assert kc1 * c <= nc.STAGE_WORDS and kc2 * C <= nc.STAGE_WORDS, g
    assert s1 * ti * c <= nc.STAGE_WORDS, g  # the partials take a stage
    assert 8 * (2 * nc.STAGE_WORDS + ti * (R + 2) + 2 * ti * c) <= SMEM_BYTES, g
    w, o, writes, longest = schedule(R, C, c, *g)
    assert (w == 1).all(), f"a W term covered {w.min()}-{w.max()} times, {g}"
    assert (o == 1).all(), f"an output term covered {o.min()}-{o.max()} times, {g}"
    assert (writes == 1).all(), g
    # a sum of at most CHUNK terms, each < q^2 < 2^122 for q < 2^61
    assert 1 <= longest <= nc.CHUNK
    assert nc.CHUNK * ((1 << 61) - 1) ** 2 < 1 << 128


def test_mac_product_parts_do_not_carry():
    """``mac``'s partial products: t = a0 b1 + (a0 b0 >> 32) and
    u = a1 b0 + (t mod 2^32) stay below 2^64 for every 64-bit a, b, and the
    parts give the 128-bit product (at the largest words and at random
    ones)."""
    rng = np.random.default_rng(0)
    words = [(1 << 64) - 1, (1 << 61) - 1, 0, 1] + [int(v) for v in
                                                   rng.integers(0, 1 << 63, 64, dtype=np.int64)]
    m32 = (1 << 32) - 1
    for a in words:
        for b in words[:8]:
            a0, a1, b0, b1 = a & m32, a >> 32, b & m32, b >> 32
            p = a0 * b0
            t = a0 * b1 + (p >> 32)
            u = a1 * b0 + (t & m32)
            h = a1 * b1 + (t >> 32) + (u >> 32)
            lo = ((u & m32) << 32) | (p & m32)
            assert t < 1 << 64 and u < 1 << 64 and h < 1 << 64
            assert (h << 64) | lo == a * b

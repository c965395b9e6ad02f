"""PyTorch port, the NTT of 64-bit words (kernel B4's plain version and its
schedule), on the CPU.

* The plain u64 NTT (``ntt64_cuda.ntt_fwd_plain``/``ntt_bwd_plain``, the
  torch-op transform of ``ops/rings.py``) equals ``wide.unpack_pair`` of the
  JAX package's wide NTT (``ops/wide_ntt.py``, digit-plane matmuls) on the
  same primes: tests/test_wide_ntt.py's shapes and the NTT cases of
  tests/test_wide61.py (60/61/56-bit primes, pair31), batched, and at the
  extreme values.  ``Ring.ntt``/``intt`` on a CPU tensor is that version.
* ``csrc/ntt64.cu`` cannot run here: its geometry rule
  (``ntt64_cuda.geometry``) and a numpy model of its stage order, with its
  lazy 64-bit Shoup arithmetic, are held here: the radix-C pass across the
  cluster, then the local radix-2^R passes (R <= 3, shorter first), the
  inverse the mirror with N^-1 where stage 0 is.  The model equals the plain
  version at logN 4-16 and every cluster size the kernel is built for
  (C = 1, 2, 4, 8 with N / C <= 2^14).  The pass schedule and ``phys`` are
  read from the kernel source's one-line ``constexpr`` functions.
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
from test_torch_ntt_schedule import _cross_pass, _local_pass

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
        pwide.check_moduli([(1 << 61) + 1])


# -- geometry ------------------------------------------------------------------

@pytest.mark.parametrize("rows, logn, c", [
    (7, 14, 8), (9, 14, 8), (4 * 9, 14, 8), (2 * 9, 14, 8),   # the wide step at logN 14
    (21, 14, 8), (1, 14, 8), (102, 14, 8),                    # bootstrap-sized launches
    (1, 6, 1), (300, 10, 1), (6, 13, 8), (300, 13, 1), (100, 13, 2),
    (1, 15, 8), (640, 15, 8), (1, 16, 8), (640, 16, 8)])
def test_geometry(rows, logn, c):
    assert ntt64_cuda.geometry(rows, 1 << logn, H100_SMS) == c


def test_geometry_floor_and_refusal():
    # on a card of few SMs the smallest cluster still holds N / 2^14 words a CTA
    assert ntt64_cuda.geometry(1000, 1 << 13, 12) == 1
    assert ntt64_cuda.geometry(1000, 1 << 14, 12) == 8
    with pytest.raises(NotImplementedError):
        ntt64_cuda.geometry(1, 1 << 17, H100_SMS)


# -- the kernel's stage order, modelled ------------------------------------------

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


_pass_from, _pass_to, _phys = _kernel_constexpr(
    "pass_count", "longer_from", "pass_from", "pass_to", "phys")[2:]


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
    """Rows [B, N] of uint64 words with their limb's B4 tables: the
    interface of the B1 model's rows, with the kernel's 64-bit Shoup
    product."""

    def __init__(self, x, ring, fwd):
        rows = x.reshape(-1, ring.n)
        limb = np.arange(rows.shape[0]) % ring.num_limbs
        u64 = lambda t: t.numpy().view(np.uint64)[limb]
        self.a = rows.numpy().view(np.uint64).copy()
        self.q = u64(ring.moduli)[:, None]
        self.w = u64(ring.psi if fwd else ring.ipsi)
        self.ws = u64(ring.psi_shoup if fwd else ring.ipsi_shoup)
        self.ni = u64(ring.ninv_plain)[:, None]
        self.nis = u64(ring.ninv_shoup)[:, None]

    def shoup(self, x, w, ws):
        """w x - umul64hi(ws, x) q, wrapping at 2^64: [0, 2q)."""
        with np.errstate(over="ignore"):
            out = w * x - _mul64_hi(ws, x) * self.q
        assert (out < 2 * self.q).all()
        return out

    def csub(self, x, m):
        return np.where(x >= m, x - m, x)


def _model(x, ring, c, fwd):
    """One transform of int64 words [..., L, N] in the kernel's order."""
    logn = ring.n.bit_length() - 1
    lognl = logn - (c.bit_length() - 1)
    row = _Row64(x, ring, fwd)
    if fwd:
        if c > 1:
            _cross_pass(row, logn, c, True)
        s0 = 0
        for r in _passes(lognl):
            _local_pass(row, logn, c, s0, r, True, False)
            s0 += r
    else:
        end = lognl
        for r in _passes_bwd(lognl):
            end -= r
            _local_pass(row, logn, c, end, r, False, c == 1 and end == 0)
        if c > 1:
            _cross_pass(row, logn, c, False)
    q = row.q
    out = row.csub(row.csub(row.a, 2 * q), q) if fwd else row.csub(row.a, q)
    return torch.from_numpy(out.view(np.int64).reshape(x.shape))


_BUILT = [(logn, c) for logn in range(4, 17) for c in (1, 2, 4, 8)
          if (c == 1 or logn >= 10) and logn - (c.bit_length() - 1) <= 14]


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
    shorter first; the inverse walks them backwards; a CTA holds at most
    2^14 words (132 KB padded, within 227 KB)."""
    assert _passes(14) == [2, 3, 3, 3, 3]
    assert _passes(11) == [2, 3, 3, 3]
    for lognl in range(4, 15):
        p = _passes(lognl)
        assert sum(p) == lognl and len(p) == -(-lognl // 3) and max(p) <= 3
        assert p == sorted(p) and max(p) - min(p) <= 1
        assert _passes_bwd(lognl) == p[::-1]
    assert 8 * _phys(1 << 14) <= 232448 < 8 * _phys(1 << 15)

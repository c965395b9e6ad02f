"""PyTorch port, wide-modulus arithmetic (ops/wide.py) on 64-bit words.

tests/test_wide.py's and tests/test_wide61.py's cases on the same moduli
(the reference's 45/55-bit primes, 56/60/61-bit bootstrapping primes and
the range edges, the 61-bit prime above 2^61 included) and operands: each
port op's words equal ``wide.unpack_pair`` of the JAX package's op on the
packed pairs, and the exact result in Python integers.  The pair
conversions are the JAX package's, array for array.  The wide path admits
the JAX package's pair31 range, [2^41, 2^61 + 2^55); the u64 rings stop at
2^61.
"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import wide as jwide
from matrix_fhe_tpu_torch.fast import wring
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rings
from matrix_fhe_tpu_torch.ops import wide as pwide
from matrix_fhe_tpu_torch.utils import primes as pr

N2 = 1 << 15
PRIME61 = pr.NTTFriendlyPrimesGenerator(61, N2).next_alternating_prime()  # above 2^61
MODULI = {
    "wide": [0x2000000A0001, 0x2000000E0001, 0x80000000080001, (1 << 41) + 9, (3 << 54) - 59],
    # tests/test_wide61.py's
    "wide61": [PRIME61, pr.NTTFriendlyPrimesGenerator(60, N2).next_alternating_prime(),
               pr.NTTFriendlyPrimesGenerator(56, N2).next_alternating_prime(),
               0x2000000A0001, (1 << 41) + 9, (1 << 61) - 59],
}


def _operands(moduli, seed, n=256):
    """uint64 [L, N] canonical operands with the edge values first."""
    rng = np.random.default_rng(seed)
    x = np.empty((len(moduli), n), dtype=np.uint64)
    for i, q in enumerate(moduli):
        v = rng.integers(0, q, n, dtype=np.uint64)
        v[:8] = [0, 1, q - 1, q // 2, q // 2 + 1, q - 2, 2, (q + 1) // 2]
        x[i] = v
    return x


def _consts(moduli):
    q = torch.tensor(moduli, dtype=torch.int64)[:, None]
    b = [mm.gen_bred_constant(m) for m in moduli]
    bhi = torch.tensor([mm.signed(h) for h, _ in b], dtype=torch.int64)[:, None]
    blo = torch.tensor([mm.signed(lo) for _, lo in b], dtype=torch.int64)[:, None]
    return q, bhi, blo


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.int64))


def _words(pair, moduli):
    return jwide.unpack_pair(np.asarray(pair), moduli).astype(np.int64)


def _exact(a, b, moduli, op):
    return np.array([[op(int(x), int(y)) % q for x, y in zip(ra, rb)]
                     for ra, rb, q in zip(a, b, moduli)], dtype=np.uint64).astype(np.int64)


@pytest.fixture(scope="module", params=sorted(MODULI))
def mods(request):
    moduli = MODULI[request.param]
    return moduli, jwide.build_wide_tables(moduli)


def test_mode_rule_and_range():
    """The JAX package's range (tests/test_wide61.py:56): up to 2^61 + 2^55,
    exclusive; the wide ring takes the prime above 2^61, the u64 ring
    refuses it."""
    for moduli in MODULI.values():
        assert pwide.use_pair31(moduli) == jwide.use_pair31(moduli)
        assert pwide.check_moduli(moduli) == tuple(moduli)
    assert not pwide.use_pair31([0x2000000A0001, 0x80000000080001])
    assert 1 << 61 < PRIME61 < pwide.MAX_WIDE_MODULUS == jwide.MAX_WIDE_MODULUS
    top = (1 << 61) + (1 << 55) - 1
    assert pwide.check_moduli([top]) == (top,)
    jwide.build_wide_tables([top])
    for bad in ((1 << 61) + (1 << 55), (1 << 62), (1 << 41) - 1):
        with pytest.raises(ValueError, match="wide path range"):
            pwide.check_moduli([bad])
        with pytest.raises(ValueError):
            jwide.build_wide_tables([bad], pair31=True)
    # the largest NTT-friendly prime below the limit, at N = 2^6
    near = (pwide.MAX_WIDE_MODULUS - 1) // (1 << 7) * (1 << 7) + 1
    while not pr.is_prime(near):
        near -= 1 << 7
    for q in (near, PRIME61):
        assert wring.new_wide_ring(1 << 6, [q], device="cpu").moduli_tuple == (q,)
    with pytest.raises(ValueError, match="2\\^61"):
        rings.new_ring(1 << 6, [PRIME61], device="cpu")
    with pytest.raises(ValueError, match="wide path range"):
        wring.new_wide_ring(1 << 6, [(1 << 61) + (1 << 55) + 1], device="cpu")


def test_pack_unpack_roundtrip(mods):
    moduli, _ = mods
    x = _operands(moduli, 0)
    for pair31 in (None, True):
        p = pwide.pack_pair(x, moduli, pair31)
        np.testing.assert_array_equal(p, jwide.pack_pair(x, moduli, pair31))
        np.testing.assert_array_equal(pwide.unpack_pair(p, moduli, pair31), x)


def test_add_sub_neg(mods):
    moduli, tabs = mods
    a64, b64 = _operands(moduli, 1), _operands(moduli, 2)
    a, b = jwide.pack_pair(a64, moduli), jwide.pack_pair(b64, moduli)
    q, _, _ = _consts(moduli)
    for name, got, want in (
            ("add", pwide.add(q, _t(a64), _t(b64)), jwide.add(tabs, a, b)),
            ("sub", pwide.sub(q, _t(a64), _t(b64)), jwide.sub(tabs, a, b)),
            ("neg", pwide.neg(q, _t(a64)), jwide.neg(tabs, a))):
        np.testing.assert_array_equal(got.numpy(), _words(want, moduli), err_msg=name)
    np.testing.assert_array_equal(pwide.add(q, _t(a64), _t(b64)).numpy(),
                                  _exact(a64, b64, moduli, lambda x, y: x + y))


def test_mulmod(mods):
    moduli, tabs = mods
    a64, b64 = _operands(moduli, 3), _operands(moduli, 4)
    q, bhi, blo = _consts(moduli)
    got = pwide.mulmod(q, bhi, blo, _t(a64), _t(b64)).numpy()
    want = jwide.mulmod(tabs, jwide.pack_pair(a64, moduli), jwide.pack_pair(b64, moduli))
    np.testing.assert_array_equal(got, _words(want, moduli))
    np.testing.assert_array_equal(got, _exact(a64, b64, moduli, lambda x, y: x * y))


def test_mulmod_any_words_and_canon(mods):
    """The JAX package's lazy-input case: the port's counterpart of a lazy
    representative is any 64-bit word; products and ``canon`` reduce it."""
    moduli, _ = mods
    rng = np.random.default_rng(5)
    a = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (len(moduli), 256),
                     dtype=np.int64)
    b64 = _operands(moduli, 6)
    q, bhi, blo = _consts(moduli)
    au = a.view(np.uint64)
    got = pwide.mulmod(q, bhi, blo, torch.from_numpy(a), _t(b64)).numpy()
    np.testing.assert_array_equal(got, _exact(au, b64, moduli, lambda x, y: x * y))
    c = pwide.canon(q, bhi, torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(c, _exact(au, au, moduli, lambda x, y: x))


def test_mul_scalar(mods):
    """tests/test_wide.py's mulmod_planes case: a per-limb constant."""
    moduli, tabs = mods
    n = 64
    ring_moduli = [q for q in moduli if pr.is_prime(q) and q % (2 * n) == 1]
    a64 = _operands(moduli, 7)
    consts = [(q * 3) // 7 for q in moduli]
    want = jwide.mulmod_planes(tabs, jwide.pack_pair(a64, moduli), jwide.const_planes(tabs, consts))
    q, bhi, blo = _consts(moduli)
    got = pwide.mulmod(q, bhi, blo, _t(a64), torch.tensor(consts, dtype=torch.int64)[:, None])
    np.testing.assert_array_equal(got.numpy(), _words(want, moduli))
    if ring_moduli:  # the ring's scalar product on its NTT-friendly primes
        ring = wring.new_wide_ring(n, ring_moduli, device="cpu")
        idx = [moduli.index(m) for m in ring_moduli]
        x = _t(a64[idx, :n])
        got_r = ring.mul_scalar_montgomery(x, [consts[i] for i in idx])
        np.testing.assert_array_equal(got_r.numpy(), _words(want, moduli)[idx, :n])


def test_mac_depth8(mods):
    """tests/test_wide.py's mac_planes case: 8 accumulated products, one
    reduction (the wide key-switch MAC's digit sum)."""
    moduli, tabs = mods
    acc, aa, bb = None, [], []
    for k in range(8):
        a64, b64 = _operands(moduli, 10 + k), _operands(moduli, 20 + k)
        aa.append(a64)
        bb.append(b64)
        pa = jwide.pair_to_planes(*np.moveaxis(jwide.pack_pair(a64, moduli), -3, 0), tabs)
        pb = jwide.pair_to_planes(*np.moveaxis(jwide.pack_pair(b64, moduli), -3, 0), tabs)
        acc = jwide.mac_planes(acc, pa, pb, tabs)
    lo, hi = jwide.planes_to_pair(jwide.fold_excess(acc, tabs), tabs)
    want = _words(np.stack([np.asarray(lo), np.asarray(hi)]), moduli)
    q, bhi, blo = _consts(moduli)
    prods = pwide.mulmod(q, bhi, blo, _t(np.stack(aa)), _t(np.stack(bb)))
    got = mm.modsum(prods, q, bhi, dim=0, fold=mm.sum_fold(moduli))
    np.testing.assert_array_equal(got.numpy(), want)


def test_modsum_fold(mods):
    """A deep sum (the key-switch MAC's digit sum at many digits): 64 terms
    of [0, 2q), among them q - 1 and 2q - 1, folded ``sum_fold`` terms a
    round (3 from 2^61 on, where 4 terms of 2q - 1 pass 2^64), against
    Python integers."""
    moduli, _ = mods
    q, bhi, _ = _consts(moduli)
    m = np.array(moduli, dtype=np.uint64)[:, None]
    x = np.stack([_operands(moduli, 40 + k) for k in range(64)])
    x[::2] = m - 1
    x[1::4] += m  # lazy: [q, 2q)
    x[:, :, :4] = 2 * m - 1
    want = np.array([[sum(int(v) for v in x[:, i, j]) % m for j in range(x.shape[-1])]
                     for i, m in enumerate(moduli)], dtype=np.uint64).astype(np.int64)
    fold = mm.sum_fold(moduli)
    assert fold == (3 if max(moduli) >= 1 << 61 else 4)
    got = mm.modsum(_t(x), q, bhi, dim=0, fold=fold)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cred_edges(mods):
    """cred at [0, 2q)'s edges, q up to 2^61 + 2^55."""
    moduli, _ = mods
    q = torch.tensor(moduli, dtype=torch.int64)[:, None]
    x = np.array([[0, 1, m - 1, m, m + 1, 2 * m - 1] for m in moduli], dtype=np.uint64)
    want = np.array([[int(v) % m for v in row] for row, m in zip(x, moduli)], dtype=np.int64)
    np.testing.assert_array_equal(mm.cred(_t(x), q).numpy(), want)

"""PyTorch port, the 3N ring (ops/rings.py of type MATRIX, ops/ntt_3n.py, the
3N parts of utils/primes.py and ops/automorphism.py): held bit-exact against
the JAX package on the same moduli and numpy-seeded inputs.

* the 3N primes, primitive roots and multiplicative orders;
* the ring's tables (the reduction constants, N^-1, the rescale triangle,
  the factorized tables, and the dense matrices, which the ring holds only
  at N = 6 and the tests build beside the factorized ones) and its NTT both
  ways, the plain version of kernel B5, at N = 6 (dense only), 12, 24, 48,
  96 (factorized and dense) and 1152, on JAX's jitted transform;
* ``at_level`` slicing and ``automorphism_ntt_index_3n``;
* the JAX tables carried over (``carry.carry``) with kernel B5's tables
  rebuilt from them, equal to the port ring's;
* tests/test_ntt3n_fact.py's cases on the port (factorized == dense, the
  round trip and the ring product at N = 1152; its slow marks mirrored) and
  tests/test_ntt.py's 3N cases against tests/oracle.py's Horner evaluation.
"""

import math

import jax
import numpy as np
import pytest
import torch

import oracle
from matrix_fhe_tpu.ops import automorphism as jam
from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.ops import rings as jr
from matrix_fhe_tpu.utils import primes as jp
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.ops import automorphism as tam
from matrix_fhe_tpu_torch.ops import ntt_3n
from matrix_fhe_tpu_torch.ops import rings as tr
from matrix_fhe_tpu_torch.utils import primes as tp
from test_torch_rings import _eq, _t


def _rand(rng, moduli, lead, n):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64) for q in moduli],
                    axis=-2)


def _rings(n, moduli):
    return jr.new_ring(n, moduli, jr.MATRIX), tr.new_ring(n, moduli, tr.MATRIX, device="cpu")


def _dense(ring):
    """(forward, inverse) matrices of the dense 3N transform of ``ring``'s
    limbs: the parity oracle of the factorized transform."""
    omegas = tuple(tr._gen_3n_tables(ring.nth_root, q)["omega"] for q in ring.moduli_tuple)
    return tr.Dense3N(ring.n, ring.moduli_tuple, omegas, ring.device).matrices()


@pytest.mark.parametrize("n, bits, count", [(12, 28, 3), (48, 45, 3), (1152, 50, 2),
                                            (12288, 40, 5), (12288, 60, 1)])
def test_3n_primes_and_roots(n, bits, count):
    moduli = tp.find_3n_rns_primes(n, bits, count)
    assert moduli == jp.find_3n_rns_primes(n, bits, count)
    for q in moduli:
        assert q % (3 * n) == 1 and q > 1 << bits
        omega, factors = tp.find_3n_primitive_root(q, 3 * n)
        assert (omega, factors) == jp.find_3n_primitive_root(q, 3 * n)
        assert tp.multiplicative_order(omega, q) == jp.multiplicative_order(omega, q) == 3 * n
    assert [tr.is_valid_3n_degree(k) for k in range(200)] == [
        jr.is_valid_3n_degree(k) for k in range(200)]


_jax_ntt = jax.jit(jr.Ring.ntt)
_jax_intt = jax.jit(jr.Ring.intt)


@pytest.mark.parametrize("n", [6, 12, 24, 48, 96, 1152])
def test_ring_and_ntt_match_jax(n):
    """The tables, then the transform both ways on a [2, L, N] input: the
    dispatch's transform (factorized from N = 12 on) and the dense one."""
    moduli = tp.find_3n_rns_primes(n, 45, 1) + tp.find_3n_rns_primes(n, 59, 1)
    jring, tring = _rings(n, moduli)
    assert (tring.n, tring.nth_root, tring.ring_type) == (jring.n, jring.nth_root, "matrix")
    for name in ("moduli", "qinv", "bhi", "blo", "ninv", "rescale"):
        _eq(getattr(tring, name), getattr(jring, name))
    assert (tring.ntt3n is None) == (jring.ntt3n is None) == (n == 6)
    if n != 6:
        assert (tring.ntt3n.rows, tring.ntt3n.cols) == (jring.ntt3n.rows, jring.ntt3n.cols)
        for name in ntt_3n.LIMB_FIELDS:
            _eq(getattr(tring.ntt3n, name), getattr(jring.ntt3n, name))
        for name in ("perm", "iperm"):
            np.testing.assert_array_equal(getattr(tring.ntt3n, name).numpy(),
                                          np.asarray(getattr(jring.ntt3n, name)))
    assert (tring.dense3n is None) == (n != 6)
    assert (jring.ntt_fwd_mat is None) == (n > 384)
    if n <= 384:
        fwd, bwd = _dense(tring)
        _eq(fwd, jring.ntt_fwd_mat)
        _eq(bwd, jring.ntt_bwd_mat)
    x = _rand(np.random.default_rng(n), moduli, (2,), n)
    f = tring.ntt(_t(x))
    _eq(f, _jax_ntt(jring, jm.u64(x)))
    _eq(tring.intt(_t(x)), _jax_intt(jring, jm.u64(x)))
    assert torch.equal(tring.intt(f), _t(x))
    if n <= 384:
        args = (tring.moduli, tring.qinv, tring.bhi)
        assert torch.equal(tr._ntt_matrix_ring(_t(x), fwd, *args), f)
        assert torch.equal(tr._ntt_matrix_ring(f, bwd, *args), _t(x))


def test_at_level_slices_tables():
    """tests/test_ntt3n_fact.py:67, and the sliced views against JAX's."""
    n = 48
    moduli = tp.find_3n_rns_primes(n, 45, 3)
    jring, tring = _rings(n, moduli)
    for lo, hi in ((0, 2), (1, 2), (2, 3)):
        sub = tring.limbs(lo, hi)
        for name in ntt_3n.LIMB_FIELDS:
            _eq(getattr(sub.ntt3n, name), getattr(jring.ntt3n, name)[lo:hi])
        assert sub.dense3n is None
    sub = tring.at_level(1)
    assert sub.level == 1 and sub.at_level(1) is sub
    _eq(sub.ntt3n.wr, jring.at_level(1).ntt3n.wr)
    rng = np.random.default_rng(2)
    x = _rand(rng, moduli[:2], (), n)
    full = tring.ntt(_t(np.concatenate([x, np.zeros((1, n), dtype=np.uint64)])))[:2]
    assert torch.equal(sub.ntt(_t(x)), full)
    assert torch.equal(tring.limbs(1, 2).ntt(_t(x[1:])), full[1:])
    _eq(sub.ntt(_t(x)), _jax_ntt(jring.at_level(1), jm.u64(x)))
    with pytest.raises(ValueError, match="above"):
        sub.at_level(2)
    # N = 6 has no factorized split: its dense transform is sliced instead
    moduli6 = tp.find_3n_rns_primes(6, 45, 3)
    ring6 = tr.new_ring(6, moduli6, tr.MATRIX, device="cpu")
    x6 = _t(_rand(rng, moduli6, (), 6))
    for lo, hi in ((0, 2), (1, 2), (2, 3)):
        sub6 = ring6.limbs(lo, hi)
        assert sub6.ntt3n is None and sub6.dense3n.moduli == tuple(moduli6[lo:hi])
        assert torch.equal(sub6.ntt(x6[lo:hi]), ring6.ntt(x6)[lo:hi])


@pytest.mark.parametrize("n", [12, 48, 1152])
def test_carried_tables_hold_kernel_tables(n):
    """The JAX ring's tables carried over: kernel B5's tables, rebuilt from
    each limb's modulus and root read back from its twist row, equal the
    port ring's; a row that is no such twist row is refused."""
    moduli = tp.find_3n_rns_primes(n, 45, 1) + tp.find_3n_rns_primes(n, 59, 1)
    jring, tring = _rings(n, moduli)
    carried = carry.carry(jring.ntt3n, "cpu")
    for name in ntt_3n.LIMB_FIELDS + ntt_3n.KERNEL_FIELDS + ("kidx",):
        assert torch.equal(getattr(carried, name), getattr(tring.ntt3n, name)), name
    row = np.asarray(jring.ntt3n.tw1)[1]
    assert ntt_3n.modulus_and_root(row)[0] == moduli[1]
    bad = row.copy()
    bad[-1] ^= np.uint64(1)
    with pytest.raises(ValueError, match="twist row"):
        ntt_3n.modulus_and_root(bad)


@pytest.mark.parametrize("n", [12, 24, 48, 96, pytest.param(192, marks=pytest.mark.slow),
                               pytest.param(384, marks=pytest.mark.slow)])
def test_factorized_matches_dense(n):
    """tests/test_ntt3n_fact.py:16 on the port (its slow marks mirrored)."""
    moduli = tp.find_3n_rns_primes(n, 45, 2)
    ring = tr.new_ring(n, moduli, tr.MATRIX, device="cpu")
    assert ring.ntt3n is not None and ring.dense3n is None
    x = _t(_rand(np.random.default_rng(0), moduli, (), n))
    fwd_mat, bwd_mat = _dense(ring)
    args = (ring.moduli, ring.qinv, ring.bhi)
    dense = tr._ntt_matrix_ring(x, fwd_mat, *args)
    assert torch.equal(ring.ntt(x), dense)
    bwd = ring.intt(dense)
    assert torch.equal(bwd, tr._ntt_matrix_ring(dense, bwd_mat, *args))
    assert torch.equal(bwd, x)


@pytest.mark.parametrize("n", [1152, pytest.param(1536, marks=pytest.mark.slow)])
def test_factorized_large_degree(n):
    """tests/test_ntt3n_fact.py:37 on the port: the round trip, and the ring
    product mod X^N - X^{N/2} + 1 against a schoolbook big-int product."""
    moduli = tp.find_3n_rns_primes(n, 45, 2)
    ring = tr.new_ring(n, moduli, tr.MATRIX, device="cpu")
    assert ring.ntt3n is not None and ring.dense3n is None
    rng = np.random.default_rng(1)
    x = _t(_rand(rng, moduli, (), n))
    assert torch.equal(ring.intt(ring.ntt(x)), x)
    aa, bb = rng.integers(0, 100, n), rng.integers(0, 100, n)
    conv = np.zeros(2 * n - 1, dtype=object)
    for i in range(n):
        if aa[i]:
            conv[i:i + n] += int(aa[i]) * bb.astype(object)
    for d in range(2 * n - 2, n - 1, -1):
        c = conv[d]
        if c:
            conv[d] = 0
            conv[d - n // 2] += c  # X^N = X^{N/2} - 1
            conv[d - n] -= c
    want = np.stack([np.array([int(v) % q for v in conv[:n]], dtype=np.int64) for q in moduli])
    av = torch.from_numpy(np.stack([aa % q for q in moduli]).astype(np.int64))
    bv = torch.from_numpy(np.stack([bb % q for q in moduli]).astype(np.int64))
    prod = ring.mul_coeffs_montgomery(ring.mform(ring.ntt(av)), ring.ntt(bv))
    np.testing.assert_array_equal(ring.intt(prod).numpy(), want)


@pytest.mark.parametrize("n", [6, 12, 24, 48, 96])
def test_ntt_3n_matches_horner(n):
    """tests/test_ntt.py:88 on the port: the forward transform is the Horner
    evaluation at the totative points, the inverse returns x, and the
    pointwise product is the schoolbook product mod X^N - X^{N/2} + 1."""
    moduli = tp.find_3n_rns_primes(n, 28, 3)
    ring = tr.new_ring(n, moduli, tr.MATRIX, device="cpu")
    rng = np.random.default_rng(11)
    x = _rand(rng, moduli, (), n)
    got = ring.ntt(_t(x))
    for i, q in enumerate(moduli):
        omega, _ = tp.find_3n_primitive_root(q, 3 * n)
        want = oracle.ntt_3n_forward([int(v) for v in x[i]], q, omega)
        np.testing.assert_array_equal(got[i].numpy(), np.array(want, dtype=np.int64))
    assert torch.equal(ring.intt(got), _t(x))
    b = _rand(rng, moduli, (), n)
    prod = ring.intt(ring.mul_coeffs_montgomery(ring.mform(got), ring.ntt(_t(b))))
    for i, q in enumerate(moduli):
        want = oracle.matrix_ring_mul([int(v) for v in x[i]], [int(v) for v in b[i]], q)
        np.testing.assert_array_equal(prod[i].numpy(), np.array(want, dtype=np.int64))


@pytest.mark.parametrize("n", [48, 1152])
def test_automorphism_ntt_index_3n(n):
    els = [g for g in range(2, 3 * n) if math.gcd(g, 3 * n) == 1][:4] + [5, 3 * n - 1]
    for g in els:
        idx = tam.automorphism_ntt_index_3n(n, 3 * n, g)
        np.testing.assert_array_equal(idx, jam.automorphism_ntt_index_3n(n, 3 * n, g))
        np.testing.assert_array_equal(tam.ntt_index("matrix", n, 3 * n, g), idx)
    with pytest.raises(ValueError, match="coprime"):
        tam.automorphism_ntt_index_3n(n, 3 * n, 3)
    # in the NTT domain the gather is X -> X^g
    moduli = tp.find_3n_rns_primes(n, 40, 1)
    ring = tr.new_ring(n, moduli, tr.MATRIX, device="cpu")
    x = _t(_rand(np.random.default_rng(5), moduli, (), n))
    g = 5
    out = ring.intt(tam.automorphism_ntt(ring, ring.ntt(x), g))
    full = np.zeros(3 * n, dtype=object)
    for i, v in enumerate(x[0].tolist()):
        full[(i * g) % (3 * n)] += v
    for e in range(3 * n - 1, 3 * n // 2 - 1, -1):  # X^{3N/2} = -1
        full[e - 3 * n // 2] -= full[e]
    for e in range(3 * n // 2 - 1, n - 1, -1):      # X^N = X^{N/2} - 1
        full[e - n + n // 2] += full[e]
        full[e - n] -= full[e]
    np.testing.assert_array_equal(out[0].numpy(), [int(v) % moduli[0] for v in full[:n]])


def test_refused_sizes_and_moduli():
    with pytest.raises(ValueError, match="2\\^a"):
        tr.new_ring(10, tp.find_3n_rns_primes(12, 30, 1), tr.MATRIX, device="cpu")
    # a "61-bit" 3N prime lies above 2^61: the u64 path refuses it
    with pytest.raises(ValueError, match="2\\^61"):
        tr.new_ring(48, tp.find_3n_rns_primes(48, 61, 1), tr.MATRIX, device="cpu")
    q = next(q for q in tp.find_3n_rns_primes(24, 40, 8) if q % 144 != 1)
    with pytest.raises(ValueError, match="mod NthRoot"):
        tr.new_ring(48, [q], tr.MATRIX, device="cpu")

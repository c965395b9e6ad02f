"""PyTorch port, the u64 ring (ops/rings.py) and the automorphisms
(ops/automorphism.py): held bit-exact against the JAX package's Ring on the
same moduli and inputs (tests/test_ntt.py's cases): NTT and INTT at
logN 4-10 on fast primes (< 2^23) and on 45-61-bit primes, the elementwise
ring operations, and the NTT- and coefficient-domain automorphisms."""

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import automorphism as jam
from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.ops import rings as jr
from matrix_fhe_tpu.utils import primes as pr
from matrix_fhe_tpu_torch.ops import automorphism as tam
from matrix_fhe_tpu_torch.ops import rings as tr
from matrix_fhe_tpu_torch.ops.ntt_cuda import find_v2_primes


def _moduli(n, bits, k):
    if bits == 23:
        return find_v2_primes(n, k)
    g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
    # 61-bit chains go downstream, below 2^61, as GenModuli does
    return g.next_downstream_primes(k) if bits == 61 else g.next_alternating_primes(k)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=np.uint64).view(np.int64))


def _eq(got: torch.Tensor, want):
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _rand(rng, moduli, lead, n):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64) for q in moduli],
                    axis=-2)


def _rings(n, moduli):
    return jr.new_ring(n, moduli), tr.new_ring(n, moduli, device="cpu")


# JAX's ring NTT, jitted (eager, its u64 stages compile op by op for seconds)
_jax_ntt = jax.jit(jr._ntt_standard)
_jax_intt = jax.jit(jr._intt_standard)


@pytest.mark.parametrize("logn", range(4, 11))
def test_ntt_matches_jax(logn):
    """One ring a size, its limbs on fast primes and on 45-, 55- and 61-bit
    primes."""
    n = 1 << logn
    moduli = _moduli(n, 23, 2) + _moduli(n, 45, 1) + _moduli(n, 55, 1) + _moduli(n, 61, 2)
    jring, tring = _rings(n, moduli)
    for name in ("moduli", "qinv", "bhi", "blo", "ninv", "roots_fwd", "roots_bwd", "rescale"):
        _eq(getattr(tring, name), getattr(jring, name))
    x = _rand(np.random.default_rng(logn), moduli, (2,), n)
    f = tring.ntt(_t(x))
    _eq(f, _jax_ntt(jm.u64(x), jring.roots_fwd, jring.moduli, jring.qinv))
    _eq(tring.intt(_t(x)), _jax_intt(jm.u64(x), jring.roots_bwd, jring.ninv, jring.moduli,
                                     jring.qinv))
    assert torch.equal(tring.intt(f), _t(x))


def test_ntt_convolution_and_edge_cases():
    n = 32
    moduli = _moduli(n, 45, 2)
    ring = tr.new_ring(n, moduli, device="cpu")
    rng = np.random.default_rng(7)
    a, b = _rand(rng, moduli, (), n), _rand(rng, moduli, (), n)
    prod = ring.intt(ring.mul_coeffs_montgomery(ring.mform(ring.ntt(_t(a))), ring.ntt(_t(b))))
    for i, q in enumerate(moduli):
        want = [0] * n
        for j in range(n):
            for k in range(n):
                v = int(a[i, j]) * int(b[i, k])
                want[(j + k) % n] += v if j + k < n else -v
        np.testing.assert_array_equal(prod[i].numpy(), np.array([w % q for w in want]))
    zero = torch.zeros((1, 16), dtype=torch.int64)
    r16 = tr.new_ring(16, _moduli(16, 30, 1), device="cpu")
    assert torch.equal(r16.ntt(zero), zero) and torch.equal(r16.intt(zero), zero)
    one = zero.clone()
    one[0, 0] = 1
    assert torch.equal(r16.ntt(one), torch.ones_like(one))


def test_ring_ops_match_jax():
    n = 64
    moduli = _moduli(n, 61, 2) + _moduli(n, 45, 1)
    jring, tring = _rings(n, moduli)
    rng = np.random.default_rng(3)
    a, b, c = (_rand(rng, moduli, (), n) for _ in range(3))
    big = rng.integers(0, np.iinfo(np.uint64).max, (3, n), dtype=np.uint64)
    A, B, C = _t(a), _t(b), _t(c)
    sc = np.array([(7 << 64) % q for q in moduli], dtype=np.uint64)

    @jax.jit  # one compile for all of them
    def want(ja, jb, jc, jbig):
        r = jring
        return (r.add(ja, jb), r.sub(ja, jb), r.neg(ja), r.reduce(jbig), r.mform(ja),
                r.imform(ja), r.mul_coeffs_montgomery(ja, jb), r.mul_coeffs_barrett(ja, jb),
                r.mul_coeffs_montgomery_then_add(ja, jb, jc),
                r.mul_coeffs_montgomery_then_sub(ja, jb, jc),
                r.mul_scalar_montgomery(ja, jm.u64(sc)), r.add_scalar(ja, 12345),
                r.sub_scalar(ja, 12345))

    got = (tring.add(A, B), tring.sub(A, B), tring.neg(A), tring.reduce(_t(big)),
           tring.mform(A), tring.imform(A), tring.mul_coeffs_montgomery(A, B),
           tring.mul_coeffs_barrett(A, B), tring.mul_coeffs_montgomery_then_add(A, B, C),
           tring.mul_coeffs_montgomery_then_sub(A, B, C),
           tring.mul_scalar_montgomery(A, sc.astype(np.int64)), tring.add_scalar(A, 12345),
           tring.sub_scalar(A, 12345))
    for g, w in zip(got, want(jm.u64(a), jm.u64(b), jm.u64(c), jm.u64(big))):
        _eq(g, w)
    low = tring.at_level(1)
    assert low.moduli_tuple == tuple(moduli[:2]) and low.roots_fwd.shape == (2, n)
    assert torch.equal(low.ntt(A[:2]), tring.ntt(A)[:2])
    assert tring.modulus_at_level(1) == moduli[0] * moduli[1]
    with pytest.raises(ValueError):
        tring.at_level(3)


def test_automorphisms_match_jax():
    n = 64
    moduli = _moduli(n, 55, 2)
    jring, tring = _rings(n, moduli)
    x = _rand(np.random.default_rng(5), moduli, (), n)
    for g in (5, 25, 2 * n - 1, 3):
        _eq(tam.automorphism_ntt(tring, _t(x), g), jam.automorphism_ntt(jring, jm.u64(x), g))
        _eq(tam.automorphism_coeff(tring, _t(x), g), jam.automorphism_coeff(jring, jm.u64(x), g))
    for k in (0, 1, 5, n + 3, -2):
        _eq(tam.shift(_t(x), k), jam.shift(jm.u64(x), k))
        _eq(tam.mult_by_monomial(tring, _t(x), k), jam.mult_by_monomial(jring, jm.u64(x), k))


def test_new_ring_refuses_what_it_cannot_hold():
    n = 16
    q = _moduli(n, 30, 1)  # 1 mod 2N, but not mod the CI ring's 4N nor mod 3 * 24
    with pytest.raises(ValueError, match="NthRoot=64"):
        tr.new_ring(n, q, tr.CONJUGATE_INVARIANT, device="cpu")
    with pytest.raises(ValueError, match="NthRoot=72"):
        tr.new_ring(24, q, tr.MATRIX, device="cpu")
    with pytest.raises(ValueError, match="2\\^a"):
        tr.new_ring(10, q, tr.MATRIX, device="cpu")
    with pytest.raises(ValueError, match="unknown ring type"):
        tr.new_ring(n, q, "other", device="cpu")
    big = pr.NTTFriendlyPrimesGenerator(62, 2 * n).next_alternating_prime()
    with pytest.raises(ValueError, match="2\\^61"):
        tr.new_ring(n, [big], device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        tr.new_ring(n, _moduli(n, 30, 1) * 2, device="cpu")

"""PyTorch port, the u64 RNS tools (ops/rns_tools.py) and RNS scalars
(ops/scalar.py): held bit-exact against the JAX package on the same moduli
and inputs (tests/test_rns_tools.py's and tests/test_scalar.py's cases):
rescale by the last modulus (floor, round, NTT domain, several limbs),
ModUp, ModDown and the hybrid digit decomposition, and the scalar ops."""

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.ops import rings as jr
from matrix_fhe_tpu.ops import rns_tools as jrt
from matrix_fhe_tpu.ops import scalar as jsc
from matrix_fhe_tpu.utils import primes as pr
from matrix_fhe_tpu_torch.ops import rings as tr
from matrix_fhe_tpu_torch.ops import rns_tools as trt
from matrix_fhe_tpu_torch.ops import scalar as tsc

N = 16


def _primes(bits, k):
    return pr.NTTFriendlyPrimesGenerator(bits, 2 * N).next_alternating_primes(k)


def _rings(moduli):
    return jr.new_ring(N, moduli), tr.new_ring(N, moduli, device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=np.uint64).view(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _crt(rng, moduli, lead=()):
    """Limbs of random big integers below the product of ``moduli``."""
    Q = 1
    for q in moduli:
        Q *= q
    big = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % Q
           for _ in range(int(np.prod(lead, dtype=int)) * N)]
    limbs = np.array([[v % q for v in big] for q in moduli], dtype=np.uint64)
    return np.moveaxis(limbs.reshape((len(moduli),) + lead + (N,)), 0, -2)


def test_rescale_matches_jax():
    (jring, tring), rng = _rings(_primes(45, 3) + _primes(40, 2)), np.random.default_rng(0)
    x = _crt(rng, jring.moduli_tuple, (2,))

    @jax.jit
    def want(x):
        return (jrt.div_round_by_last_modulus(jring, x),
                jrt.div_floor_by_last_modulus(jring, x),
                jrt.div_round_by_last_modulus_ntt(jring, x),
                jrt.div_by_last_modulus_many(jring, x, 3, rounded=False),
                jrt.div_by_last_modulus_many(jring, x, 2, rounded=True),
                jrt.div_by_last_modulus_many(jring, x, 2, rounded=True, ntt=True),
                jrt.div_by_last_modulus_many(jring, x, 3, rounded=False, ntt=True))

    X = _t(x)
    got = (trt.div_round_by_last_modulus(tring, X), trt.div_floor_by_last_modulus(tring, X),
           trt.div_round_by_last_modulus_ntt(tring, X),
           trt.div_by_last_modulus_many(tring, X, 3, rounded=False),
           trt.div_by_last_modulus_many(tring, X, 2, rounded=True),
           trt.div_by_last_modulus_many(tring, X, 2, rounded=True, ntt=True),
           trt.div_by_last_modulus_many(tring, X, 3, rounded=False, ntt=True))
    for g, w in zip(got, want(jm.u64(x))):
        _eq(g, w)
    assert trt.div_by_last_modulus_many(tring, X, 0) is X


@pytest.mark.parametrize("centered", [True, False])
def test_mod_up_and_mod_down_match_jax(centered):
    Q, P = _primes(45, 3), _primes(50, 2)
    (jq, tq), (jp, tp) = _rings(Q), _rings(P)
    rng = np.random.default_rng(3)
    x = _crt(rng, Q, (2,))
    jmuc, tmuc = jrt.gen_modup_constants(Q, P), trt.gen_modup_constants(Q, P, "cpu")
    for name in ("qoverqi_inv_qi", "qoverqi_mod_p", "vtimesq_mod_p", "qhalf_mod_qi"):
        _eq(getattr(tmuc, name), getattr(jmuc, name))
    up = jax.jit(lambda x: jrt.mod_up(x, jmuc, jq, jp, centered=centered))
    _eq(trt.mod_up(_t(x), tmuc, tq, tp, centered=centered), up(jm.u64(x)))

    xqp = _crt(rng, Q + P, (2,))
    xq, xp = xqp[..., :3, :], xqp[..., 3:, :]
    jmdc, tmdc = jrt.gen_moddown_constants(Q, P), trt.gen_moddown_constants(Q, P, "cpu")
    _eq(tmdc.moddown_const, jmdc.moddown_const)
    down = jax.jit(lambda a, b: (jrt.mod_down(a, b, jmdc, jq, jp),
                                 jrt.mod_down(a, b, jmdc, jq, jp, ntt=True)))
    w, w_ntt = down(jm.u64(xq), jm.u64(xp))
    _eq(trt.mod_down(_t(xq), _t(xp), tmdc, tq, tp), w)
    _eq(trt.mod_down(_t(xq), _t(xp), tmdc, tq, tp, ntt=True), w_ntt)


@pytest.mark.parametrize("lq, lp", [(5, 2), (2, 1), (3, 0)])
def test_decompose_single_ntt_matches_jax(lq, lp):
    """Multi-limb digits (ModUp), single-limb digits, and P-less."""
    Q, P = _primes(45, lq), _primes(50, lp)
    jq, tq = _rings(Q)
    jp, tp = _rings(P) if P else (None, None)
    x = _crt(np.random.default_rng(5), Q)
    # the single-limb threshold: coeff == q >> 1 lifts negative
    x[0, 0] = Q[0] >> 1
    jdec, tdec = jrt.gen_decomposer(Q, P), trt.gen_decomposer(Q, P, "cpu")
    assert (tdec.alpha, tdec.num_digits) == (jdec.alpha, jdec.num_digits)
    x_ntt = tq.ntt(_t(x))

    @jax.jit
    def want(x):
        xn = jq.ntt(x)
        return [jrt.decompose_single_ntt(jdec, d, xn, x, jq, jp) for d in range(jdec.num_digits)]

    for d, (wq, wp) in enumerate(want(jm.u64(x))):
        yq, yp = trt.decompose_single_ntt(tdec, d, x_ntt, _t(x), tq, tp)
        _eq(yq, wq)
        if P:
            _eq(yp, wp)
        else:
            assert yp is None and wp is None


MODULI = [(1 << 45) - 91, (1 << 45) - 619, (1 << 46) - 1959]


def test_scalar_ops_match_jax():
    a_i, b_i = 0xdeadbeefcafebabe, 0x123456789abcdef
    a, b = tsc.from_bigint(MODULI, a_i), tsc.from_bigint(MODULI, b_i)
    np.testing.assert_array_equal(a, jsc.from_bigint(MODULI, a_i))
    for name in ("add", "sub", "mul"):
        np.testing.assert_array_equal(getattr(tsc, name)(MODULI, a, b),
                                      getattr(jsc, name)(MODULI, a, b))
    for name in ("neg", "inverse", "mform"):
        np.testing.assert_array_equal(getattr(tsc, name)(MODULI, a), getattr(jsc, name)(MODULI, a))
    assert tsc.to_bigint(MODULI, tsc.mul(MODULI, a, b)) == a_i * b_i
    np.testing.assert_array_equal(tsc.new_rns_scalar(MODULI, 7), jsc.new_rns_scalar(MODULI, 7))

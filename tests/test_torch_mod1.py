"""PyTorch port, the EvalMod circuit (circuits/ckks/mod1.py) on the u64 path:
tests/test_mod1.py's three cases at logN 6 on the JAX package's keys and
ciphertexts.  The host-side parameters (the Chebyshev or minimax
polynomial, its scaling, the arcsine polynomial) equal the JAX package's,
Decimal for Decimal; the circuit's output (normalization and EvalMod)
hashes to the JAX package's (``DIGESTS``, tools/port_circuit_digests.py)
and decodes to the scaled sine with tests/test_mod1.py's bound, 8 bits.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case, decode


def literals(m):
    """tests/test_mod1.py's three literals."""
    lit = m.mod1.ParametersLiteral
    return {
        "cos_continuous": lit(level_q=9, log_scale=60, mod1_type=m.mod1.COS_CONTINUOUS,
                              log_message_ratio=4, k=16, mod1_degree=46, double_angle=2),
        "sin_continuous_arcsine": lit(level_q=9, log_scale=60, mod1_type=m.mod1.SIN_CONTINUOUS,
                                      log_message_ratio=8, k=8, mod1_degree=63,
                                      mod1_inv_degree=7),
        "cos_discrete": lit(level_q=9, log_scale=60, mod1_type=m.mod1.COS_DISCRETE,
                            log_message_ratio=8, k=12, mod1_degree=30, double_angle=3),
    }


def _values(m1p, slots):
    """tests/test_mod1.py:_evaluate_mod1's input and plaintext model."""
    rng = np.random.default_rng(5)
    k = m1p.k - 1
    q = m1p.q_diff * m1p.message_ratio
    values = np.round(rng.uniform(-k, k, slots)) * q + rng.uniform(-1, 1, slots)
    values[0] = k * q + 0.5
    x = np.sin(2 * np.pi * (values / m1p.message_ratio / m1p.q_diff))
    return values, x


def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(55,) + (60,) * 10, logp=(61, 61), log_default_scale=45))
    ks, kr = jax.random.split(jax.random.key(0))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    enc = jckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    m1ps = {n: JAX.mod1.new_parameters_from_literal(params, lit)
            for n, lit in literals(JAX).items()}
    vals = {n: _values(m1p, params.max_slots) for n, m1p in m1ps.items()}
    cts = {n: encrypt(jax.random.key(3), sk, jax_encode(enc, params, v))
           for n, (v, _) in vals.items()}
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, enc=enc,
                           ev=jckks.Evaluator(params, rlk=rlk), m1ps=m1ps, vals=vals, cts=cts)


def _mod1(name):
    def run(m, c):
        """Scale to Delta = Q / message ratio, normalize to the Chebyshev
        variable (tests/test_mod1.py:140-152), EvalMod."""
        ev, m1p = c.ev, c.m1ps[name]
        ct = c.cts[name]
        scale = math.exp2(round(math.log2(c.params.q[0] / m1p.message_ratio)))
        ct = ev.scale_up(ct, round(scale / float(ct.scale)))
        ct = ev.scale_up(ct, round(float(m1p.scaling_factor) / float(ct.scale) / m1p.message_ratio))
        ct = ev.rescale(ev.mul_const(ct, 1.0 / (m1p.k * m1p.q_diff)))
        return m.mod1.Evaluator(ev, c.enc, m1p).evaluate(ct)
    return run


CASES = {name: _mod1(name) for name in ("cos_continuous", "sin_continuous_arcsine", "cos_discrete")}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "cos_continuous": "633d35f60447e88f3f191dcaeadfa55c8aa64912b984ad1c8f73344a9a02cb5e",
    "sin_continuous_arcsine": "ba87b5cb978d3177ccd2161b78e84f92a224278d1a2a4ac5d294d1c253c1eb18",
    "cos_discrete": "a38c5ce0e2044a9b1a3009b9873d6711700d9f150ea514dae90fd5bdfbc28e88",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    params = carry.carry(jctx.params, "cpu")
    t = carry.carry(dict(sk=jctx.sk, rlk=jctx.rlk, cts=jctx.cts), "cpu")
    m1ps = {n: PORT.mod1.new_parameters_from_literal(params, lit)
            for n, lit in literals(PORT).items()}
    return SimpleNamespace(params=params, sk=t["sk"], enc=PORT.ckks.Encoder(params),
                           ev=PORT.ckks.Evaluator(params, rlk=t["rlk"]), m1ps=m1ps,
                           vals=jctx.vals, cts=t["cts"])


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_match_jax(jctx, ctx, name):
    got, want = ctx.m1ps[name], jctx.m1ps[name]
    for f in ("level_q", "log_default_scale", "mod1_type", "log_message_ratio", "double_angle",
              "q_diff", "sqrt_2pi", "k"):
        assert getattr(got, f) == getattr(want, f), f
    for p, w in ((got.mod1_poly, want.mod1_poly), (got.mod1_inv_poly, want.mod1_inv_poly)):
        if w is None:
            assert p is None
            continue
        assert (p.basis, p.coeffs, p.is_odd, p.is_even) == (w.basis, w.coeffs, w.is_odd, w.is_even)
        if w.interval is not None:
            assert (p.interval.a, p.interval.b) == (w.interval.a, w.interval.b)


@pytest.mark.parametrize("name", list(CASES))
def test_eval_mod(ctx, name):
    out = check_case(CASES, DIGESTS, name, ctx)
    m1p = ctx.m1ps[name]
    values, x = ctx.vals[name]
    if m1p.mod1_inv_poly is not None:
        x = np.arcsin(x)
    want = x * m1p.message_ratio * m1p.q_diff / (2 * np.pi)
    got = np.real(decode(ctx, out))
    PORT.ckks.precision.assert_precision(want, got, 8)

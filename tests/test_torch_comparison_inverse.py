"""PyTorch port, the minimax comparison and inverse circuits
(circuits/ckks/minimax.py, comparison.py, inverse.py).

tests/test_comparison_inverse.py's six cases on its chain (logN 6, 60 +
45x18-bit Q, 61x2-bit P, scale 2^45), JAX's keys and ciphertexts carried
over: the sign polynomial on plain values, then sign, step, max/min,
Goldschmidt division and the inverse over the positive domain, each on the
port's u64 evaluator and on its wide evaluator (``fast/weval.py``) over the
same keys.  Each circuit runs over a namespace of modules: the port's
output hashes to the JAX package's u64 evaluator's on the same inputs
(``DIGESTS``, tools/port_circuit_digests.py), on both evaluators, and its
decoding keeps the JAX test's own bounds (0.1, 0.1, 0.05, atol 1e-4,
rtol/atol 0.01).  The sign polynomial's coefficients equal the JAX
package's.
"""

import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case

# The circuits' scales are Fractions over products of many primes; the
# digest writes them out in decimal, past Python's default 4300 digits.
sys.set_int_max_str_digits(0)


def _sign_values(slots, rng):
    v = rng.uniform(1 / 16, 1, slots)
    return v * rng.choice([-1.0, 1.0], slots)


def _inputs(slots):
    """tests/test_comparison_inverse.py's values: {name: (values, key)}."""
    out = {"sign": (_sign_values(slots, np.random.default_rng(1)), 2),
           "step": (_sign_values(slots, np.random.default_rng(2)), 3)}
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-0.5, 0.5, slots), rng.uniform(-0.5, 0.5, slots)
    mask = np.abs(a - b) < 1 / 16  # keep |a-b| >= 2^-4, within the sign's precision
    b[mask] = a[mask] + 1 / 8
    out.update({"max a": (a, 4), "max b": (b, 5), "min a": (a, 6), "min b": (b, 7)})
    out["goldschmidt"] = (np.random.default_rng(4).uniform(0.25, 1.75, slots), 8)
    out["inverse"] = (np.random.default_rng(5).uniform(0.3, 3.0, slots), 9)
    return out


def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(60,) + (45,) * 18, logp=(61, 61), log_default_scale=45))
    ks, kr, kg = jax.random.split(jax.random.key(0), 3)
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gks = JK.gen_galois_keys(kg, params, sk, [params.galois_element_inverse()])
    enc = jckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    vals = _inputs(params.max_slots)
    cts = {name: encrypt(jax.random.key(key), sk, jax_encode(enc, params, v))
           for name, (v, key) in vals.items()}
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, gks=gks, cts=cts,
                           ev=JAX.ckks.Evaluator(params, rlk=rlk, galois_keys=gks))


def _mm(m, c):
    """The minimax evaluator over ``c.ev`` and the sign polynomial, made once."""
    if "mm" not in c.__dict__:
        c.mm = m.minimax.Evaluator(c.ev, m.ckks.Encoder(c.params))
        c.sign_poly = m.minimax.gen_minimax_composite_polynomial(4, 20, [7, 7])
    return c.mm


def _cmp(m, c):
    return m.comparison.Evaluator(_mm(m, c), c.sign_poly)


CASES = {
    "sign": lambda m, c: _cmp(m, c).sign(c.cts["sign"]),
    "step": lambda m, c: _cmp(m, c).step(c.cts["step"]),
    "max_min": lambda m, c: [_cmp(m, c).max(c.cts["max a"], c.cts["max b"]),
                             _cmp(m, c).min(c.cts["min a"], c.cts["min b"])],
    "goldschmidt_division": lambda m, c: m.inverse.Evaluator(_mm(m, c)).goldschmidt_division(
        c.cts["goldschmidt"], -2.0),
    "inverse_positive_domain": lambda m, c: m.inverse.Evaluator(
        _mm(m, c)).evaluate_positive_domain(c.cts["inverse"], -2.0, 2.0),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES (its u64
# evaluator)
DIGESTS = {
    "sign": "f269d2076ddfeca11e04f1f9d259f6753036b2e4feab7b4296bf7f79f596a26f",
    "step": "536da04c231bbfff5c835829c700d1d382823e756d1b4fee19fd8263d7b84ddf",
    "max_min": "e1c71856fa7c2c6403980b511f7bdb0876762274a2de703590bafd0bc5c02d50",
    "goldschmidt_division": "7bdc88c85318e5bf3e732e6a4782647e5a9c8555dc122a152583bbd23e9d6fd0",
    "inverse_positive_domain": "01585e25a0ed844d897c456920ef6fed2321e55eca48784f0ee76b57f3da0199",
}


@pytest.fixture(scope="module")
def keys():
    j = jax_context()
    return SimpleNamespace(**carry.carry(dict(params=j.params, sk=j.sk, rlk=j.rlk, gks=j.gks,
                                              cts=j.cts), "cpu"))


@pytest.fixture(scope="module", params=["u64", "wide"])
def ctx(request, keys):
    """The port's u64 evaluator, or its wide evaluator, on the same keys."""
    k = keys
    if request.param == "u64":
        ev = PORT.ckks.Evaluator(k.params, rlk=k.rlk, galois_keys=k.gks)
        cts = k.cts
    else:
        ev = PORT.weval.make_wide_evaluator(k.params, k.rlk, k.gks)
        cts = {name: PORT.weval.ct_to_wide(ct) for name, ct in k.cts.items()}
    return SimpleNamespace(params=k.params, sk=k.sk, ev=ev, cts=cts)


def _dec(c, ct):
    enc = PORT.ckks.Encoder(c.params)
    return np.real(enc.decode(PORT.dec.decrypt(c.params, c.sk, ct)))


def test_sign_poly_plain():
    sign_poly = PORT.minimax.gen_minimax_composite_polynomial(4, 20, [7, 7])
    want = JAX.minimax.gen_minimax_composite_polynomial(4, 20, [7, 7])
    assert [p.coeffs for p in sign_poly] == [p.coeffs for p in want]
    xs = np.linspace(1 / 16, 1, 50)
    for x in np.concatenate([xs, -xs]):
        y = x
        for p in sign_poly:
            y = p.evaluate(y).real
        assert abs(y - np.sign(x)) < 0.05, (x, y)


def test_sign(ctx):
    v = _inputs(ctx.params.max_slots)["sign"][0]
    got = _dec(ctx, check_case(CASES, DIGESTS, "sign", ctx))
    assert np.max(np.abs(got - np.sign(v))) < 0.1


def test_step(ctx):
    v = _inputs(ctx.params.max_slots)["step"][0]
    got = _dec(ctx, check_case(CASES, DIGESTS, "step", ctx))
    assert np.max(np.abs(got - (np.sign(v) + 1) / 2)) < 0.1


def test_max_min(ctx):
    vals = _inputs(ctx.params.max_slots)
    a, b = vals["max a"][0], vals["max b"][0]
    got_max, got_min = (_dec(ctx, ct) for ct in check_case(CASES, DIGESTS, "max_min", ctx))
    assert np.max(np.abs(got_max - np.maximum(a, b))) < 0.05
    assert np.max(np.abs(got_min - np.minimum(a, b))) < 0.05


def test_goldschmidt_division(ctx):
    v = _inputs(ctx.params.max_slots)["goldschmidt"][0]
    got = _dec(ctx, check_case(CASES, DIGESTS, "goldschmidt_division", ctx))
    np.testing.assert_allclose(got, 1 / v, atol=1e-4)


def test_inverse_positive_domain(ctx):
    v = _inputs(ctx.params.max_slots)["inverse"][0]
    got = _dec(ctx, check_case(CASES, DIGESTS, "inverse_positive_domain", ctx))
    np.testing.assert_allclose(got, 1 / v, rtol=0.01, atol=0.01)

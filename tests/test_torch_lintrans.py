"""PyTorch port, the linear-transformation circuits (circuits/lintrans.py,
circuits/ckks/lintrans.py) and the u64 ``Evaluator.evaluate_lintrans``:
tests/test_lintrans.py's cases at logN 7 on the JAX package's keys and
ciphertexts.  Each case's encoded diagonals and rescaled output hash to the
JAX package's (``DIGESTS``, tools/port_circuit_digests.py) and decode to the
plaintext model with tests/test_lintrans.py's bounds; the BSGS split and the
galois elements equal the JAX package's.
"""

from fractions import Fraction
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
from test_torch_rlwe import eq

# name: (log_bsgs_ratio, diagonals, seed) of tests/test_lintrans.py
DIAG_CASES = {"naive": (-1, [0, 1, 2, 3], 1), "naive_no_zero_diag": (-1, [1, 5, -2], 2),
              "bsgs": (0, [-15, -4, -1, 0, 1, 2, 3, 4, 15], 3),
              "bsgs_ratio2": (2, list(range(-8, 9)), 4)}
TRACE_LOG_N = 3


def _diag_inputs(slots, diag_idx, seed):
    rng = np.random.default_rng(seed)
    diags = {k: rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for k in diag_idx}
    return diags, rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)


def _permutation_inputs(slots):
    rng = np.random.default_rng(9)
    perm = rng.permutation(slots)
    scalings = rng.uniform(-1, 1, slots)
    v = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    return perm, scalings, v


def _permutation_diags(m, perm, scalings):
    maps = [m.ckks_lt.PermutationMapping(from_idx=int(perm[i]), scaling=complex(scalings[i]))
            for i in range(len(perm))]
    return m.ckks_lt.permutation_diagonals(maps, len(perm))


def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45, 45), logp=(60,), log_default_scale=45))
    ks, kr = jax.random.split(jax.random.key(0))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    enc = jckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    slots = params.max_slots
    c = SimpleNamespace(params=params, sk=sk, rlk=rlk, enc=enc, inputs={}, gks={}, cts={})
    for name, (ratio, idx, seed) in DIAG_CASES.items():
        diags, v = _diag_inputs(slots, idx, seed)
        c.inputs[name] = (diags, v)
        els = JAX.lt.galois_elements(params, list(diags), slots, ratio)
        c.gks[name] = JK.gen_galois_keys(jax.random.key(7), params, sk, els)
        c.cts[name] = encrypt(jax.random.key(3), sk, jax_encode(enc, params, v))
    perm, scalings, v = _permutation_inputs(slots)
    c.inputs["permutation"] = (perm, scalings, v)
    diags = _permutation_diags(JAX, perm, scalings)
    c.gks["permutation"] = JK.gen_galois_keys(
        jax.random.key(8), params, sk, JAX.lt.galois_elements(params, list(diags), slots, 1))
    c.cts["permutation"] = encrypt(jax.random.key(4), sk, jax_encode(enc, params, v))
    rng = np.random.default_rng(10)
    c.gks["trace"] = JK.gen_galois_keys(
        jax.random.key(11), params, sk, JAX.rlwe_eval.galois_elements_for_trace(params, TRACE_LOG_N))
    v = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    c.inputs["trace"] = v
    c.cts["trace"] = encrypt(jax.random.key(12), sk, jax_encode(enc, params, v))
    return c


def _transform(m, c, diags, ratio):
    ltp = m.lt.LinearTransformationParameters(
        diagonals_index_list=list(diags.keys()), level_q=c.params.max_level,
        level_p=c.params.max_level_p, scale=c.params.default_scale,
        log_dimensions=(0, c.params.log_max_slots), log_bsgs_ratio=ratio)
    return m.ckks_lt.new_linear_transformation(m.ckks.Encoder(c.params), diags, ltp)


def _run(m, c, name, diags, ratio):
    """The encoded diagonals (in key order) and the rescaled output."""
    t = _transform(m, c, diags, ratio)
    out = m.ckks.Evaluator(c.params).rescale(m.lt.evaluate(c.params, c.cts[name], t, c.gks[name]))
    return [t.vec[k] for k in sorted(t.vec)], out


def _diag_case(name):
    return lambda m, c: _run(m, c, name, c.inputs[name][0], DIAG_CASES[name][0])


CASES = {name: _diag_case(name) for name in DIAG_CASES}
CASES["permutation"] = lambda m, c: _run(
    m, c, "permutation", _permutation_diags(m, *c.inputs["permutation"][:2]), 1)
CASES["trace"] = lambda m, c: m.rlwe_eval.trace(c.params, c.cts["trace"], TRACE_LOG_N,
                                                c.gks["trace"])

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "naive": "f8dd836395dc74fe0db8d3b6999fb3cdcf83c55e82ca82da26e53e1081e39f7a",
    "naive_no_zero_diag": "09196b1a31404c55576656a486e64a6480849654a975fff8b46daac371cdf9eb",
    "bsgs": "e5b7b202bb14784976788004148fd23af34a631b8a2f061569f25f70d928d135",
    "bsgs_ratio2": "a95596085f445499daaf08f569359608754b1abbd60f7e37d04076e9efa7aa72",
    "permutation": "81ffd3ffadae0303000c320c2f54f23352e976fb921e239abf8758329809c9db",
    "trace": "64aa116d8811e65ee1654906871665d4d8c54a1fe4154d07526045d3e4f22f70",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    params = carry.carry(jctx.params, "cpu")
    t = carry.carry(dict(sk=jctx.sk, rlk=jctx.rlk, gks=jctx.gks, cts=jctx.cts), "cpu")
    return SimpleNamespace(params=params, sk=t["sk"], rlk=t["rlk"], gks=t["gks"],
                           cts=t["cts"], enc=PORT.ckks.Encoder(params), inputs=jctx.inputs)


def _model(diags, v):
    slots = len(v)
    out = np.zeros(slots, dtype=np.complex128)
    for k, d in diags.items():
        out += np.asarray(d) * np.roll(v, -(k % slots))
    return out


@pytest.mark.parametrize("name, bits", [("naive", 17), ("naive_no_zero_diag", 17),
                                        ("bsgs", 17), ("bsgs_ratio2", 17)])
def test_lintrans(ctx, name, bits):
    _, out = check_case(CASES, DIGESTS, name, ctx)
    diags, v = ctx.inputs[name]
    PORT.ckks.precision.assert_precision(_model(diags, v), decode(ctx, out), bits)


def test_permutation(ctx):
    _, out = check_case(CASES, DIGESTS, "permutation", ctx)
    perm, scalings, v = ctx.inputs["permutation"]
    PORT.ckks.precision.assert_precision(scalings * v[perm], decode(ctx, out), 15)


def test_trace(ctx):
    out = check_case(CASES, DIGESTS, "trace", ctx)
    v = ctx.inputs["trace"]
    m = 1 << TRACE_LOG_N
    want = sum(np.roll(v, -j * m) for j in range(len(v) // m))
    want /= 1 << (ctx.params.log_n - TRACE_LOG_N - 1)
    PORT.ckks.precision.assert_precision(want, decode(ctx, out), 12)


@pytest.mark.parametrize("name", ["naive", "bsgs"])
def test_evaluator_evaluate_lintrans(ctx, name):
    """The u64 ``Evaluator.evaluate_lintrans`` is ``lt.evaluate`` with the
    evaluator's galois keys (or the ones passed), scale included."""
    diags, _ = ctx.inputs[name]
    ratio = DIAG_CASES[name][0]
    t = _transform(PORT, ctx, diags, ratio)
    ct = ctx.cts[name]
    want = PORT.lt.evaluate(ctx.params, ct, t, ctx.gks[name])
    assert want.scale == ct.scale * Fraction(ctx.params.default_scale)
    eq(PORT.ckks.Evaluator(ctx.params, galois_keys=ctx.gks[name]).evaluate_lintrans(ct, t), want)
    eq(PORT.ckks.Evaluator(ctx.params).evaluate_lintrans(ct, t, ctx.gks[name]), want)


@pytest.mark.parametrize("ratio", [-1, 0, 1, 2])
def test_bsgs_split_matches_jax(ctx, ratio):
    """find_best_bsgs_ratio, bsgs_index and galois_elements (host side)."""
    slots = ctx.params.max_slots
    jparams = SimpleNamespace(galois_element=ctx.params.galois_element)
    for idx in ([0, 1, 2, 3], [-15, -4, -1, 0, 1, 2, 3, 4, 15], list(range(-8, 9)),
                list(range(0, slots, 3))):
        def split(m):
            n1 = m.lt.find_best_bsgs_ratio(idx, slots, max(ratio, 0))
            return n1, m.lt.bsgs_index(idx, slots, n1), m.lt.galois_elements(
                jparams, idx, slots, ratio)
        assert split(PORT) == split(JAX)

"""PyTorch port, the wide evaluator (fast/weval.py) at logN 6.

tests/test_weval.py's eight cases on the same chain (55 + 45x5-bit Q,
55x2-bit P), JAX's keys and ciphertexts carried over, and the same extra
keys: the encoder, the linear and scalar ops, mul_relin + rescale +
set_scale, the automorphisms and hoisted rotations, trace and mod_raise,
apply_evaluation_key, and the BSGS and naive linear transformations.  Each
case runs over a namespace of modules (``JAX`` or ``PORT``): its outputs,
as words (``wide.unpack_pair`` of the JAX package's pairs), hash to the
digest of the JAX package's wide evaluator on the same inputs
(``DIGESTS``, pinned by ``tools/port_circuit_digests.py``), and equal the
port's u64 evaluator's outputs on the same keys limb for limb, as
tests/test_weval.py holds the JAX wide evaluator to its u64 one.
"""

import dataclasses
from fractions import Fraction
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu.utils import primes as jpr
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case
from test_torch_rlwe import eq

LOGN = 6


def _lintrans_diags(slots, seed, keys):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(slots) for k in keys}


def jax_context():
    """tests/test_weval.py's parameters, keys and ciphertexts, from its
    seeds; the extra galois keys and the evaluation key of its trace,
    lintrans and evaluation-key cases."""
    n = 1 << LOGN
    g55 = jpr.NTTFriendlyPrimesGenerator(55, 2 * n)
    g45 = jpr.NTTFriendlyPrimesGenerator(45, 2 * n)
    Q = [g55.next_alternating_prime()] + g45.next_alternating_primes(5)
    P = g55.next_alternating_primes(2)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=LOGN, q=tuple(Q), p=tuple(P), log_default_scale=45))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    rlk = JK.gen_relinearization_key(jax.random.key(1), params, sk)
    gal_els = [params.galois_element(1), params.galois_element(2), params.galois_element(4),
               params.galois_element(-1), params.galois_element_inverse()]
    gks = JK.gen_galois_keys(jax.random.key(2), params, sk, gal_els)
    enc = jckks.Encoder(params)
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(params.max_slots) + 1j * rng.standard_normal(params.max_slots)
            for _ in range(2)]
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    cts = [encrypt(jax.random.key(10 + i), sk, jax_encode(enc, params, v))
           for i, v in enumerate(vals)]
    from matrix_fhe_tpu.circuits import lintrans as jlt
    slots = params.max_slots
    trace_els = [params.galois_element(1 << i) for i in range(3, params.log_n - 1)]
    sk2 = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(20))
    evk = JK.gen_evaluation_key(jax.random.key(21), params, sk.value.q, sk2)
    keys = {"": gks, "trace": {**gks, **JK.gen_galois_keys(jax.random.key(3), params, sk,
                                                           trace_els)}}
    for name, key, ratio, dk in (("lintrans", 4, 1, (0, 1, slots - 1)),
                                 ("naive", 6, -1, (0, 2, slots - 2))):
        els = jlt.galois_elements(params, list(dk), slots, ratio)
        keys[name] = {**gks, **JK.gen_galois_keys(jax.random.key(key), params, sk, els)}
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, keys=keys, cts=cts, evk=evk)


def _wide(m, c, keys=""):
    """The wide evaluator over the context's galois keys ``keys``, made once."""
    cache = c.__dict__.setdefault("wide_evs", {})
    if keys not in cache:
        cache[keys] = m.weval.make_wide_evaluator(c.params, c.rlk, c.keys[keys])
    return cache[keys]


def _lintrans(m, c, ct, seed, keys, ratio):
    slots = c.params.max_slots
    diags = _lintrans_diags(slots, seed, keys)
    ltp = m.lt.LinearTransformationParameters(
        diagonals_index_list=list(diags), level_q=ct.level, level_p=c.params.max_level_p,
        scale=Fraction(c.params.q[ct.level]), log_dimensions=(0, c.params.log_max_slots),
        log_bsgs_ratio=ratio)
    return m.lt.encode(m.ckks.Encoder(c.params).embed_qp, diags, ltp)


# name -> fn(m, ev, enc, c, (a, b)) -> outputs; ``ev``/``enc`` the wide
# evaluator and encoder or the u64 ones, (a, b) their ciphertexts
OPLISTS = {
    "encode": lambda m, ev, enc, c, ab: [enc.encode(np.arange(c.params.max_slots) / 7.0)],
    "linear_and_scalar_ops": lambda m, ev, enc, c, ab: [
        ev.add(*ab), ev.sub(*ab), ev.neg(ab[0]), ev.add_const(ab[0], 1.25 - 0.5j),
        ev.sub_const(ab[0], 0.75), ev.mul_const(ab[0], 1.5),
        ev.mul_const_complex(ab[0], 0.3 + 0.1j), ev.scale_up(ab[0], 9),
        ev.add_plain(ab[0], enc.encode(np.ones(c.params.max_slots) * 0.5)),
        ev.mul_plain(ab[0], enc.encode(np.ones(c.params.max_slots) * 0.5))],
    "mul_relin_rescale": lambda m, ev, enc, c, ab: (lambda p: [
        p, ev.rescale(p), ev.set_scale(p, c.params.default_scale)])(ev.mul_relin(*ab)),
    "automorphisms": lambda m, ev, enc, c, ab: [
        ev.rotate(ab[0], 2), ev.conjugate(ab[0]),
        *ev.rotate_hoisted(ab[0], [0, 1, 4]).values()],
    "trace_and_mod_raise": lambda m, ev, enc, c, ab: [
        ev.trace_log_n(ab[0], 3), ev.mod_raise(ev._drop_level(ab[0], 0))],
    "apply_evaluation_key": lambda m, ev, enc, c, ab: [ev.apply_evaluation_key(ab[0], c.evk)],
    "evaluate_lintrans": lambda m, ev, enc, c, ab: [ev.evaluate_lintrans(
        ab[0], _lintrans(m, c, ab[0], 3, (0, 1, c.params.max_slots - 1), 1))],
    "evaluate_lintrans_naive": lambda m, ev, enc, c, ab: [ev.evaluate_lintrans(
        ab[0], _lintrans(m, c, ab[0], 5, (0, 2, c.params.max_slots - 2), -1))],
}
KEYS = {"trace_and_mod_raise": "trace", "evaluate_lintrans": "lintrans",
        "evaluate_lintrans_naive": "naive"}


def words(m, c, x):
    """A wide ciphertext or plaintext as words in the package of ``m``
    (the JAX package's pairs unpacked; the port's as they are)."""
    if m is not JAX:
        return x
    if hasattr(x, "degree"):
        return m.weval.ct_to_u64(x, c.params)
    lq = np.asarray(x.value).shape[-2]
    pair31 = m.wide.use_pair31(list(c.params.q) + list(c.params.p))
    return dataclasses.replace(
        x, value=m.wide.unpack_pair(np.asarray(x.value), c.params.q[:lq], pair31))


def run(m, c, name, wide=True):
    """Case ``name`` on the wide evaluator (words out) or the u64 one."""
    keys = KEYS.get(name, "")
    if wide:
        ev, enc = _wide(m, c, keys), m.weval.WideEncoder(c.params)
        ab = [m.weval.ct_to_wide(ct, c.params) for ct in c.cts]
    else:
        ev = m.ckks.Evaluator(c.params, rlk=c.rlk, galois_keys=c.keys[keys])
        enc, ab = m.ckks.Encoder(c.params), c.cts
    out = OPLISTS[name](m, ev, enc, c, ab)
    return [words(m, c, o) for o in out] if wide else out


CASES = {name: (lambda m, c, name=name: run(m, c, name)) for name in OPLISTS}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "encode": "ec9924f16ec91a21b3a182294ecc809818a95ace14512ce9161546a548317291",
    "linear_and_scalar_ops": "69a860b7a2bf21a4d4757c6454a446ae12cd1c7d3d0b7745a03007639322cb6b",
    "mul_relin_rescale": "4136ecc4ca1850e8505369d1748a1894a5433cd57feb1c6fb01a6d86a21d2bee",
    "automorphisms": "49f89ac48022a475900d78c778445a6423b930588aceb9d1ef2622994e8f7962",
    "trace_and_mod_raise": "5c7a362200018fc7c3c9797a1092ebf4aa7415622577b397e594e6d044e064d2",
    "apply_evaluation_key": "fd447df2cef271a0faf411fdfaa6bea909adcc12c1c5d8693a05e172b782b3a6",
    "evaluate_lintrans": "935e1edc88b0b2fea25812b2c8991517ea9d7bce2fea286f2527894804d6eedc",
    "evaluate_lintrans_naive": "469360a21c86978258831f780b3559fa6168b9824dec7fd41af30f588b83f4a1",
}


@pytest.fixture(scope="module")
def ctx():
    j = jax_context()
    c = carry.carry(dict(params=j.params, sk=j.sk, rlk=j.rlk, keys=j.keys, cts=j.cts,
                         evk=j.evk), "cpu")
    return SimpleNamespace(**c)


@pytest.mark.parametrize("name", list(OPLISTS))
def test_wide_evaluator(ctx, name):
    got = check_case(CASES, DIGESTS, name, ctx)
    eq(got, run(PORT, ctx, name, wide=False))

"""PyTorch port, CKKS (schemes/ckks: params, encoder, evaluator, precision):
held bit-exact against the JAX package at logN 7 (tests/test_ckks.py's
parameters, the standard ring) and at logN 5 for the PREC128 embedding.

The encoder's limbs and its decoded float64 values equal JAX's exactly (the
same numpy code runs on equal limbs).  JAX's keys and ciphertexts, carried
over, drive the port's evaluator; every operation's output equals JAX's.
"""

import dataclasses
from fractions import Fraction

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.ops import rings as jr
from matrix_fhe_tpu.rlwe import decryptor as jdec
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.circuits import lintrans as tlt
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from test_torch_rlwe import eq, jax_sk_sample

ROTS = (1, 5)
TRACE_LOG_N = 4  # trace_log_n onto 2^4 slots: the keys of 5^16 and 5^32


def jax_encode(enc, params, values, **kw):
    """JAX's encode with its NTT jitted (eager, the u64 stages compile op by
    op): the same limbs as ``enc.encode(values)``."""
    pt = enc.encode(values, is_ntt=False, **kw)
    level = pt.level
    value = jax.jit(jr.Ring.ntt)(params.ring_q.at_level(level), pt.value)
    return dataclasses.replace(pt, value=value,
                               metadata=dataclasses.replace(pt.metadata, is_ntt=True))


def jax_decode(enc, params, pt):
    coeffs = jax.jit(jr.Ring.intt)(params.ring_q.at_level(pt.level), pt.value)
    return enc.decode(dataclasses.replace(
        pt, value=coeffs, metadata=dataclasses.replace(pt.metadata, is_ntt=False)))


@pytest.fixture(scope="module")
def ctx():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45, 45, 45), logp=(60,), log_default_scale=45))
    ks, kr, kg = jax.random.split(jax.random.key(0), 3)
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gels = [params.galois_element(k) for k in ROTS] + [params.galois_element_inverse()] + [
        params.galois_element(1 << i) for i in range(TRACE_LOG_N, params.log_n - 1)]
    gks = JK.gen_galois_keys(kg, params, sk, gels)
    enc = jckks.Encoder(params)
    rng = np.random.default_rng(3)
    vals = [rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
            for _ in range(3)]
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    pts = [jax_encode(enc, params, v) for v in vals]
    cts = [encrypt(jax.random.key(10 + i), sk, pt) for i, pt in enumerate(pts)]
    tparams = carry.carry(params, "cpu")
    return dict(params=params, sk=sk, rlk=rlk, gks=gks, enc=enc, vals=vals, pts=pts,
                cts=cts, tparams=tparams, tenc=tckks.Encoder(tparams),
                t=carry.carry(dict(sk=sk, rlk=rlk, gks=gks, pts=pts, cts=cts), "cpu"))


def test_encoder_matches_jax(ctx):
    params, enc, tenc_ = ctx["params"], ctx["enc"], ctx["tenc"]
    for v, pt in zip(ctx["vals"], ctx["pts"]):
        got = tenc_.encode(v)
        eq(got, pt)
        # decode: the same numpy code on equal limbs, equal float64
        np.testing.assert_array_equal(tenc_.decode(got), jax_decode(enc, params, pt))
    low = tenc_.encode(ctx["vals"][0], level=1, scale=1 << 30)
    eq(low, jax_encode(enc, params, ctx["vals"][0], level=1, scale=1 << 30))
    eq(tenc_.embed_qp(ctx["vals"][1], 2, 0), jax.jit(lambda: enc.embed_qp(ctx["vals"][1], 2, 0))())
    tckks.precision.assert_precision(ctx["vals"][0], tenc_.decode(tenc_.encode(ctx["vals"][0])), 30)


def test_encode_prec128_matches_jax():
    """The Decimal embedding (scales above 2^50), tests/test_ckks.py:152."""
    lit = dict(logn=5, logq=(60, 55, 55), logp=(61,), log_default_scale=80)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(**lit))
    tparams = tckks.new_parameters(tckks.CKKSParametersLiteral(**lit), device="cpu")
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    enc, tenc_ = jckks.Encoder(params), tckks.Encoder(tparams)
    want = jax_encode(enc, params, v)
    got = tenc_.encode(v)
    assert got.metadata.scale == 1 << 80
    eq(got, want)
    np.testing.assert_array_equal(tenc_.decode(got), jax_decode(enc, params, want))
    tckks.precision.assert_precision(v, tenc_.decode(got), 40)


def test_encrypt_from_jax_samples(ctx):
    params, t = ctx["params"], ctx["t"]
    key = jax.random.key(10)
    got = tenc.encrypt_from_sample(ctx["tparams"], t["sk"], t["pts"][0],
                                   jax_sk_sample(key, params, params.max_level))
    eq(got, ctx["cts"][0])
    dec = ctx["tenc"].decode(tdec.decrypt(ctx["tparams"], t["sk"], got))
    np.testing.assert_array_equal(
        dec, jax_decode(ctx["enc"], params, jdec.decrypt(params, ctx["sk"], ctx["cts"][0])))
    tckks.precision.assert_precision(ctx["vals"][0], dec, 25)


def _ops(ev, a, b, c, pt):
    """The evaluator operations held against JAX, on ciphertexts a, b, c
    and plaintext pt: one list, for one JAX compile."""
    prod = ev.mul_relin(a, b)
    res = ev.mul_relin(c, b)
    hoisted = ev.rotate_hoisted(a, list(ROTS))
    return [
        ev.add(a, b), ev.sub(a, b), ev.add(a, pt), ev.sub(a, pt), ev.neg(a),
        prod, ev.rescale(prod), ev.rescale(ev.mul(a, b)), ev.mul_plain(a, pt),
        ev.rescale(ev.mul_const(a, 1.5)), ev._mul_integer(a, 3), ev.scale_up(a, 9),
        ev.add_const(a, 1.25 - 0.5j), ev.sub_const(a, 0.75),
        ev.mul_const_complex(a, 0.3 + 0.1j),
        ev.rotate(a, 1), ev.conjugate(a), hoisted[1], hoisted[5],
        ev.add(ev.drop_level(a, 1), b),  # levels and scales matched
        ev.mul_relin_then_add(a, b, res), ev.mul_then_add(a, b, res),
        ev.mul_const_then_add(a, 0.5 + 0.0j, res),
        ev.trace_log_n(a, TRACE_LOG_N), ev.mod_raise(ev._drop_level(a, 0)),
    ]


def test_evaluator_matches_jax(ctx):
    params, t = ctx["params"], ctx["t"]
    jev = jckks.Evaluator(params, rlk=ctx["rlk"], galois_keys=ctx["gks"])
    tev = tckks.Evaluator(ctx["tparams"], rlk=t["rlk"], galois_keys=t["gks"])
    a, b, c = ctx["cts"]
    want = jax.jit(lambda a, b, c, pt: _ops(jev, a, b, c, pt))(a, b, c, ctx["pts"][1])
    got = _ops(tev, *t["cts"], t["pts"][1])
    for g, w in zip(got, want):
        eq(g, w)
    # and they decrypt: the product, rescaled
    dec = ctx["tenc"].decode(tdec.decrypt(ctx["tparams"], t["sk"], got[6]))
    tckks.precision.assert_precision(ctx["vals"][0] * ctx["vals"][1], dec, 20)
    rot = ctx["tenc"].decode(tdec.decrypt(ctx["tparams"], t["sk"], got[18]))
    tckks.precision.assert_precision(np.roll(ctx["vals"][0], -5), rot, 20)
    assert got[6].scale == Fraction(1 << 90, params.q[3])
    # inner sum (tests/test_ckks.py:130), on the rotation key by 1
    v = ctx["vals"][0]
    inner = tev.inner_sum(t["cts"][0], 1, 2)
    dec = ctx["tenc"].decode(tdec.decrypt(ctx["tparams"], t["sk"], inner))
    tckks.precision.assert_precision(v + np.roll(v, -1), dec, 18)
    assert tev.galois_elements_for_inner_sum(2, 7) == jev.galois_elements_for_inner_sum(2, 7)
    # evaluate_lintrans (ported in A6): one diagonal, encoded at scale q_l so
    # that the rescale cancels it, multiplies the slots
    tparams = ctx["tparams"]
    level = t["cts"][0].level
    d = np.linspace(-1, 1, tparams.max_slots)
    tr = tlt.encode(ctx["tenc"].embed_qp, {0: d}, tlt.LinearTransformationParameters(
        diagonals_index_list=[0], level_q=level, level_p=tparams.max_level_p,
        scale=Fraction(tparams.q[level]), log_dimensions=(0, tparams.log_max_slots),
        log_bsgs_ratio=-1))
    out = tev.rescale(tev.evaluate_lintrans(t["cts"][0], tr))
    assert out.scale == t["cts"][0].scale
    dec = ctx["tenc"].decode(tdec.decrypt(tparams, t["sk"], out))
    tckks.precision.assert_precision(ctx["vals"][0] * d, dec, 20)
    with pytest.raises(ValueError, match="Galois key"):
        tev.rotate(t["cts"][0], 2)

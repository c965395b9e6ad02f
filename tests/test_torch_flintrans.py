"""PyTorch port, the int32 lintrans (fast/flintrans.py) and
``FastEvaluator.evaluate_lintrans``: tests/test_flintrans.py's cases at logN 8
and tests/test_feval.py::test_evaluate_lintrans at logN 6, on the JAX
package's keys and ciphertexts.

The fast matvecs equal the port's u64 circuit (circuits/lintrans.py) limb for
limb, and hash to the JAX package's fast outputs (``DIGESTS``,
tools/port_circuit_digests.py); ``convert_lintrans`` equals the JAX
package's live (one jitted call).  The BSGS output decodes to the diagonal
model with tests/test_flintrans.py's bound, 15 bits.
"""

from fractions import Fraction
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.fast import fring as jfring
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, as_i32, check_case, decode
from test_torch_rlwe import eq

DIAGS = [-15, -4, -1, 0, 1, 2, 3, 4, 15]


def _ltp(m, params, diags, ratio, level=None, scale=None):
    return m.lt.LinearTransformationParameters(
        diagonals_index_list=list(diags), level_q=params.max_level if level is None else level,
        level_p=params.max_level_p, scale=params.default_scale if scale is None else scale,
        log_dimensions=(0, params.log_max_slots), log_bsgs_ratio=ratio)


def _flintrans_context():
    """tests/test_flintrans.py's setup."""
    logn, lq, lp = 8, 6, 2
    moduli = jfring.find_fast_primes(1 << logn, lq + lp)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=logn, q=tuple(moduli[:lq]), p=tuple(moduli[lq:]), log_default_scale=40))
    enc = jckks.Encoder(params)
    ks, kr, ke = jax.random.split(jax.random.key(0), 3)
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    slots = params.max_slots
    rng = np.random.default_rng(5)
    diags = {k: rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for k in DIAGS}
    v = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    gks = JK.gen_galois_keys(jax.random.key(7), params, sk,
                             JAX.lt.galois_elements(params, DIAGS, slots, 0))
    missing = [g for g in JAX.lt.galois_elements(params, DIAGS, slots, -1) if g not in gks]
    gks_naive = {**gks, **JK.gen_galois_keys(jax.random.key(9), params, sk, missing)}
    rlk_naive = JK.gen_relinearization_key(jax.random.key(1), params, sk)
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(
        ke, sk, jax_encode(enc, params, v))
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, diags=diags, v=v, gks=gks,
                           gks_naive=gks_naive, rlk_naive=rlk_naive, ct=ct)


def _feval_context():
    """tests/test_feval.py's setup and test_evaluate_lintrans's keys."""
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(22,) * 6, logp=(22, 22), log_default_scale=15))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    rlk = JK.gen_relinearization_key(jax.random.key(1), params, sk)
    gal_els = [params.galois_element(k) for k in (1, 2, 4, -1)] + [params.galois_element_inverse()]
    gks = JK.gen_galois_keys(jax.random.key(2), params, sk, gal_els)
    enc = jckks.Encoder(params)
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(params.max_slots) + 1j * rng.standard_normal(params.max_slots)
            for _ in range(2)]
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(
        jax.random.key(10), sk, jax_encode(enc, params, vals[0]))
    slots = params.max_slots
    rng = np.random.default_rng(3)
    diags = {0: rng.standard_normal(slots), 1: rng.standard_normal(slots),
             slots - 1: rng.standard_normal(slots)}
    gks.update(JK.gen_galois_keys(jax.random.key(4), params, sk,
                                  JAX.lt.galois_elements(params, list(diags), slots, 1)))
    return SimpleNamespace(params=params, rlk=rlk, gks=gks, ct=ct, diags=diags)


def jax_context():
    return SimpleNamespace(lt=_flintrans_context(), fe=_feval_context())


def _matvec(kind):
    def run(m, c):
        c = c.lt
        naive = kind == "naive"
        ltp = _ltp(m, c.params, c.diags, -1 if naive else 0)
        t = m.ckks_lt.new_linear_transformation(m.ckks.Encoder(c.params), c.diags, ltp)
        fctx = m.fckks.make_context(c.params, c.rlk_naive if naive else c.rlk,
                                    gks=c.gks_naive if naive else c.gks)
        matvec = m.flintrans.matvec_naive if naive else m.flintrans.matvec_bsgs
        return list(matvec(fctx, m.flintrans.convert_lintrans(c.params, t), as_i32(m, c.ct.value[0]),
                           as_i32(m, c.ct.value[1]), c.params.galois_element))
    return run


def _evaluate_lintrans(m, c):
    c = c.fe
    level = c.ct.level
    ltp = _ltp(m, c.params, c.diags, 1, level=level, scale=Fraction(c.params.q[level]))
    t = m.lt.encode(m.ckks.Encoder(c.params).embed_qp, c.diags, ltp)
    fast = m.feval.make_fast_evaluator(c.params, c.rlk, c.gks)
    return fast.evaluate_lintrans(m.feval.ct_to_fast(c.ct), t)


CASES = {"matvec_bsgs": _matvec("bsgs"), "matvec_naive": _matvec("naive"),
         "evaluate_lintrans": _evaluate_lintrans}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "matvec_bsgs": "c620cd0728d16256320aebfd68a1b8918e2fb0c880371e7aa110abc66b741694",
    "matvec_naive": "b2af49134db03fe11f8f1dbd4268e257c064618a25b463887e8163c6e21b8255",
    "evaluate_lintrans": "646fe37d33735fd76e2fb83f017eedc0adf7316aa8771ff8ce322e9bb47e3f2d",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    lt, fe = jctx.lt, jctx.fe
    params = carry.carry(lt.params, "cpu")
    t = carry.carry(dict(sk=lt.sk, rlk=lt.rlk, gks=lt.gks, gks_naive=lt.gks_naive,
                         rlk_naive=lt.rlk_naive, ct=lt.ct), "cpu")
    fparams = carry.carry(fe.params, "cpu")
    f = carry.carry(dict(rlk=fe.rlk, gks=fe.gks, ct=fe.ct), "cpu")
    return SimpleNamespace(
        lt=SimpleNamespace(params=params, diags=lt.diags, v=lt.v, **t),
        fe=SimpleNamespace(params=fparams, diags=fe.diags, **f),
        params=params, sk=t["sk"], enc=PORT.ckks.Encoder(params))


def _u64(c, naive):
    ltp = _ltp(PORT, c.params, c.diags, -1 if naive else 0)
    t = PORT.ckks_lt.new_linear_transformation(PORT.ckks.Encoder(c.params), c.diags, ltp)
    return t, PORT.lt.evaluate(c.params, c.ct, t, c.gks_naive if naive else c.gks)


@pytest.mark.parametrize("kind", ["bsgs", "naive"])
def test_matvec_matches_u64(ctx, kind):
    out0, out1 = check_case(CASES, DIGESTS, f"matvec_{kind}", ctx)
    t, want = _u64(ctx.lt, kind == "naive")
    assert (t.n1 == 0) == (kind == "naive")
    assert torch.equal(out0.long(), want.value[0]) and torch.equal(out1.long(), want.value[1])


def test_matvec_decrypts_to_model(ctx):
    c = ctx.lt
    out0, out1 = CASES["matvec_bsgs"](PORT, ctx)
    out = c.ct.with_value((out0.long(), out1.long())).with_metadata(
        scale=c.ct.scale * c.params.default_scale)
    got = decode(ctx, PORT.ckks.Evaluator(c.params).rescale(out))
    slots = c.params.max_slots
    want = sum(np.asarray(d) * np.roll(c.v, -(k % slots)) for k, d in c.diags.items())
    PORT.ckks.precision.assert_precision(want, got, 15)


def test_convert_lintrans(ctx):
    """The int32 diagonals are the u64 plaintexts (Montgomery form, held
    against the JAX package's by tests/test_torch_lintrans.py) taken out of
    the Montgomery domain: x * 2^64 mod q gives the u64 word back."""
    c = ctx.lt
    t = PORT.ckks_lt.new_linear_transformation(
        PORT.ckks.Encoder(c.params), c.diags, _ltp(PORT, c.params, c.diags, 0))
    f = PORT.flintrans.convert_lintrans(c.params, t)
    assert (f.n1, f.log_dimensions) == (t.n1, t.log_dimensions) and f.vec.keys() == t.vec.keys()
    for k, (ptq, ptp) in t.vec.items():
        for x, want, mods in ((f.vec[k][0], ptq, c.params.q), (f.vec[k][1], ptp, c.params.p)):
            assert x.dtype == torch.int32
            for row, w, q in zip(x.tolist(), want.tolist(), mods):
                assert [(v << 64) % q for v in row] == [w_ % (1 << 64) for w_ in w]


def test_evaluate_lintrans(ctx):
    """test_feval.py::test_evaluate_lintrans: the fast evaluate_lintrans
    equals the u64 one (both the port's), and the JAX package's fast one."""
    got = check_case(CASES, DIGESTS, "evaluate_lintrans", ctx)
    c = ctx.fe
    level = c.ct.level
    t = PORT.lt.encode(PORT.ckks.Encoder(c.params).embed_qp, c.diags, _ltp(
        PORT, c.params, c.diags, 1, level=level, scale=Fraction(c.params.q[level])))
    want = PORT.ckks.Evaluator(c.params, rlk=c.rlk, galois_keys=c.gks).evaluate_lintrans(c.ct, t)
    eq(PORT.feval.ct_to_u64(got), want)

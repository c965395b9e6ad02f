"""PyTorch port, the RLWE core (rlwe/: params, keys, encryptor, decryptor,
evaluator) and ``carry``: held bit-exact against the JAX package at logN 6
(tests/test_rlwe.py's parameters; tests/test_base2.py's two base-two gadget
flavours on the same chain).

Randomness is not part of the contract (ops/samplers.py), so keys and
ciphertexts are compared by handing the port's deterministic halves the
arrays JAX sampled: the helpers below draw them with the JAX samplers on the
keys that the JAX package's keys.py and encryptor.py split, in their order.
JAX keys carried over by ``carry`` drive the port's encryptor and evaluator,
whose outputs must equal JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu.rlwe import decryptor as jdec
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import evaluator as jev
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch import rlwe as trlwe
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import evaluator as tev
from matrix_fhe_tpu_torch.rlwe import keys as TK


# -- the JAX package's random draws, split as its keys.py / encryptor.py do --

def _w(a):
    """A JAX uint64 array as the port's int64 words."""
    return None if a is None else torch.from_numpy(
        np.array(a, copy=True, order="C").view(np.int64))


# Each JAX draw runs jitted: eager, its u64 ops compile one by one, for
# seconds a polynomial.

def _zero_draws(key, params):
    """The draws of keys.encrypt_zero_qp(key, params, sk) (c1 drawn)."""
    k_a, k_e = jax.random.split(key)
    kq, kp = jax.random.split(k_a)
    a_p = None if params.ring_p is None else jsmp.uniform_poly(kp, params.ring_p)
    return jsmp.uniform_poly(kq, params.ring_q), a_p, jsmp.sample(k_e, params.ring_q, params.xe)


def _zero_sample(arrays) -> TK.ZeroSample:
    a_q, a_p, e = arrays
    return TK.ZeroSample(a_q=_w(a_q), a_p=_w(a_p), e=_w(e))


_JITTED: dict = {}


def _jitted(name, params, make):
    """One jitted JAX function a (name, parameter object): a compile each."""
    key = (name, id(params))
    if key not in _JITTED:
        _JITTED[key] = (params, jax.jit(make()))  # params kept alive with its id
    return _JITTED[key][1]


def jax_zero_sample(key, params) -> TK.ZeroSample:
    return _zero_sample(_jitted("zero", params, lambda: lambda k: _zero_draws(k, params))(key))


def _evk_draws(key, kparams, rows: int) -> list:
    """The draws of one gadget key's rows, over the key's basis ``kparams``
    (keys._gen_evaluation_key_arrays and its base-two form)."""
    out = []
    for _ in range(rows):
        key, sub = jax.random.split(key)
        out.append(_zero_draws(sub, kparams))
    return out


def jax_evk_samples(key, kparams, rows: int) -> list[TK.ZeroSample]:
    draws = _jitted(f"evk{rows}", kparams, lambda: lambda k: _evk_draws(k, kparams, rows))
    return [_zero_sample(a) for a in draws(key)]


def jax_galois_samples(key, params, gal_els, rows: int) -> dict:
    """The draws of keys.gen_galois_keys(key, params, sk, gal_els)."""
    out = {}
    for g in gal_els:
        key, sub = jax.random.split(key)
        out[g] = jax_evk_samples(sub, params, rows)
    return out


def jax_sk_sample(key, params, level) -> tenc.SkSample:
    """The draws of encryptor.encrypt_zero_sk(key, params, sk, level)."""
    rq = params.ring_q.at_level(level)

    def draws(key):
        k1, k2 = jax.random.split(key)
        return jsmp.uniform_poly(k1, rq), jsmp.sample(k2, rq, params.xe)
    c1, e = _jitted(f"sk{level}", params, lambda: draws)(key)
    return tenc.SkSample(c1=_w(c1), e=_w(e))


def jax_pk_sample(key, params, level) -> tenc.PkSample:
    """The draws of encryptor.encrypt_zero_pk(key, params, pk, level)."""
    rq = params.ring_q.at_level(level)

    def draws(key):
        ku, k0, k1 = jax.random.split(key, 3)
        return (jsmp.ternary_poly(ku, rq, params.xs), jsmp.sample(k0, rq, params.xe),
                jsmp.sample(k1, rq, params.xe))
    u, e0, e1 = _jitted(f"pk{level}", params, lambda: draws)(key)
    return tenc.PkSample(u=_w(u), e0=_w(e0), e1=_w(e1))


def eq(got, want):
    """The port's value equals the JAX package's, bit for bit, field by field."""
    if want is None:
        assert got is None
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            eq(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            eq(got[k], want[k])
    elif hasattr(want, "__dataclass_fields__"):
        for f in want.__dataclass_fields__:
            eq(getattr(got, f), getattr(want, f))
    elif isinstance(want, (int, float, str, bool)) or type(want).__name__ == "Fraction":
        assert got == want
    else:
        w = np.asarray(want)
        g = got.numpy()
        if w.dtype == np.uint64:  # words, or int32 fast-path limbs widened
            g = g.astype(np.int64).view(np.uint64)
        np.testing.assert_array_equal(g, w)


# -- fixtures ------------------------------------------------------------------

GAL = 5  # galois_element(1)


@pytest.fixture(scope="module")
def jctx():
    params = jrlwe.new_parameters(jrlwe.ParametersLiteral(
        logn=6, logq=(45, 40, 40), logp=(50,)))
    ks, kp, kr, kg, ke, k2 = jax.random.split(jax.random.key(0), 6)
    gen_sk = jax.jit(lambda k: JK.gen_secret_key(k, params))
    sk, sk2 = gen_sk(ks), gen_sk(k2)
    pk = jax.jit(lambda k, s: JK.gen_public_key(k, params, s))(kp, sk)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gks = JK.gen_galois_keys(kg, params, sk, [GAL, params.nth_root - 1])
    evk = JK.gen_evaluation_key(ke, params, sk.value.q, sk2)
    # zero encryptions under sk and under sk2
    enc0 = jax.jit(lambda k, s: jenc.encrypt_zero_sk(k, params, s))
    return dict(params=params, sk=sk, sk2=sk2, pk=pk, rlk=rlk, gks=gks, evk=evk,
                ct=enc0(jax.random.key(8), sk), ct2=enc0(jax.random.key(9), sk2),
                keys=dict(ks=ks, kp=kp, kr=kr, kg=kg, ke=ke, k2=k2))


@pytest.fixture(scope="module")
def tparams(jctx):
    return carry.carry(jctx["params"], "cpu")


# -- tests -------------------------------------------------------------------

def test_params_carried_and_from_literal(jctx, tparams):
    jp = jctx["params"]
    assert (tparams.q, tparams.p, tparams.n, tparams.nth_root) == (jp.q, jp.p, jp.n, jp.nth_root)
    lit = carry.carry(jrlwe.ParametersLiteral(logn=6, logq=(45, 40, 40), logp=(50,)), "cpu")
    built = trlwe.new_parameters(lit, "cpu")
    assert (built.q, built.p) == (jp.q, jp.p)  # GenModuli, the same chain
    for lq, lp in ((2, 0), (1, 0), (2, -1)):
        jd, td = jp.decomposer(lq, lp), tparams.decomposer(lq, lp)
        assert (td.alpha, td.num_digits) == (jd.alpha, jd.num_digits)
        eq(tparams.moddown_constants(lq, 0).moddown_const, jp.moddown_constants(lq, 0).moddown_const)
    assert tparams.galois_elements([1, -1, 3]) == jp.galois_elements([1, -1, 3])
    assert tparams.mod_inv_galois_element(GAL) == jp.mod_inv_galois_element(GAL)


def test_keys_from_jax_samples_equal_jax_keys(jctx, tparams):
    jp, k = jctx["params"], jctx["keys"]
    small = _w(jax.jit(lambda key: jsmp.sample(key, jp.ring_q, jp.xs))(k["ks"]))
    sk = TK.secret_key_from_sample(tparams, small)
    eq(sk, jctx["sk"])
    # the JAX public key draws with c1 from split(k_a)
    eq(TK.public_key_from_sample(tparams, sk, jax_zero_sample(k["kp"], jp)), jctx["pk"])
    rows = jctx["rlk"].gadget.num_digits
    eq(TK.relinearization_key_from_samples(tparams, sk, jax_evk_samples(k["kr"], jp, rows)),
       jctx["rlk"])
    gsam = jax_galois_samples(k["kg"], jp, list(jctx["gks"]), rows)
    for g, want in jctx["gks"].items():
        eq(TK.galois_key_from_samples(tparams, sk, g, gsam[g]), want)
    sk2 = carry.carry(jctx["sk2"], "cpu")
    eq(TK.evaluation_key_from_samples(tparams, sk.value.q, sk2,
                                      jax_evk_samples(k["ke"], jp, rows)), jctx["evk"])
    with pytest.raises(ValueError, match="samples"):
        TK.evaluation_key_from_samples(tparams, sk.value.q, sk2, [])


@pytest.mark.parametrize("level_p, b2", [(-1, 30), (0, 45)])
def test_base_two_and_single_p_keys(jctx, tparams, level_p, b2):
    """tests/test_base2.py's base-two gadgets, P-less (two 30-bit digits a
    limb) and single-P (one digit a limb): the keys from JAX's draws, and
    the key switch with them, equal JAX's."""
    jp = jctx["params"]
    evkp = JK.EvaluationKeyParameters(level_p=level_p, base_two_decomposition=b2)
    kp = JK._key_params_view(jp, level_p)
    rows = sum(TK.base_two_counts(tparams.q, b2))

    def ref(k, a, s, ct):
        """The key, the draws it made and the key switch with it: one compile."""
        want = JK.gen_evaluation_key(k, jp, a, s, evkp)
        return want, _evk_draws(k, kp, rows), jev.apply_evaluation_key(jp, ct, want)
    want, draws, switched = jax.jit(ref)(
        jax.random.key(40 + b2), jctx["sk2"].value.q, jctx["sk"], jctx["ct2"])
    assert want.gadget.num_digits == rows
    sk, sk2 = carry.carry((jctx["sk"], jctx["sk2"]), "cpu")
    tevkp = TK.EvaluationKeyParameters(level_p=level_p, base_two_decomposition=b2)
    got = TK.evaluation_key_from_samples(tparams, sk2.value.q, sk,
                                         [_zero_sample(d) for d in draws], tevkp)
    eq(got, want)
    assert got.gadget.base_two == b2 and got.gadget.level_p == level_p
    eq(tev.apply_evaluation_key(tparams, carry.carry(jctx["ct2"], "cpu"), got), switched)


def test_encrypt_decrypt_from_jax_samples(jctx, tparams):
    jp = jctx["params"]
    rng = np.random.default_rng(3)
    m = rng.integers(0, 256, jp.n)
    limbs = jm.u64(np.stack([(m % q).astype(np.uint64) for q in jp.q]))
    pt = jrlwe.Plaintext(value=jax.jit(lambda x: jp.ring_q.ntt(x))(limbs))
    tpt = carry.carry(pt, "cpu")
    sk, pk = carry.carry((jctx["sk"], jctx["pk"]), "cpu")
    enc = jax.jit(lambda k, key, p: jenc.encrypt(k, jp, key, p))
    decrypt = jax.jit(lambda s, c: jdec.decrypt(jp, s, c))
    for key, enc_key, tkey, draws in ((jax.random.key(4), jctx["sk"], sk, jax_sk_sample),
                                      (jax.random.key(5), jctx["pk"], pk, jax_pk_sample)):
        want = enc(key, enc_key, pt)
        got = tenc.encrypt_from_sample(tparams, tkey, tpt, draws(key, jp, jp.max_level))
        eq(got, want)
        eq(tdec.decrypt(tparams, sk, got), decrypt(jctx["sk"], want))
    # below the top level, and in the coefficient domain
    low = jrlwe.MetaData(is_ntt=False)
    want = jax.jit(lambda k, s: jenc.encrypt_zero_sk(k, jp, s, 1, low))(
        jax.random.key(6), jctx["sk"])
    got = tenc.encrypt_zero_sk_from_sample(tparams, sk, jax_sk_sample(jax.random.key(6), jp, 1),
                                           carry.carry(low, "cpu"))
    eq(got, want)
    eq(tdec.decrypt(tparams, sk, got), decrypt(jctx["sk"], want))
    # the port's own draws decrypt to the message
    ct = tenc.encrypt(torch.Generator().manual_seed(0), tparams, sk, tpt)
    dec = tparams.ring_q.intt(tdec.decrypt(tparams, sk, ct).value)[0].numpy()
    err = (dec - m + jp.q[0] // 2) % jp.q[0] - jp.q[0] // 2
    assert np.abs(err).max() < 64


def test_key_switching_matches_jax(jctx, tparams):
    jp = jctx["params"]
    ct = jctx["ct"]
    # the trace onto the subring of degree 2^4 (elements 5^16, 5^32 and -1
    # are not all keyed: it takes 5^(2^4) only)
    els = tev.galois_elements_for_trace(tparams, 4)
    assert els == jev.galois_elements_for_trace(jp, 4)
    jgks = dict(jctx["gks"])
    for g in els:
        if g not in jgks:
            jgks[g] = JK.gen_galois_key(jax.random.key(g), jp, jctx["sk"], g)
    conj = jp.nth_root - 1

    def ref(ct, evk, rlk, gks):
        """Every JAX output below: one compile."""
        gk = gks[GAL]
        digits = jev.decompose_ntt(jp, ct.level, ct.value[1])
        c2 = ct.with_value(ct.value + (ct.value[1],))
        cc = jrlwe.Ciphertext(value=tuple(jp.ring_q.intt(v) for v in ct.value),
                              metadata=jrlwe.MetaData(is_ntt=False))
        return dict(
            evk=jev.apply_evaluation_key(jp, ct, evk), aut=jev.automorphism(jp, ct, gk),
            digits=digits, hoisted=jev.automorphism_hoisted(jp, ct, digits, gk),
            lazy=jev.automorphism_hoisted_lazy(jp, ct, digits, gk),
            relin=jev.relinearize(jp, c2, rlk), trace=jev.trace(jp, ct, 4, gks),
            cc=cc, coeff=jev.automorphism(jp, cc, gks[conj]))
    want = jax.jit(ref)(ct, jctx["evk"], jctx["rlk"], jgks)
    tct, rlk, tgks, evk = carry.carry((ct, jctx["rlk"], jgks, jctx["evk"]), "cpu")
    gk = tgks[GAL]
    eq(tev.apply_evaluation_key(tparams, tct, evk), want["evk"])
    eq(tev.automorphism(tparams, tct, gk), want["aut"])
    digits_t = tev.decompose_ntt(tparams, tct.level, tct.value[1])
    eq(digits_t, want["digits"])
    eq(tev.automorphism_hoisted(tparams, tct, digits_t, gk), want["hoisted"])
    eq(tev.automorphism_hoisted_lazy(tparams, tct, digits_t, gk), want["lazy"])
    # degree 2 -> 1
    c2 = tct.with_value(tct.value + (tct.value[1],))
    eq(tev.relinearize(tparams, c2, rlk), want["relin"])
    eq(tev.trace(tparams, tct, 4, {g: tgks[g] for g in els}), want["trace"])
    # the coefficient-domain automorphism
    eq(tev.automorphism(tparams, carry.carry(want["cc"], "cpu"), tgks[conj]), want["coeff"])
    with pytest.raises(ValueError):
        tev.relinearize(tparams, tct, rlk)

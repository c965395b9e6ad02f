"""PyTorch port, the fast-path CKKS evaluator (fast/feval.py) and
``fckks.make_context``, and the slice as a whole.

* tests/test_feval.py's cases at logN 8, on JAX's keys and ciphertexts
  carried over: every FastEvaluator operation (scalar and linear ops,
  mul_relin, rescale, set_scale, rotate, conjugate, rotate_hoisted,
  trace_log_n, mod_raise, apply_evaluation_key) equals the JAX package's
  FastEvaluator on the same inputs, and the port's u64 evaluator, limb for
  limb (JAX's FastEvaluator equals its u64 Evaluator: tests/test_feval.py;
  the port's u64 evaluator equals JAX's: tests/test_torch_ckks.py).
  add_plain with a plaintext at another scale is held against JAX's
  FastEvaluator and against Python integers (JAX's u64 Evaluator cannot run
  it: ROADMAP C).
* tests/test_fckks.py:57,69 at logN 8: the context built from carried keys
  equals JAX's ``make_context``, and the full step equals the u64 evaluator.
* End to end at logN 8: FastEncoder -> encrypt (JAX's draws) ->
  FastEvaluator.mul_relin -> rescale x2 -> decrypt -> decode; every
  ciphertext equals JAX's bit for bit and the decode equals JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.fast import fckks as jfckks
from matrix_fhe_tpu.fast import feval as jfeval
from matrix_fhe_tpu.fast import fring as jfring
from matrix_fhe_tpu.rlwe import decryptor as jdec
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.circuits import lintrans as tlt
from matrix_fhe_tpu_torch.fast import fckks as tfckks
from matrix_fhe_tpu_torch.fast import feval as tfeval
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from test_torch_ckks import jax_decode, jax_encode
from test_torch_rlwe import eq, jax_sk_sample

HOISTED = (0, 1, 4)
OPS = ("add", "sub", "neg", "add_const", "sub_const", "mul_const", "mul_const_complex",
       "scale_up", "add_plain", "mul_plain", "mul_relin", "rescale", "rescale x2",
       "set_scale", "rotate 2", "conjugate", *(f"hoisted {k}" for k in HOISTED),
       "trace_log_n 5", "mod_raise", "apply_evaluation_key")


def _ops(ev, a, b, pt, evk) -> list:
    """The evaluator operations of tests/test_feval.py on ciphertexts a, b,
    plaintext pt and evaluation key evk, in the order of OPS: one list, for
    one JAX compile."""
    prod = ev.mul_relin(a, b)
    once = ev.rescale(prod)
    hoisted = ev.rotate_hoisted(a, list(HOISTED))
    return [
        ev.add(a, b), ev.sub(a, b), ev.neg(a), ev.add_const(a, 1.25 - 0.5j),
        ev.sub_const(a, 0.75), ev.mul_const(a, 1.5), ev.mul_const_complex(a, 0.3 + 0.1j),
        ev.scale_up(a, 9), ev.add_plain(a, pt), ev.mul_plain(a, pt),
        prod, once, ev.rescale(once), ev.set_scale(prod, ev.params.default_scale),
        ev.rotate(a, 2), ev.conjugate(a), *(hoisted[k] for k in HOISTED),
        ev.trace_log_n(a, 5), ev.mod_raise(ev._drop_level(a, 0)),
        ev.apply_evaluation_key(a, evk),
    ]


def _fast(x):
    """A JAX u64 ciphertext or plaintext with int32 fast-path limbs."""
    v = x.value
    return dataclasses.replace(x, value=tuple(jfeval.to_int32(w) for w in v)
                               if isinstance(v, tuple) else jfeval.to_int32(v))


# -- logN 8: tests/test_fckks.py's setup; the keys and ciphertexts of every test --

@pytest.fixture(scope="module")
def step():
    logn, lq, lp = 8, 6, 2
    moduli = jfring.find_fast_primes(1 << logn, lq + lp)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=logn, q=tuple(moduli[:lq]), p=tuple(moduli[lq:]), log_default_scale=40))
    ks, kr, k1, k2 = jax.random.split(jax.random.key(0), 4)
    gen_sk = jax.jit(lambda k: JK.gen_secret_key(k, params))
    sk, sk2 = gen_sk(ks), gen_sk(jax.random.key(20))
    # one compiled gadget-key generator serves them all (keys.py's cache)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gal_els = [params.galois_element(k) for k in (1, 2, 4, -1)] + [
        params.galois_element_inverse()] + [
        params.galois_element(1 << i) for i in range(3, params.log_n - 1)]
    gks = JK.gen_galois_keys(jax.random.key(2), params, sk, gal_els)
    evk = JK.gen_evaluation_key(jax.random.key(21), params, sk.value.q, sk2)
    enc = jckks.Encoder(params)
    rng = np.random.default_rng(0)
    v1 = rng.uniform(-1, 1, params.max_slots)
    v2 = rng.uniform(-1, 1, params.max_slots)
    pts = [jax_encode(enc, params, v) for v in (v1, v2)]
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    ct1, ct2 = encrypt(k1, sk, pts[0]), encrypt(k2, sk, pts[1])
    half = np.ones(params.max_slots) * 0.5
    pt, off = (jax_encode(enc, params, half, scale=s) for s in (None, 1 << 13))
    # the JAX package's FastEvaluator on the same inputs
    jfast = jfeval.make_fast_evaluator(params, rlk, gks)
    jfast._evk32(evk, params.max_level)  # converts evk on the host, outside the trace
    want_fast = jax.jit(lambda a, b, p, o: _ops(jfast, a, b, p, evk) + [jfast.add_plain(a, o)])(
        _fast(ct1), _fast(ct2), _fast(pt), _fast(off))
    prod = [want_fast[OPS.index(k)] for k in ("mul_relin", "rescale", "rescale x2")]
    dec = jax.jit(lambda s, c: jdec.decrypt(params, s, c))(sk, jfeval.ct_to_u64(prod[2]))
    tparams = carry.carry(params, "cpu")
    return dict(params=params, sk=sk, rlk=rlk, enc=enc, v1=v1, v2=v2, pts=pts,
                cts=(ct1, ct2), keys=(k1, k2), prod=prod, dec=dec,
                want_fast=want_fast,
                decoded=jax_decode(enc, params, dec), tparams=tparams,
                t=carry.carry(dict(sk=sk, rlk=rlk, gks=gks, evk=evk, cts=(ct1, ct2),
                                   pt=pt, off=off), "cpu"))


def _same(fast_ct, u64_ct):
    """A fast-path ciphertext equals a u64 one, limb for limb."""
    assert all(v.dtype == torch.int32 for v in fast_ct.value)
    for a, b in zip(fast_ct.value, u64_ct.value):
        assert torch.equal(tfeval.to_uint64(a), b)
    assert fast_ct.scale == u64_ct.scale and fast_ct.level == u64_ct.level


@pytest.fixture(scope="module")
def ctx(step):
    tparams, t = step["tparams"], step["t"]
    return dict(tparams=tparams, t=t,
                u64=tckks.Evaluator(tparams, rlk=t["rlk"], galois_keys=t["gks"]),
                fast=tfeval.make_fast_evaluator(tparams, t["rlk"], t["gks"]),
                fcts=[tfeval.ct_to_fast(c) for c in t["cts"]])


def test_encoder_cast(ctx):
    tparams = ctx["tparams"]
    v = np.arange(tparams.max_slots) / 7.0
    pu, pf = tckks.Encoder(tparams).encode(v), tfeval.FastEncoder(tparams).encode(v)
    assert pf.value.dtype == torch.int32
    assert torch.equal(tfeval.to_uint64(pf.value), pu.value)
    np.testing.assert_array_equal(tfeval.FastEncoder(tparams).decode(pf),
                                  tckks.Encoder(tparams).decode(pu))


@pytest.fixture(scope="module")
def got(ctx):
    """Every operation of OPS through the port's FastEvaluator and its u64
    evaluator, on the carried ciphertexts."""
    t = ctx["t"]
    fpt = tfeval.FastEncoder(ctx["tparams"]).encode(np.ones(ctx["tparams"].max_slots) * 0.5)
    assert torch.equal(tfeval.to_uint64(fpt.value), t["pt"].value)
    return dict(fast=_ops(ctx["fast"], *ctx["fcts"], fpt, t["evk"]),
                u64=_ops(ctx["u64"], *t["cts"], t["pt"], t["evk"]))


def _check(step, got, ops):
    """Each operation equals the JAX package's FastEvaluator and the port's
    u64 evaluator, limb for limb."""
    for op in ops:
        i = OPS.index(op)
        fast = got["fast"][i]
        eq(fast, step["want_fast"][i])
        _same(fast, got["u64"][i])


def test_linear_and_scalar_ops(step, ctx, got):
    _check(step, got, OPS[:OPS.index("mul_relin")])
    # a plaintext at another scale, multiplied up by the integer ratio of the
    # scales: JAX's FastEvaluator, and (a0 + ratio * pt) mod q in Python
    # integers, limb by limb; the port's u64 evaluator agrees
    fast, u64, a, fa = ctx["fast"], ctx["u64"], ctx["t"]["cts"][0], ctx["fcts"][0]
    off = ctx["t"]["off"]
    fout = fast.add_plain(fa, dataclasses.replace(off, value=tfeval.to_int32(off.value)))
    eq(fout, step["want_fast"][len(OPS)])
    uout = u64.add_plain(a, off)
    _same(fout, uout)
    ratio = a.scale / off.scale
    assert ratio == 1 << 27
    for i, q in enumerate(ctx["tparams"].q):
        a0, p0 = a.value[0][i].tolist(), off.value[i].tolist()
        assert uout.value[0][i].tolist() == [(x + int(ratio) * y) % q for x, y in zip(a0, p0)]
    assert torch.equal(uout.value[1], a.value[1]) and uout.scale == a.scale


def test_mul_relin_rescale(step, got):
    _check(step, got, ("mul_relin", "rescale", "rescale x2", "set_scale"))


def test_automorphisms(step, got):
    _check(step, got, ("rotate 2", "conjugate", *(f"hoisted {k}" for k in HOISTED)))


def test_trace_mod_raise_and_evaluation_key(step, ctx, got):
    _check(step, got, ("trace_log_n 5", "mod_raise", "apply_evaluation_key"))
    fast = ctx["fast"]
    # evaluate_lintrans (ported in A6) runs fast/flintrans.py on the int32
    # limbs: a transform over diagonals 0, 1 and -1 equals the u64
    # evaluator's (tests/test_torch_flintrans.py holds both against JAX)
    tparams = ctx["tparams"]
    slots = tparams.max_slots
    rng = np.random.default_rng(3)
    diags = {k: rng.uniform(-1, 1, slots) for k in (0, 1, slots - 1)}
    tr = tlt.encode(tckks.Encoder(tparams).embed_qp, diags, tlt.LinearTransformationParameters(
        diagonals_index_list=list(diags), level_q=tparams.max_level,
        level_p=tparams.max_level_p, scale=tparams.default_scale,
        log_dimensions=(0, tparams.log_max_slots), log_bsgs_ratio=-1))
    _same(fast.evaluate_lintrans(ctx["fcts"][0], tr),
          ctx["u64"].evaluate_lintrans(ctx["t"]["cts"][0], tr))
    with pytest.raises(ValueError):
        tfeval.FastEvaluator(ctx["tparams"], fast._ctx(3))


def test_make_context_and_full_step(step):
    params, tparams, t = step["params"], step["tparams"], step["t"]
    jctx = jfckks.make_context(params, step["rlk"], rescale_limbs=2)
    tctx = tfckks.make_context(tparams, t["rlk"], rescale_limbs=2)
    for name in ("rlk_q", "rlk_p"):
        eq(getattr(tctx, name), getattr(jctx, name))
    assert tctx.ring_q.moduli_tuple == jctx.ring_q.moduli_tuple
    (c0, c1), (d0, d1) = ((tfeval.to_int32(v) for v in c.value) for c in t["cts"])
    got = tfckks.mul_relin_rescale(tctx, c0, c1, d0, d1)
    eq(got, step["prod"][2].value)  # test_fckks.py:57 (JAX's FastEvaluator's)
    out = t["cts"][0].with_value(tuple(tfeval.to_uint64(g) for g in got)).with_metadata(
        scale=step["prod"][2].scale)
    dec = tckks.Encoder(tparams).decode(tdec.decrypt(tparams, t["sk"], out))
    np.testing.assert_allclose(dec.real, step["v1"] * step["v2"], atol=2e-3)  # :69


def test_slice_end_to_end(step):
    """FastEncoder -> encrypt -> FastEvaluator.mul_relin -> rescale x2 ->
    decrypt -> decode, each stage equal to JAX's."""
    params, tparams, t = step["params"], step["tparams"], step["t"]
    fenc = tfeval.FastEncoder(tparams)
    sk = t["sk"]
    cts = []
    for v, pt, key, want in zip((step["v1"], step["v2"]), step["pts"], step["keys"], step["cts"]):
        fpt = fenc.encode(v)
        eq(tfeval.to_uint64(fpt.value), pt.value)
        ct = tenc.encrypt_from_sample(tparams, sk, dataclasses.replace(
            fpt, value=tfeval.to_uint64(fpt.value)),
            jax_sk_sample(key, params, params.max_level))
        eq(ct, want)
        cts.append(tfeval.ct_to_fast(ct))
    fast = tfeval.make_fast_evaluator(tparams, t["rlk"], {})
    prod = fast.mul_relin(*cts)
    eq(prod, step["prod"][0])
    once = fast.rescale(prod)
    eq(once, step["prod"][1])
    twice = fast.rescale(once)
    eq(twice, step["prod"][2])
    pt = tdec.decrypt(tparams, sk, tfeval.ct_to_u64(twice))
    eq(pt, step["dec"])
    decoded = fenc.decode(dataclasses.replace(pt, value=tfeval.to_int32(pt.value)))
    np.testing.assert_array_equal(decoded, step["decoded"])
    np.testing.assert_allclose(decoded.real, step["v1"] * step["v2"], atol=2e-3)
    tckks.precision.assert_precision(step["v1"] * step["v2"], decoded, 10)
    # the port's own draws reach the same precision
    gen = torch.Generator().manual_seed(0)
    own = [tfeval.ct_to_fast(tenc.encrypt(gen, tparams, sk, tckks.Encoder(tparams).encode(v)))
           for v in (step["v1"], step["v2"])]
    out = fast.rescale(fast.rescale(fast.mul_relin(*own)))
    decoded = fenc.decode(tdec.decrypt(tparams, sk, tfeval.ct_to_u64(out)))
    np.testing.assert_allclose(decoded.real, step["v1"] * step["v2"], atol=2e-3)

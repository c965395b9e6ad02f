"""PyTorch port, the base-2^B and single-P key switches of tests/test_base2.py
at its parameters (logN 6, Q 3 x 45 bits, with and without a 45-bit P,
scale 2^40) and with its bounds:

  * the P-less key switch sk2 -> sk at B = 12 (> 12 bits) and at B = 0
    (< 12 bits: without bit decomposition the P-less digit is q_i / 2);
  * a rotation by one slot with a single-P galois key at B = 15 (> 15 bits);
  * relinearization with a P-less base-two key at B = 12 (> 10 bits).

The keys and the encryptions are made by the port's ``*_from_sample(s)``
from the arrays the JAX package draws (its keys.py and encryptor.py splits);
``tools/port_circuit_digests.py test_torch_base2`` pins the JAX package's
keys, ciphertexts and key-switch outputs here (``DIGESTS``), which the
port's must equal bit for bit.  The bounds are then checked on the port's
own decryption.  (tests/test_base2.py:97, the RGSW product, is in
tests/test_torch_rgsw.py.)
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

# case: (logp, key kind, level_p, B, the input's seed; tests/test_base2.py)
SETUPS = {"pless_b12": ((), "evk", -1, 12, 0), "pless_b0": ((), "evk", -1, 0, 0),
          "galois_single_p_b15": ((45,), "galois", 0, 15, 1),
          "relin_b12": ((), "relin", -1, 12, 2)}


def _literal(m, logp):
    return m.CKKSParametersLiteral(logn=6, logq=(45, 45, 45), logp=logp, log_default_scale=40)


def _values(params, seed):
    return np.random.default_rng(seed).uniform(-1, 1, params.max_slots)


def jax_context():
    """tests/test_base2.py's keys and ciphertexts, case by case."""
    out = {}
    for name, (logp, kind, level_p, b2, seed) in SETUPS.items():
        params = jckks.new_parameters(_literal(jckks, logp))
        evkp = JK.EvaluationKeyParameters(level_p=level_p, base_two_decomposition=b2)
        sk = JK.gen_secret_key(jax.random.key(0), params)
        enc_key = sk
        if kind == "evk":
            sk2 = JK.gen_secret_key(jax.random.key(1), params)
            key = JK.gen_evaluation_key(jax.random.key(2), params, sk2.value.q, sk, evkp)
            enc_key = sk2
        elif kind == "galois":
            key = JK.gen_galois_key(jax.random.key(1), params, sk, params.galois_element(1),
                                    evkp)
        else:
            key = JK.gen_relinearization_key(jax.random.key(1), params, sk, evkp)
        pt = jckks.Encoder(params).encode(_values(params, seed))
        ct = jenc.encrypt(jax.random.key(3), params, enc_key, pt)
        out[name] = SimpleNamespace(params=params, sk=sk, key=key, ct=ct)
    return out


def port_context():
    """The same, the port's from the JAX package's draws."""
    out = {}
    for name, (logp, kind, level_p, b2, seed) in SETUPS.items():
        jp = jckks.new_parameters(_literal(jckks, logp))
        params = carry.carry(jp, "cpu")
        evkp = TK.EvaluationKeyParameters(level_p=level_p, base_two_decomposition=b2)
        kp = JK._key_params_view(jp, level_p)
        rows = sum(TK.base_two_counts(params.q, b2)) if b2 else len(params.q)

        def secret(k):
            return TK.secret_key_from_sample(params, _w(_SAMPLE(jax.random.key(k), jp.ring_q,
                                                                 jp.xs)))
        sk = secret(0)
        enc_key = sk
        if kind == "evk":
            sk2 = secret(1)
            key = TK.evaluation_key_from_samples(params, sk2.value.q, sk,
                                                 evk_draws(jax.random.key(2), kp, rows), evkp)
            enc_key = sk2
        elif kind == "galois":
            key = TK.galois_key_from_samples(params, sk, params.galois_element(1),
                                             evk_draws(jax.random.key(1), kp, rows), evkp)
        else:
            key = TK.relinearization_key_from_samples(
                params, sk, evk_draws(jax.random.key(1), kp, rows), evkp)
        enc = tckks.Encoder(params)
        v = _values(params, seed)
        ct = tenc.encrypt_from_sample(params, enc_key, enc.encode(v),
                                      sk_draws(jax.random.key(3), jp, params.max_level))
        out[name] = SimpleNamespace(params=params, sk=sk, key=key, ct=ct, enc=enc, v=v)
    return out


def _gadget(key):
    g = key.gadget
    return [g.q] + ([] if g.p is None else [g.p])


def _switch(m, c):
    ev = m.ckks.Evaluator(c.params)
    return _gadget(c.key) + [c.ct, ev.apply_evaluation_key(c.ct, c.key)]


def _rotate(m, c):
    ev = m.ckks.Evaluator(c.params, galois_keys={c.key.gal_el: c.key})
    return _gadget(c.key) + [c.ct, ev.rotate(c.ct, 1)]


def _relin(m, c):
    ev = m.ckks.Evaluator(c.params, rlk=c.key)
    return _gadget(c.key) + [c.ct, ev.rescale(ev.mul_relin(c.ct, c.ct))]


CASES = {
    "pless_b12": lambda m, ctx: _switch(m, ctx["pless_b12"]),
    "pless_b0": lambda m, ctx: _switch(m, ctx["pless_b0"]),
    "galois_single_p_b15": lambda m, ctx: _rotate(m, ctx["galois_single_p_b15"]),
    "relin_b12": lambda m, ctx: _relin(m, ctx["relin_b12"]),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "pless_b12": "214d9d99ec30fb53c4d7c3eae8d70ae83d5e8978ef6a2d7f2758db43bc403452",
    "pless_b0": "c3a9f1de6d2aaf5dd133ee69d8ffae57e4caa463895740d4304291baab91107e",
    "galois_single_p_b15": "41e799c49f38552c2057b27634bf23a61c894caf9e7ee906e45c3efc1f827aa2",
    "relin_b12": "b39f8dd9934528979f9663f75a2519c679d69c6b9869815b7ebe684b9815732f",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def _precision(c, out, want):
    got = c.enc.decode(tdec.decrypt(c.params, c.sk, out))
    return -np.log2(np.mean(np.abs(got - want)) + 1e-30)


@pytest.mark.parametrize("name", ["pless_b12", "pless_b0"])
def test_apply_evaluation_key_pless(ctx, name):
    """tests/test_base2.py:30-59: the P-less key switch sk2 -> sk."""
    c = ctx[name]
    b2 = SETUPS[name][3]
    assert c.key.gadget.p is None and c.key.gadget.base_two == b2
    if b2:
        assert c.key.gadget.num_digits == sum(TK.base_two_counts(c.params.q, b2))
    out = check_case(CASES, DIGESTS, name, ctx)[-1]
    prec = _precision(c, out, c.v)
    # B = 12 digits bound the key-switch noise; without bit decomposition the
    # P-less digit norm is q_i / 2 and the precision collapses
    if b2:
        assert prec > 12, prec
    else:
        assert prec < 12, prec


def test_galois_key_single_p_base2(ctx):
    """tests/test_base2.py:62-78: a single-P galois key at B = 15."""
    c = ctx["galois_single_p_b15"]
    assert c.key.gadget.p is not None and c.key.gadget.p.shape[-2] == 1
    out = check_case(CASES, DIGESTS, "galois_single_p_b15", ctx)[-1]
    assert _precision(c, out, np.roll(c.v, -1)) > 15


def test_relinearization_base2(ctx):
    """tests/test_base2.py:81-94: relinearization with a P-less key at B = 12."""
    out = check_case(CASES, DIGESTS, "relin_b12", ctx)[-1]
    c = ctx["relin_b12"]
    assert _precision(c, out, c.v * c.v) > 10

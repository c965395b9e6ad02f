"""PyTorch port, RGSW (rgsw/rgsw.py): tests/test_rgsw.py's two cases at
logN 7 (RGSW(3) and RGSW(X^5) with the standard gadget) and
tests/test_base2.py:97's base-two product at logN 6 (RGSW(3), P-less,
B = 12), with their bounds.

Each RGSW ciphertext is made by ``rgsw.encrypt_from_samples`` from the
arrays the JAX package draws (``jax_rgsw_sample`` mirrors rgsw.encrypt's key
split: (k0, k1), then one split a gadget row); the ciphertexts it
encrypts come from JAX's draws too.  ``tools/port_circuit_digests.py
test_torch_rgsw`` pins the JAX package's RGSW ciphertexts, inputs and
external products (``DIGESTS``); the port's must equal them bit for bit,
and decrypt within the JAX tests' bounds.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rgsw as jrgsw
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.ops import automorphism as tam
from matrix_fhe_tpu_torch.rgsw import rgsw as trgsw
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe.elements import Plaintext
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from matrix_fhe_tpu_torch.schemes.ckks import precision
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

MONOMIAL = 5


def jax_rgsw_sample(key, jp, rows: int) -> trgsw.RGSWSample:
    """The draws of the JAX package's rgsw.encrypt(key, params, sk, pt):
    (k0, k1) = split(key), then each gadget's rows as an evaluation key's."""
    k0, k1 = jax.random.split(key)
    return trgsw.RGSWSample(g0=evk_draws(k0, jp, rows), g1=evk_draws(k1, jp, rows))


def _literals(m):
    """(tests/test_rgsw.py's literal, tests/test_base2.py's P-less one)."""
    return (m.CKKSParametersLiteral(logn=7, logq=(55, 45, 45), logp=(60,), log_default_scale=40),
            m.CKKSParametersLiteral(logn=6, logq=(45, 45, 45), logp=(), log_default_scale=40))


def _inputs(slots7, slots6):
    return {"scalar": np.random.default_rng(0).uniform(-1, 1, slots7) + 0j,
            "monomial": np.random.default_rng(1).uniform(-1, 1, slots7) + 0j,
            "base2": np.random.default_rng(3).uniform(-1, 1, slots6)}


def jax_context():
    import jax.numpy as jnp
    lit7, lit6 = _literals(jckks)
    p7, p6 = jckks.new_parameters(lit7), jckks.new_parameters(lit6)
    sk7 = JK.gen_secret_key(jax.random.key(0), p7)
    sk6 = JK.gen_secret_key(jax.random.key(0), p6)
    v = _inputs(p7.max_slots, p6.max_slots)
    enc7, enc6 = jckks.Encoder(p7), jckks.Encoder(p6)
    rq = p7.ring_q
    pt = jnp.zeros((len(p7.q), p7.n), dtype=jnp.uint64).at[:, MONOMIAL].set(1)
    evkp = JK.EvaluationKeyParameters(level_p=-1, base_two_decomposition=12)
    return SimpleNamespace(
        params={"scalar": p7, "monomial": p7, "base2": p6},
        rg={"scalar": jrgsw.encrypt_plaintext(jax.random.key(4), p7, sk7, 3),
            "monomial": jrgsw.encrypt(jax.random.key(6), p7, sk7, rq.mform(rq.ntt(pt))),
            "base2": jrgsw.encrypt_plaintext(jax.random.key(1), p6, sk6, 3, evkp)},
        ct={"scalar": jenc.encrypt(jax.random.key(3), p7, sk7, enc7.encode(v["scalar"])),
            "monomial": jenc.encrypt(jax.random.key(5), p7, sk7, enc7.encode(v["monomial"])),
            "base2": jenc.encrypt(jax.random.key(3), p6, sk6, enc6.encode(v["base2"]))})


def port_context():
    lit7, lit6 = _literals(jckks)
    jp7, jp6 = jckks.new_parameters(lit7), jckks.new_parameters(lit6)
    p7, p6 = carry.carry(jp7, "cpu"), carry.carry(jp6, "cpu")
    sk7, sk6 = (TK.secret_key_from_sample(p, _w(_SAMPLE(jax.random.key(0), jp.ring_q, jp.xs)))
                for p, jp in ((p7, jp7), (p6, jp6)))
    v = _inputs(p7.max_slots, p6.max_slots)
    enc7, enc6 = tckks.Encoder(p7), tckks.Encoder(p6)
    rq = p7.ring_q
    pt = torch.zeros((len(p7.q), p7.n), dtype=torch.int64)
    pt[:, MONOMIAL] = 1
    evkp = TK.EvaluationKeyParameters(level_p=-1, base_two_decomposition=12)
    rows7, rows6 = trgsw._num_rows(p7, None), trgsw._num_rows(p6, evkp)

    def encrypt(key, p, jp, sk, enc, vals):
        return tenc.encrypt_from_sample(p, sk, enc.encode(vals),
                                        sk_draws(jax.random.key(key), jp, p.max_level))
    return SimpleNamespace(
        params={"scalar": p7, "monomial": p7, "base2": p6},
        sk={"scalar": sk7, "monomial": sk7, "base2": sk6},
        enc={"scalar": enc7, "monomial": enc7, "base2": enc6}, v=v,
        rg={"scalar": trgsw.encrypt_plaintext_from_samples(
                p7, sk7, 3, jax_rgsw_sample(jax.random.key(4), jp7, rows7)),
            "monomial": trgsw.encrypt_from_samples(
                p7, sk7, rq.mform(rq.ntt(pt)), jax_rgsw_sample(jax.random.key(6), jp7, rows7)),
            "base2": trgsw.encrypt_plaintext_from_samples(
                p6, sk6, 3, jax_rgsw_sample(jax.random.key(1), jp6, rows6), evkp)},
        ct={"scalar": encrypt(3, p7, jp7, sk7, enc7, v["scalar"]),
            "monomial": encrypt(5, p7, jp7, sk7, enc7, v["monomial"]),
            "base2": encrypt(3, p6, jp6, sk6, enc6, v["base2"])})


def _product(name):
    def case(m, c):
        rg = c.rg[name]
        parts = [g for gc in (rg.g0, rg.g1) for g in (gc.q, gc.p) if g is not None]
        return parts + [c.ct[name], m.rgsw.external_product(c.params[name], c.ct[name], rg)]
    return case


CASES = {name: _product(name) for name in ("scalar", "monomial", "base2")}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "scalar": "2d8bc330ac6fa348c8d60e3b3a17143c2cdc0df8aaec98b313277017342c3631",
    "monomial": "9c1c2636d883afc00fa09cca8c8e18b1c0974de869755ba5e3a02a35dce5d64a",
    "base2": "7f82277e888412efd09eb3eecb866aa146c8984bcf8bfe2c6997d4af7ee87e0b",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def _decode(c, name, ct):
    return c.enc[name].decode(tdec.decrypt(c.params[name], c.sk[name], ct))


def test_external_product_scalar(ctx):
    """tests/test_rgsw.py:23: RGSW(3) x ct ~= 3 ct, 12 bits."""
    out = check_case(CASES, DIGESTS, "scalar", ctx)[-1]
    precision.assert_precision(3 * ctx.v["scalar"], _decode(ctx, "scalar", out), 12)


def test_external_product_monomial(ctx):
    """tests/test_rgsw.py:35: RGSW(X^5) x ct = the negacyclic shift, 12 bits."""
    out = check_case(CASES, DIGESTS, "monomial", ctx)[-1]
    params = ctx.params["monomial"]
    rq = params.ring_q
    ptd = tdec.decrypt(params, ctx.sk["monomial"], ctx.ct["monomial"])
    want_poly = tam.mult_by_monomial(rq, rq.intt(ptd.value), MONOMIAL)
    want = ctx.enc["monomial"].decode(Plaintext(value=rq.ntt(want_poly), metadata=ptd.metadata))
    precision.assert_precision(want, _decode(ctx, "monomial", out), 12)


def test_rgsw_external_product_base2(ctx):
    """tests/test_base2.py:97: a P-less base-two RGSW(3), B = 12, 10 bits."""
    rg = ctx.rg["base2"]
    assert rg.g0.base_two == 12 and rg.g0.p is None
    out = check_case(CASES, DIGESTS, "base2", ctx)[-1]
    got = _decode(ctx, "base2", out)
    assert -np.log2(np.mean(np.abs(got - 3 * ctx.v["base2"])) + 1e-30) > 10
    with pytest.raises(ValueError, match="samples"):
        trgsw.encrypt_from_samples(ctx.params["base2"], ctx.sk["base2"],
                                   ctx.rg["base2"].g0.q[0, 0], trgsw.RGSWSample(g0=[], g1=[]))

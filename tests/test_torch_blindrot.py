"""PyTorch port, blind rotation (rgsw/blindrot.py): sign(x) by blind-rotating
a test polynomial, at examples/rgsw_blind_rotation.py's sizes (ring logN 8,
one 25-bit Q and one 29-bit P prime; LWE logN 5, one 13-bit prime, a
secret of Hamming weight 8; the slots -0.75, -0.3, 0.4, 0.8) and, slow as
tests/test_blindrot.py:24 marks it, at that test's (ring logN 9 with 27 +
31-bit primes; LWE logN 6, 14-bit, weight 16; -0.75, -0.5, 0, 0.5).

The blind-rotation keys are made by ``evaluation_key_from_samples`` from the
arrays the JAX package draws (``jax_blindrot_samples`` mirrors
gen_evaluation_key's key split), and the LWE ciphertext from JAX's draws
too.  ``tools/port_circuit_digests.py test_torch_blindrot`` pins the JAX
package's test polynomial, keys, ciphertext and ``evaluate`` outputs
(``DIGESTS``): the port's must equal JAX's, and ``evaluate`` on its keys
(JAX's keys, bit for bit) must equal JAX's ``evaluate``; each decrypted
slot must lie within 0.1 of sign(x), the JAX test's bound.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu.rgsw import blindrot as jbr
from matrix_fhe_tpu.rgsw import rgsw as jrgsw
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.utils import primes as jpr
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rgsw import blindrot as tbr
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
from test_torch_matrix_ckks import _SAMPLE, galois_draws, sk_draws
from test_torch_polynomial import check_case, digest
from test_torch_rgsw import jax_rgsw_sample
from test_torch_rlwe import _w

SLOTS = 4
BOUND = 0.1
# (ring logN, Q bits, P bits; LWE logN, bits, Hamming weight; the slots)
SIZES = {"example": (8, 25, 29, 5, 13, 8, (-0.75, -0.3, 0.4, 0.8)),
         "test": (9, 27, 31, 6, 14, 16, (-0.75, -0.5, 0.0, 0.5))}


def sign(x: float) -> float:
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def jax_parameters(size: str):
    logn, qb, pb, logn_lwe, qb_lwe, h, _ = SIZES[size]
    n_br, n_lwe = 1 << logn, 1 << logn_lwe
    q_br = jpr.NTTFriendlyPrimesGenerator(qb, 2 * n_br).next_alternating_primes(1)
    p_br = jpr.NTTFriendlyPrimesGenerator(pb, 2 * n_br).next_alternating_primes(1)
    q_lwe = jpr.NTTFriendlyPrimesGenerator(qb_lwe, 2 * n_lwe).next_alternating_primes(1)
    return (jrlwe.new_parameters(jrlwe.ParametersLiteral(logn=logn, q=tuple(q_br), p=tuple(p_br))),
            jrlwe.new_parameters(jrlwe.ParametersLiteral(logn=logn_lwe, q=tuple(q_lwe),
                                                         xs=jsmp.Ternary(h=h))))


def lwe_coeffs(values, q: int, n: int) -> np.ndarray:
    """The slots at scale q / 4 in the first coefficients (the examples'
    encoding), int64 [1, n]."""
    coeffs = np.zeros((1, n), dtype=np.int64)
    for i, v in enumerate(values):
        c = int(round(abs(v) * q / 4.0))
        coeffs[0, i] = (q - c) % q if v < 0 else c
    return coeffs


def jax_blindrot_samples(key, jp_br, jp_lwe) -> tbr.BlindRotationSamples:
    """The draws of the JAX package's gen_evaluation_key(key, ...): one split
    a LWE coefficient, each an rgsw.encrypt's, then one for the galois keys."""
    brks = []
    for _ in range(jp_lwe.n):
        key, sub = jax.random.split(key)
        brks.append(jax_rgsw_sample(sub, jp_br, 1))
    key, sub = jax.random.split(key)
    return tbr.BlindRotationSamples(brks=brks, gks=galois_draws(
        sub, jp_br, tbr.galois_elements(jp_br), 1))


def jax_context():
    out = {}
    for size, (*_, values) in SIZES.items():
        pb, pl = jax_parameters(size)
        k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
        sk_br, sk_lwe = JK.gen_secret_key(k0, pb), JK.gen_secret_key(k1, pl)
        coeffs = lwe_coeffs(values, pl.q[0], pl.n).astype(np.uint64)
        pt = jrlwe.Plaintext(value=pl.ring_q.ntt(jax.numpy.asarray(coeffs)),
                             metadata=jrlwe.MetaData(is_ntt=True))
        out[size] = SimpleNamespace(
            params_br=pb, params_lwe=pl, brk=jbr.gen_evaluation_key(k2, pb, sk_br, pl, sk_lwe),
            test_poly=jbr.init_test_polynomial(sign, pb.q[0] / 4.0, pb, -1, 1),
            ct=jenc.encrypt(jax.random.key(3), pl, sk_lwe, pt))
    return out


def port_context(size: str):
    jb, jl = jax_parameters(size)
    pb, pl = carry.carry(jb, "cpu"), carry.carry(jl, "cpu")
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    sk_br = TK.secret_key_from_sample(pb, _w(_SAMPLE(k0, jb.ring_q, jb.xs)))
    sk_lwe = TK.secret_key_from_sample(pl, _w(_SAMPLE(k1, jl.ring_q, jl.xs)))
    samples = jax_blindrot_samples(k2, jb, jl)
    values = SIZES[size][-1]
    coeffs = torch.from_numpy(lwe_coeffs(values, pl.q[0], pl.n))
    pt = Plaintext(value=pl.ring_q.ntt(coeffs), metadata=MetaData(is_ntt=True))
    return SimpleNamespace(
        params_br=pb, params_lwe=pl, sk_br=sk_br, sk_lwe=sk_lwe, samples=samples,
        brk=tbr.evaluation_key_from_samples(pb, sk_br, pl, sk_lwe, samples),
        test_poly=tbr.init_test_polynomial(sign, pb.q[0] / 4.0, pb, -1, 1),
        ct=tenc.encrypt_from_sample(pl, sk_lwe, pt, sk_draws(jax.random.key(3), jl, 0)),
        values=values)


def _keys(brk):
    gks = [brk.gks[g].gadget for g in sorted(brk.gks)]
    return [g for r in brk.brks for gc in (r.g0, r.g1) for g in (gc.q, gc.p)] + [
        g.q for g in gks] + [g.p for g in gks]


def _evaluate(m, c):
    ev = m.blindrot.Evaluator(c.params_br, c.params_lwe)
    out = ev.evaluate(c.ct, {i: c.test_poly for i in range(SLOTS)}, c.brk)
    return [out[i] for i in range(SLOTS)]


CASES = {f"{size} {what}": (lambda fn, size: lambda m, ctx: fn(m, ctx[size]))(fn, size)
         for size in SIZES
         for what, fn in (("keys", lambda m, c: _keys(c.brk)),
                          ("test_poly", lambda m, c: [c.test_poly]),
                          ("ct", lambda m, c: [c.ct]), ("evaluate", _evaluate))}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "example keys": "65be7e1b79ea19f44515fe6988e989f521f2fe954d4797d5397c15cd8727eae9",
    "example test_poly": "6c78f9ad4a96474759724a62c0354e0906351570cd212ea1bbf0c2460131ee73",
    "example ct": "7c9ad6beb3987ad09076b6a68286b722cbb29ba23ba6e3005b2e9d9dd296e014",
    "example evaluate": "a9541b10dba6d964a5097db209e9a6811f72168713334338c4bd334e514fa793",
    "test keys": "8ae29fee138b52583045f41cbd5ad54caa92b3ae7332f28ed116d0ad9aa4b2be",
    "test test_poly": "757ca94455a75c9218ac9ba5808bcf7165f51bf975d21d2c4ad88687057531be",
    "test ct": "d4b68ea1e43e23f95a83be60514d40396b7ce632afd540b27f9799b485e46ccb",
    "test evaluate": "5b6bb9ad8419d1914cd532eb4e8be53f83638ca418e57ea150ab17a7ace44ea3",
}


def _check(size):
    c = port_context(size)
    ctx = {size: c}
    # the test polynomial equals JAX's; the keys from JAX's draws equal JAX's
    for what in ("test_poly", "keys", "ct"):
        check_case(CASES, DIGESTS, f"{size} {what}", ctx)
    assert sorted(c.brk.gks) == sorted(tbr.galois_elements(c.params_br))
    # JAX's keys go through carry as JAX objects and come back equal
    jbrk = jbr.BlindRotationKeys(
        brks=[jrgsw.RGSWCiphertext(*(JK.GadgetCiphertext(q=_u(g.q), p=_u(g.p))
                                     for g in (r.g0, r.g1))) for r in c.brk.brks],
        gks={g: JK.GaloisKey(gadget=JK.GadgetCiphertext(q=_u(k.gadget.q), p=_u(k.gadget.p)),
                             gal_el=g) for g, k in c.brk.gks.items()})
    assert digest(_keys(carry.carry(jbrk, "cpu"))) == DIGESTS[f"{size} keys"]
    # evaluate on JAX's keys equals JAX's evaluate, and decrypts to sign(x)
    outs = check_case(CASES, DIGESTS, f"{size} evaluate", ctx)
    pb = c.params_br
    for i, out in enumerate(outs):
        ptd = tdec.decrypt(pb, c.sk_br, out)
        dec = crt_reconstruct_centered(pb.ring_q.intt(ptd.value).numpy(), pb.q)
        got = float(dec[0]) / (pb.q[0] / 4.0)
        assert abs(got - sign(c.values[i])) < BOUND, (i, got, c.values[i])
    return c


def _u(t):
    """A port tensor as the JAX package's uint64 array."""
    return jax.numpy.asarray(t.numpy().view(np.uint64))


def test_blind_rotation_sign_example():
    """examples/rgsw_blind_rotation.py's sizes: ring logN 8, LWE logN 5."""
    c = _check("example")
    ev = tbr.Evaluator(c.params_br, c.params_lwe)
    # the schedule runs one external product a nonzero mask coefficient
    _, masks = ev.lwe_samples(c.ct, range(SLOTS))
    for a in masks.values():
        steps = ev.schedule(a)
        assert sum(k == "product" for k, _ in steps) == int(np.count_nonzero(a))
    with pytest.raises(ValueError, match="RGSW samples"):
        tbr.evaluation_key_from_samples(c.params_br, c.sk_br, c.params_lwe, c.sk_lwe,
                                        tbr.BlindRotationSamples(brks=[], gks={}))


@pytest.mark.slow
def test_blind_rotation_sign():
    """tests/test_blindrot.py's sizes: ring logN 9, LWE logN 6."""
    _check("test")

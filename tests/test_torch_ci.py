"""PyTorch port, the conjugate-invariant (CI) ring Z[X + X^-1]/(X^2N + 1) and
CKKS over it (N real slots): held bit-exact against the JAX package.

* The CI ring's tables and NTT both ways: tests/test_ntt.py:65's cases
  (N = 16 and 128 against tests/oracle.py's reference) and JAX's jitted
  transform; and the re-indexed tables kernel B4 runs the CI stages with,
  in a numpy model of B4's stage order (the standard butterflies over the
  table T[j] = psi[j + 2^floor(log2 j)], with the fold around them).
* CKKS at logN 7 on the CI ring: tests/test_ckks.py's CI cases (encode and
  decode, encryption under sk and pk, add and sub, mul with and without
  relinearization, the plaintext and constant products, the accumulating
  products), plus one rotation.  The port's keys and ciphertexts are
  computed from the arrays the JAX package draws (tests/
  test_torch_matrix_ckks.py's helpers); the JAX side of the keys,
  the encryptions and the operations runs in ``tools/port_circuit_digests.py
  test_torch_ci``, which pins their sha256 here (``DIGESTS``).  The encoder
  and decoder run live on both sides (host numpy on equal limbs).
"""

from fractions import Fraction
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import oracle
from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.ops import automorphism as jam
from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.ops import rings as jr
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu.utils import primes as jp
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch import rlwe as trlwe
from matrix_fhe_tpu_torch.ops import automorphism as tam
from matrix_fhe_tpu_torch.ops import rings as tr
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from test_torch_polynomial import check_case
from test_torch_rings import _eq, _t
from test_torch_matrix_ckks import (_SAMPLE, evk_draws, galois_draws, pk_draws, sk_draws,
                                    zero_draws)
from test_torch_rlwe import _w, eq

CI = jr.CONJUGATE_INVARIANT


def _ci_rings(n, moduli):
    return jr.new_ring(n, moduli, CI), tr.new_ring(n, moduli, CI, device="cpu")


@pytest.mark.parametrize("n", [16, 128])
def test_ntt_conjugate_invariant_bit_exact(n):
    """tests/test_ntt.py:65 on the port, and against JAX's transform."""
    moduli = jp.NTTFriendlyPrimesGenerator(40, 4 * n).next_alternating_primes(2)
    jring, ring = _ci_rings(n, moduli)
    assert (ring.nth_root, ring.ring_type) == (4 * n, CI)
    for name in ("moduli", "qinv", "bhi", "blo", "ninv", "roots_fwd", "roots_bwd", "rescale"):
        _eq(getattr(ring, name), getattr(jring, name))
    x = np.stack([np.random.default_rng(3).integers(0, q, n, dtype=np.uint64) for q in moduli])
    got = ring.ntt(_t(x))
    for i, q in enumerate(moduli):
        qinv, bc = jm.gen_mred_constant(q), jm.gen_bred_constant(q)
        roots = [int(v) for v in np.asarray(jring.roots_fwd[i])]
        want = oracle.ntt_ci([int(v) for v in x[i]], q, qinv, bc, roots)
        np.testing.assert_array_equal(got[i].numpy(), np.array(want, dtype=np.int64))
    back = ring.intt(got)
    for i, q in enumerate(moduli):
        want = oracle.intt_ci([int(v) for v in got[i].tolist()], q, jm.gen_mred_constant(q),
                              int(np.asarray(jring.ninv[i])),
                              [int(v) for v in np.asarray(jring.roots_bwd[i])])
        np.testing.assert_array_equal(back[i].numpy(), np.array(want, dtype=np.int64))
    assert torch.equal(back, _t(x))
    y = np.stack([np.random.default_rng(4).integers(0, q, (2, n), dtype=np.uint64)
                  for q in moduli], axis=-2)
    _eq(ring.ntt(_t(y)), jax.jit(jr.Ring.ntt)(jring, jm.u64(y)))
    _eq(ring.intt(_t(y)), jax.jit(jr.Ring.intt)(jring, jm.u64(y)))


@pytest.mark.parametrize("n", [16, 256])
def test_b4_tables_run_the_ci_stages(n):
    """B4 reads entry 2^s + i of its table at stage s, as the standard
    transform does; on the re-indexed CI table, in Montgomery form, the
    standard stages around the fold are the CI transform, and B4's inverse
    with the scale 1 (``ninv_plain``), then the fold, is the CI inverse."""
    moduli = jp.NTTFriendlyPrimesGenerator(50, 4 * n).next_alternating_primes(2)
    ring = tr.new_ring(n, moduli, CI, device="cpu")
    q = ring.moduli[:, None]
    for plain, shoup, mont_roots in ((ring.psi2[..., 0], ring.psi2[..., 1], ring.roots_fwd),
                                     (ring.ipsi2[..., 0], ring.ipsi2[..., 1], ring.roots_bwd)):
        idx = [j + (1 << (j.bit_length() - 1)) for j in range(1, n)]
        # the plain powers behind the Montgomery table, re-indexed
        want = tr.mm.imform(mont_roots[:, idx], q, ring.qinv[:, None])
        assert torch.equal(plain[:, 1:], want)
        hi = [(int(w) << 64) // int(m) for w, m in zip(plain[:, 1:].flatten().tolist(),
                                                     q.repeat(1, n - 1).flatten().tolist())]
        np.testing.assert_array_equal(shoup[:, 1:].flatten().numpy().view(np.uint64),
                                      np.array(hi, dtype=np.uint64))
    assert ring.ninv_plain.tolist() == [1, 1]
    x = _t(np.stack([np.random.default_rng(n).integers(0, m, (3, n), dtype=np.uint64)
                     for m in moduli], axis=-2))
    tab_f = ring.mform(ring.psi2[..., 0])
    tab_b = ring.mform(ring.ipsi2[..., 0])
    one = ring.mform(torch.ones_like(ring.ninv_plain)[:, None])[:, 0]
    fwd = tr._ntt_standard(tr.ci_fold(x, ring, inverse=False), tab_f, ring.moduli, ring.qinv)
    assert torch.equal(fwd, ring.ntt(x))
    bwd = tr.ci_fold(tr._intt_standard(x, tab_b, one, ring.moduli, ring.qinv), ring, True)
    assert torch.equal(bwd, ring.intt(x))


def test_ci_parameters_and_automorphisms():
    lit = dict(logn=5, logq=(50, 40), logp=(55,), ring_type=CI)
    jparams = jrlwe.new_parameters(jrlwe.ParametersLiteral(**lit))
    params = carry.carry(jparams, "cpu")
    mine = trlwe.new_parameters(carry.carry(jrlwe.ParametersLiteral(**lit), "cpu"), "cpu")
    assert (mine.q, mine.p, mine.nth_root) == (jparams.q, jparams.p, jparams.nth_root) == (
        params.q, params.p, 4 * 32)
    with pytest.raises(ValueError, match="conjugate-invariant"):
        params.galois_element_inverse()
    # the coefficient-domain automorphism through the 2N cover, and the NTT one
    x = np.stack([np.random.default_rng(7).integers(0, q, 32, dtype=np.uint64)
                  for q in jparams.q])
    for g in (5, 25, 3):
        _eq(tam.automorphism_coeff(params.ring_q, _t(x), g),
            jam.automorphism_coeff(jparams.ring_q, jm.u64(x), g))
        np.testing.assert_array_equal(
            tam.ntt_index(CI, 32, 128, g), jam.automorphism_ntt_index(32, 128, g))


# -- CKKS on the CI ring at logN 7: tests/test_ckks.py's CI parameters ----------

LIT = dict(logn=7, logq=(55, 45, 45, 45), logp=(60,), log_default_scale=45, ring_type=CI)
ENC_KEYS = (10, 11, 12, 13)   # the sk encryptions of VALUES[0..3]
PK_KEY = 20                   # the pk encryption of VALUES[0]


def _values(n):
    return [np.random.default_rng(s).uniform(-1, 1, n) + 0j for s in range(4)]


def _seeds():
    return jax.random.split(jax.random.key(0), 4)  # sk, pk, rlk, galois keys


def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(**LIT))
    ks, kp, kr, kg = _seeds()
    sk = JK.gen_secret_key(ks, params)
    pk = JK.gen_public_key(kp, params, sk)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gks = JK.gen_galois_keys(kg, params, sk, [params.galois_element(1)])
    enc = jckks.Encoder(params)
    vals = _values(params.max_slots)
    cts = [jenc.encrypt(jax.random.key(k), params, sk, enc.encode(v))
           for k, v in zip(ENC_KEYS, vals)]
    cts.append(jenc.encrypt(jax.random.key(PK_KEY), params, pk, enc.encode(vals[0])))
    return SimpleNamespace(params=params, sk=sk, pk=pk, rlk=rlk, gks=gks, enc=enc, cts=cts,
                           ev=jckks.Evaluator(params, rlk=rlk, galois_keys=gks), vals=vals)


def port_context():
    jparams = jckks.new_parameters(jckks.CKKSParametersLiteral(**LIT))
    params = carry.carry(jparams, "cpu")
    rows = params.base_rns_decomposition_vector_size(params.max_level)
    ks, kp, kr, kg = _seeds()
    sk = TK.secret_key_from_sample(params, _w(_SAMPLE(ks, jparams.ring_q, jparams.xs)))
    pk = TK.public_key_from_sample(params, sk, zero_draws(kp, jparams))
    rlk = TK.relinearization_key_from_samples(params, sk, evk_draws(kr, jparams, rows))
    g = params.galois_element(1)
    gks = {g: TK.galois_key_from_samples(params, sk, g,
                                         galois_draws(kg, jparams, [g], rows)[g])}
    enc = tckks.Encoder(params)
    vals = _values(params.max_slots)
    level = params.max_level
    cts = [tenc.encrypt_from_sample(params, sk, enc.encode(v),
                                    sk_draws(jax.random.key(k), jparams, level))
           for k, v in zip(ENC_KEYS, vals)]
    cts.append(tenc.encrypt_from_sample(params, pk, enc.encode(vals[0]),
                                        pk_draws(jax.random.key(PK_KEY), jparams, level)))
    return SimpleNamespace(params=params, sk=sk, pk=pk, rlk=rlk, gks=gks, enc=enc, cts=cts,
                           ev=tckks.Evaluator(params, rlk=rlk, galois_keys=gks),
                           jparams=jparams, vals=vals)


def _ops(m, c):
    """tests/test_ckks.py's CI operations, and one rotation."""
    ev, (a, b, r, _, _) = c.ev, c.cts
    pt = c.enc.encode(c.vals[1])
    res = ev.mul_relin(r, b)
    return [ev.add(a, b), ev.sub(a, b), ev.add(a, pt), ev.mul_relin(a, b),
            ev.rescale(ev.mul_relin(a, b)), ev.rescale(ev.mul(a, b)),
            ev.rescale(ev.mul_plain(a, pt)), ev.rescale(ev.mul_const(a, 1.5)),
            ev._mul_integer(a, 3), ev.mul_relin_then_add(a, b, res), ev.mul_then_add(a, b, res),
            ev.mul_then_add(a, pt, res), ev.mul_const_then_add(a, 0.5 + 0.0j, res),
            ev.rotate(a, 1), ev.add_const(a, 0.25), c.enc.embed_qp(c.vals[0], 2, 0)]


def _keys(m, c):
    out = [c.sk.value.q, c.sk.value.p, c.pk.value[0].q, c.pk.value[0].p, c.pk.value[1].q,
           c.pk.value[1].p, c.rlk.gadget.q, c.rlk.gadget.p]
    return out + [c.gks[g].gadget.q for g in sorted(c.gks)] + [
        c.gks[g].gadget.p for g in sorted(c.gks)]


CASES = {"keys": _keys, "encrypt": lambda m, c: c.cts, "ops": _ops}

DIGESTS = {
    "keys": "7abf747beaac4918cca9609612277a2efd95521e3e74a153f4e00c1a9b81f27b",
    "encrypt": "0816a9474b8abf79b55c8a14477ee12c62a20934b3b757719251a48ec4596d8b",
    "ops": "1f8bc23a8e4f52d02bfdb5b5466d560d8660a596cbd0dd35dad2c4bcf2200edb",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


@pytest.fixture(scope="module")
def ops(ctx):
    return check_case(CASES, DIGESTS, "ops", ctx)


def _dec(c, ct):
    return c.enc.decode(tdec.decrypt(c.params, c.sk, ct))


def _prec(want, got, bits):
    tckks.precision.assert_precision(want, got, bits)


def test_ckks_ci_keys_and_encryption(ctx):
    """tests/test_ckks.py:51-67 (CI): the keys and ciphertexts equal JAX's,
    and decrypt (sk and pk)."""
    c = ctx
    assert c.params.max_slots == c.params.n == 128
    check_case(CASES, DIGESTS, "keys", c)
    check_case(CASES, DIGESTS, "encrypt", c)
    _prec(c.vals[0], _dec(c, c.cts[0]), 25)
    _prec(c.vals[0], _dec(c, c.cts[4]), 20)


def test_ckks_ci_encode_decode(ctx):
    """The encoder's limbs and decoded float64 values equal JAX's."""
    c = ctx
    jenc_ = jckks.Encoder(c.jparams)
    v = c.vals[0]
    pt = c.enc.encode(v, is_ntt=False)
    eq(pt, jenc_.encode(v, is_ntt=False))
    eq(c.enc.encode(v, level=1, scale=1 << 30, is_ntt=False),
       jenc_.encode(v, level=1, scale=1 << 30, is_ntt=False))
    got = c.enc.decode(pt)
    jpt = jrlwe.Plaintext(value=jax.numpy.asarray(pt.value.numpy().view(np.uint64)),
                          metadata=jrlwe.MetaData(scale=pt.scale, is_ntt=False))
    np.testing.assert_array_equal(got, jenc_.decode(jpt))
    _prec(v, c.enc.decode(c.enc.encode(v)), 30)


def test_ckks_ci_add_sub(ctx, ops):
    c = ctx
    v1, v2 = c.vals[:2]
    _prec(v1 + v2, _dec(c, ops[0]), 25)
    _prec(v1 - v2, _dec(c, ops[1]), 25)
    _prec(v1 + v2, _dec(c, ops[2]), 25)


def test_ckks_ci_mul_relin_rescale(ctx, ops):
    c = ctx
    v1, v2 = c.vals[:2]
    assert ops[3].degree == 1 and ops[4].level == c.params.max_level - 1
    _prec(v1 * v2, _dec(c, ops[4]), 20)
    _prec(v1 * v2, _dec(c, ops[5]), 20)
    _prec(v1 * v2, _dec(c, ops[6]), 20)
    assert ops[4].scale == Fraction(1 << 90, c.params.q[3])


def test_ckks_ci_mul_const_and_rotation(ctx, ops):
    c = ctx
    v = c.vals[0]
    _prec(v * 1.5, _dec(c, ops[7]), 20)
    _prec(v * 3, _dec(c, ops[8]), 20)
    _prec(np.roll(v, -1), _dec(c, ops[13]), 20)
    _prec(v + 0.25, _dec(c, ops[14]), 20)
    with pytest.raises(ValueError, match="conjugate-invariant"):
        c.ev.conjugate(c.cts[0])
    with pytest.raises(ValueError, match="complex"):
        c.ev.add_const(c.cts[0], 0.5j)


def test_ckks_ci_mul_then_add(ctx, ops):
    """tests/test_ckks.py:170 (CI)."""
    c = ctx
    va, vb, vr = c.vals[:3]
    want = vr * vb + va * vb
    _prec(want, _dec(c, ops[9]), 20)
    _prec(want, _dec(c, ops[10]), 20)
    _prec(want, _dec(c, ops[11]), 20)
    _prec(vr * vb + 0.5 * va, _dec(c, ops[12]), 20)

"""PyTorch port, Matrix-CKKS over the 3N ring (schemes/matrix_ckks, and the
RLWE keys, encryption and key switching on a MATRIX ring): every case of
tests/test_matrix_ckks.py, plus mul_relin and automorphism at the N = 48
example set, held bit-exact against the JAX package.

Randomness is not part of the contract, so the port's keys and ciphertexts
are computed from the arrays the JAX package draws (``zero_draws`` and the
helpers beside it, which the CI tests use too), and JAX's parameters and
literals are carried over by ``carry``.  The JAX side of the keys, the encryptions and
every operation runs once, in ``tools/port_circuit_digests.py
test_torch_matrix_ckks`` (JAX on the CPU, eager, as its own tests run), which
pins the sha256 of their limbs and scales here (``DIGESTS``); the port's
must hash to them.  The encoder and the decoder run live on both sides (host
numpy on equal limbs).  Decoded values are held to tests/test_matrix_ckks.py's
bounds against the plaintext model: the ring product mod X^N - X^{N/2} + 1
and the map X -> X^g.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import matrix_ckks as jmc
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import matrix_ckks as tmc
from test_torch_polynomial import check_case, digest
from test_torch_rlwe import _w, eq

# The sessions: a literal, the seed of its keys, the galois elements keyed
# (-1: 3N - 1), whether it has a relinearization key, and its inputs (the
# rng seed of the values, and the constant polynomial of test_mul).  The
# example set also serves tests/test_matrix_ckks.py's test_mul_relin_3n (the
# same chain, its own distributions) and test_automorphism_3n (the same
# element 5, one prime more): a session's JAX draws compile for seconds.
SESSIONS = {
    # example_parameters()[1] (N = 48), tests/test_matrix_ckks.py's ctx
    "example": dict(lit=lambda m: m.example_parameters()[1], seed=0, gal=(5, -1),
                    rlk=True, values=0),
    # test_mul_relin_3n_large_degree: N = 1152, the factorized transform only
    "large": dict(lit=lambda m: m.MatrixCKKSParametersLiteral(
        order2=7, order3=2, logq=(50, 40, 40), logp=(60,), log_default_scale=40),
        seed=4, gal=(), rlk=True, values=3),
}


def _gal_els(spec, n):
    return [3 * n - 1 if g == -1 else g for g in spec["gal"]]


def _keys(seed):
    return jax.random.split(jax.random.key(seed), 3)  # sk, rlk, galois keys


def _values(spec, n):
    rng = np.random.default_rng(spec["values"])
    const = np.zeros(n)
    const[0] = 0.75
    return [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), const]


def _enc_key(spec, i):
    return jax.random.key(100 * spec["seed"] + 10 + i)


def jax_context():
    """The JAX package's sessions, keys and ciphertexts from their seeds."""
    out = {}
    for name, spec in SESSIONS.items():
        params = jmc.new_parameters(spec["lit"](jmc))
        ks, kr, kg = _keys(spec["seed"])
        sk = JK.gen_secret_key(ks, params)
        rlk = JK.gen_relinearization_key(kr, params, sk) if spec["rlk"] else None
        gks = JK.gen_galois_keys(kg, params, sk, _gal_els(spec, params.n))
        enc = jmc.Encoder(params)
        cts = [jenc.encrypt(_enc_key(spec, i), params, sk, enc.encode(v))
               for i, v in enumerate(_values(spec, params.n))]
        out[name] = SimpleNamespace(params=params, sk=sk, rlk=rlk, gks=gks, cts=cts,
                                    ev=jmc.Evaluator(params))
    return out


# The JAX samplers, jitted one by one: each compiles once a shape (a few
# tenths of a second), where one jitted call of all a session's draws
# compiles for seconds.
_UNIFORM = jax.jit(jsmp.uniform_poly)
_SAMPLE = jax.jit(jsmp.sample, static_argnums=2)
_TERNARY = jax.jit(jsmp.ternary_poly, static_argnums=2)


def zero_draws(key, jp) -> TK.ZeroSample:
    """The draws of the JAX package's keys.encrypt_zero_qp (c1 drawn)."""
    k_a, k_e = jax.random.split(key)
    kq, kp = jax.random.split(k_a)
    a_p = None if jp.ring_p is None else _UNIFORM(kp, jp.ring_p)
    return TK.ZeroSample(a_q=_w(_UNIFORM(kq, jp.ring_q)), a_p=_w(a_p),
                         e=_w(_SAMPLE(k_e, jp.ring_q, jp.xe)))


def evk_draws(key, jp, rows: int) -> list[TK.ZeroSample]:
    """The draws of one gadget key's rows (keys._gen_evaluation_key_arrays)."""
    out = []
    for _ in range(rows):
        key, sub = jax.random.split(key)
        out.append(zero_draws(sub, jp))
    return out


def galois_draws(key, jp, gal_els, rows: int) -> dict:
    """The draws of keys.gen_galois_keys(key, params, sk, gal_els)."""
    out = {}
    for g in gal_els:
        key, sub = jax.random.split(key)
        out[g] = evk_draws(sub, jp, rows)
    return out


def sk_draws(key, jp, level: int) -> tenc.SkSample:
    """The draws of encryptor.encrypt_zero_sk(key, params, sk, level)."""
    rq = jp.ring_q.at_level(level)
    k1, k2 = jax.random.split(key)
    return tenc.SkSample(c1=_w(_UNIFORM(k1, rq)), e=_w(_SAMPLE(k2, rq, jp.xe)))


def pk_draws(key, jp, level: int) -> tenc.PkSample:
    """The draws of encryptor.encrypt_zero_pk(key, params, pk, level)."""
    rq = jp.ring_q.at_level(level)
    ku, k0, k1 = jax.random.split(key, 3)
    return tenc.PkSample(u=_w(_TERNARY(ku, rq, jp.xs)), e0=_w(_SAMPLE(k0, rq, jp.xe)),
                         e1=_w(_SAMPLE(k1, rq, jp.xe)))


def port_context():
    """The port's sessions: JAX's parameters carried, the keys and
    ciphertexts from JAX's draws."""
    out = {}
    for name, spec in SESSIONS.items():
        jp = jmc.new_parameters(spec["lit"](jmc))
        params = carry.carry(jp, "cpu")
        rows = params.base_rns_decomposition_vector_size(params.max_level)
        gal = _gal_els(spec, params.n)
        ks, kr, kg = _keys(spec["seed"])
        sk = TK.secret_key_from_sample(params, _w(_SAMPLE(ks, jp.ring_q, jp.xs)))
        rlk = TK.relinearization_key_from_samples(
            params, sk, evk_draws(kr, jp, rows)) if spec["rlk"] else None
        gdraws = galois_draws(kg, jp, gal, rows)
        gks = {g: TK.galois_key_from_samples(params, sk, g, gdraws[g]) for g in gal}
        enc = tmc.Encoder(params)
        values = _values(spec, params.n)
        cts = [tenc.encrypt_from_sample(params, sk, enc.encode(v),
                                        sk_draws(_enc_key(spec, i), jp, params.max_level))
               for i, v in enumerate(values)]
        out[name] = SimpleNamespace(params=params, sk=sk, rlk=rlk, gks=gks, cts=cts,
                                    ev=tmc.Evaluator(params), enc=enc, jparams=jp,
                                    values=values)
    return out


def _key_words(c):
    keys = [c.sk.value.q, c.sk.value.p]
    if c.rlk is not None:
        keys += [c.rlk.gadget.q, c.rlk.gadget.p]
    for g in sorted(c.gks):
        keys += [c.gks[g].gadget.q, c.gks[g].gadget.p]
    return keys


def _example_ops(m, c):
    ev, (a, b, k) = c.ev, c.cts
    prod = ev.mul(a, k)
    relin = ev.mul_relin(a, b, c.rlk)
    g5, conj = sorted(c.gks)
    return [ev.add(a, b), ev.sub(a, b), ev.mul_const(a, 0.5), ev.rescale(ev.mul_const(a, 0.5)),
            ev.drop_level(a), prod, ev.rescale(prod), ev.mul(a, b), relin, ev.rescale(relin),
            ev.automorphism(a, c.gks[g5]), ev.automorphism(a, c.gks[conj])]


CASES = {
    **{f"{name}: keys": (lambda n: lambda m, ctx: _key_words(ctx[n]))(name)
       for name in SESSIONS},
    **{f"{name}: encrypt": (lambda n: lambda m, ctx: ctx[n].cts)(name) for name in SESSIONS},
    "example: ops": lambda m, ctx: _example_ops(m, ctx["example"]),
    "large: mul_relin rescale": lambda m, ctx: ctx["large"].ev.rescale(
        ctx["large"].ev.mul_relin(*ctx["large"].cts[:2], ctx["large"].rlk)),
}

DIGESTS = {
    "example: keys": "a841f333e9c17ce34034d55c3a4ce44359769fc36ad030964750ce23ce8d2e8c",
    "large: keys": "e7172f5d0c5fa753fce827af4bd0ece19429f21e95537672c9fd10182dddb887",
    "example: encrypt": "e63ba98bb9ad10498c174e0849fadd963e4d72cb0b9a8d856dee57e81bcb7aee",
    "large: encrypt": "d8fdea68c98f075cdc6d876f4174088901cce484ef09beda9498d865e635ccda",
    "example: ops": "90e9e9cdbfdd0d84a7b33050fd474aca87c43e994ccb038d6b0995b162cd60f3",
    "large: mul_relin rescale": "5f2ba611978133b3fc88b2d5b20221ba42efb7fa7abbff61191f604b93bd2f43",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


@pytest.fixture(scope="module")
def example_ops(ctx):
    return check_case(CASES, DIGESTS, "example: ops", ctx)


def _decode(c, ct):
    return c.enc.decode(tdec.decrypt(c.params, c.sk, ct))


def ring_product(a, b):
    """a b mod X^N - X^{N/2} + 1, in float64."""
    n = len(a)
    prod = np.zeros(2 * n)
    for i in range(n):
        prod[i:i + n] += a[i] * b
    for k in range(n - 1, -1, -1):  # X^{N+k} = X^{N/2+k} - X^k
        c = prod[n + k]
        prod[n + k] = 0
        prod[k + n // 2] += c
        prod[k] -= c
    return prod[:n]


def automorphism_model(v, g):
    """v(X^g) mod X^N - X^{N/2} + 1: reduce with X^{3N/2} = -1, then with
    X^N = X^{N/2} - 1."""
    n = len(v)
    full = np.zeros(3 * n)
    for i in range(n):
        full[(i * g) % (3 * n)] += v[i]
    h = 3 * n // 2
    full[:h] -= full[h:]
    for e in range(h - 1, n - 1, -1):
        full[e - n + n // 2] += full[e]
        full[e - n] -= full[e]
    return full[:n]


@pytest.mark.parametrize("name", list(SESSIONS))
def test_parameters_and_keys(ctx, name):
    c = ctx[name]
    jp = c.jparams
    assert (c.params.n, c.params.nth_root, c.params.q, c.params.p, c.params.ring_type) == (
        jp.n, jp.nth_root, jp.q, jp.p, "matrix")
    assert c.params.log_default_scale == jp.log_default_scale
    lit = carry.carry(SESSIONS[name]["lit"](jmc), "cpu")
    assert lit == SESSIONS[name]["lit"](tmc)
    built = tmc.new_parameters(lit, device="cpu")
    assert (built.q, built.p, built.n) == (jp.q, jp.p, jp.n)
    # the JAX ring's factorized tables, carried
    if jp.ring_q.ntt3n is not None:
        eq(carry.carry(jp.ring_q.ntt3n, "cpu"), jp.ring_q.ntt3n)
    check_case(CASES, DIGESTS, f"{name}: keys", ctx)
    check_case(CASES, DIGESTS, f"{name}: encrypt", ctx)


def test_encode_decode(ctx):
    """tests/test_matrix_ckks.py:37, and JAX's encoder and decoder on the
    same values and limbs."""
    c = ctx["example"]
    jenc_ = jmc.Encoder(c.jparams)
    v = np.random.default_rng(0).uniform(-1, 1, c.params.n)
    pt = c.enc.encode(v)
    eq(pt, jenc_.encode(v))
    eq(c.enc.encode(v, level=1, scale=1 << 30), jenc_.encode(v, level=1, scale=1 << 30))
    got = c.enc.decode(pt)
    jpt = jrlwe.Plaintext(value=jax.numpy.asarray(pt.value.numpy().view(np.uint64)),
                          metadata=jrlwe.MetaData(scale=pt.scale, is_ntt=False))
    np.testing.assert_array_equal(got, jenc_.decode(jpt))
    np.testing.assert_allclose(got, v, atol=1e-6)


def test_encrypt_decrypt_add_mul_const(ctx, example_ops):
    """tests/test_matrix_ckks.py:44-64: decryption, add, mul_const then
    rescale, within 0.1."""
    c = ctx["example"]
    v1, v2, _ = c.values
    out = example_ops
    np.testing.assert_allclose(_decode(c, c.cts[0]), v1, atol=0.1)
    np.testing.assert_allclose(_decode(c, out[0]), v1 + v2, atol=0.1)
    np.testing.assert_allclose(_decode(c, out[1]), v1 - v2, atol=0.1)
    np.testing.assert_allclose(_decode(c, out[3]), 0.5 * v1, atol=0.1)
    assert out[3].level == c.params.max_level - 1 and out[4].level == c.params.max_level - 1


def test_mul(ctx, example_ops):
    """tests/test_matrix_ckks.py:67: ct x ct with a constant polynomial."""
    c = ctx["example"]
    out = example_ops
    np.testing.assert_allclose(_decode(c, out[6]), 0.75 * c.values[0], atol=0.1)
    assert out[7].degree == 2


def test_mul_relin_3n(ctx, example_ops):
    """tests/test_matrix_ckks.py:80 at the example set: mul_relin, then
    rescale, against the ring product."""
    c = ctx["example"]
    assert example_ops[8].degree == 1
    np.testing.assert_allclose(_decode(c, example_ops[9]), ring_product(*c.values[:2]),
                               atol=1e-3)


def test_automorphism_3n(ctx, example_ops):
    """tests/test_matrix_ckks.py:118 at the example set: X -> X^5, and the
    automorphism by 3N - 1."""
    c = ctx["example"]
    assert math.gcd(5, c.params.nth_root) == 1
    for ct, g in zip(example_ops[10:], sorted(c.gks)):
        np.testing.assert_allclose(_decode(c, ct), automorphism_model(c.values[0], g),
                                   atol=1e-3)


def test_mul_relin_3n_large_degree(ctx):
    """tests/test_matrix_ckks.py:151: N = 1152 through the factorized NTT."""
    c = ctx["large"]
    assert c.params.n == 1152 and c.params.ring_q.ntt3n is not None
    assert c.params.ring_q.dense3n is None
    out = check_case(CASES, DIGESTS, "large: mul_relin rescale", ctx)
    np.testing.assert_allclose(_decode(c, out), ring_product(*c.values[:2]), atol=2e-3)


def test_port_draws_decrypt(ctx):
    """The port's own draws (torch generators) at the example set."""
    c = ctx["example"]
    gen = torch.Generator().manual_seed(0)
    sk = TK.gen_secret_key(gen, c.params)
    rlk = TK.gen_relinearization_key(gen, c.params, sk)
    v1, v2, _ = c.values
    a, b = (tenc.encrypt(gen, c.params, sk, c.enc.encode(v)) for v in (v1, v2))
    out = c.ev.rescale(c.ev.mul_relin(a, b, rlk))
    dec = c.enc.decode(tdec.decrypt(c.params, sk, out))
    np.testing.assert_allclose(dec, ring_product(v1, v2), atol=1e-3)

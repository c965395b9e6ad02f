"""PyTorch port, the wide ring and step (fast/wring.py, wrns.py, wckks.py).

tests/test_wring.py's seven cases in both of its modes, at logN 8 on JAX's
keys and ciphertexts carried over: ``pair25`` on the exact PN14QP438 ladder
(55 + 45x5-bit Q, 55x2-bit P) and ``pair31`` on 60/45-bit Q and 61-bit P.
And ``bench61``: bench.py's wide61 moduli (its 60 + 45x5-bit Q and its
61-bit P, whose first prime lies above 2^61, where the u64 rings stop) at
logN 8, on the uniform keys and operands of ``make_synthetic_context`` from
one seed in both packages: the Q and P rings' ops and NTT, the rescale, the
tensor, the full step and hoisted rotations, each hashing to the JAX
package's digest.
Each case (ring ops and the NTT, the rescale, the tensor, the full
mul_relin_rescale step, a rotation, hoisted rotations, the step at a lower
level) runs over a namespace of modules: its outputs, as words, hash to the
digest of the JAX package's wide ring and step on the same inputs
(``DIGESTS``, tools/port_circuit_digests.py), and equal the port's u64
evaluator and ring limb for limb, as tests/test_wring.py holds the JAX
wide path to its u64 one; the full step decrypts to the product.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu.utils import primes as jpr
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.ops import rns_tools
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case
from test_torch_rlwe import eq

LOGN = 8
PN14QP438 = ([0x80000000080001, 0x2000000A0001, 0x2000000E0001, 0x2000001D0001,
              0x1FFFFFCF0001, 0x1FFFFFC20001], [0x80000000130001, 0x7FFFFFFFE90001])


def _session(mode):
    """tests/test_wring.py's setup of ``mode``: parameters, keys,
    ciphertexts of two vectors."""
    n = 1 << LOGN
    if mode == "pair25":
        Q, P = PN14QP438
    else:
        g60 = jpr.NTTFriendlyPrimesGenerator(60, 2 * n)
        g61 = jpr.NTTFriendlyPrimesGenerator(61, 2 * n)
        g45 = jpr.NTTFriendlyPrimesGenerator(45, 2 * n)
        Q = [g60.next_alternating_prime()] + g45.next_alternating_primes(5)
        P = g61.next_alternating_primes(2)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=LOGN, q=tuple(Q), p=tuple(P), log_default_scale=45))
    ks, kr, kg, k1, k2 = jax.random.split(jax.random.key(0), 5)
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    rot_el = params.galois_element(1)
    gks = JK.gen_galois_keys(kg, params, sk, [rot_el])
    enc = jckks.Encoder(params)
    rng = np.random.default_rng(0)
    v1 = rng.uniform(-1, 1, params.max_slots)
    v2 = rng.uniform(-1, 1, params.max_slots)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    cts = [encrypt(k, sk, jax_encode(enc, params, v)) for k, v in ((k1, v1), (k2, v2))]
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, gks=gks, cts=cts, v=(v1, v2),
                           rot_el=rot_el)


def jax_context():
    return SimpleNamespace(pair25=_session("pair25"), pair31=_session("pair31"))


def _ctx(m, s):
    """The wide context of session ``s``, made once."""
    if "wctx" not in s.__dict__:
        s.wctx = m.wckks.make_context(s.params, s.rlk, s.gks, rescale_limbs=1)
    return s.wctx


def _pair31(s):
    return JAX.wide.use_pair31(list(s.params.q) + list(s.params.p))


def pair(m, s, x):
    """u64-path words as the wide ring's operands: the JAX package's pairs,
    the port's words."""
    if m is not JAX:
        return x
    import jax.numpy as jnp
    x = np.asarray(x)
    return jnp.asarray(m.wide.pack_pair(x, s.params.q[: x.shape[-2]], _pair31(s)))


def words(m, s, y):
    if m is not JAX:
        return y
    y = np.asarray(y)
    return m.wide.unpack_pair(y, s.params.q[: y.shape[-2]], _pair31(s))


def _ring_ops(m, s):
    ctx = _ctx(m, s)
    rq, urq = ctx.ring_q, s.params.ring_q
    a_u, b_u = s.cts[0].value[0], s.cts[1].value[0]
    a, b = pair(m, s, a_u), pair(m, s, b_u)
    x = urq.intt(a_u)
    return [words(m, s, y) for y in (rq.add(a, b), rq.sub(a, b), rq.mul_coeffs_montgomery(a, b),
                                     rq.ntt(pair(m, s, x)), rq.intt(a))]


def _ops(m, s):
    return [pair(m, s, v) for v in (*s.cts[0].value, *s.cts[1].value)]


def _at_level(m, s):
    lvl = s.params.max_level - 2
    c2 = _ctx(m, s).at_level(lvl)
    ops = [pair(m, s, v[..., : lvl + 1, :]) for v in (*s.cts[0].value, *s.cts[1].value)]
    return [words(m, s, y) for y in m.wckks.mul_relin_rescale(c2, *ops)]


SESSION_CASES = {
    "ring_ops": _ring_ops,
    "rescale": lambda m, s: [words(m, s, m.wrns.div_round_by_last_modulus_many_ntt(
        _ctx(m, s).ring_q, pair(m, s, s.cts[0].value[0]), 1))],
    "tensor": lambda m, s: [words(m, s, y) for y in m.wckks.tensor(_ctx(m, s), *_ops(m, s))],
    "full_step": lambda m, s: [words(m, s, y) for y in m.wckks.mul_relin_rescale(
        _ctx(m, s), *_ops(m, s))],
    "rotation": lambda m, s: [words(m, s, y) for y in m.wckks.automorphism(
        _ctx(m, s), *_ops(m, s)[:2], s.rot_el)],
    "hoisted_rotations": lambda m, s: [words(m, s, y) for y in m.wckks.rotations_hoisted(
        _ctx(m, s), *_ops(m, s)[:2], [s.rot_el])[s.rot_el]],
    "at_level_step": _at_level,
}
MODES = ("pair25", "pair31")
CASES = {f"{name}[{mode}]": (lambda m, c, fn=fn, mode=mode: fn(m, getattr(c, mode)))
         for mode in MODES for name, fn in SESSION_CASES.items()}

# bench.py's wide61 moduli (make_synthetic_context(14, 6, 2, q_bits=(60,) +
# (45,) * 8, p_bits=61)): every prime is 1 mod 2^15, so they serve logN 8
BENCH61 = ((1152921504606748673, 35184372121601, 35184372744193, 35184373006337,
            35184371138561, 35184370941953), (2305843009214414849, 2305843009211662337))


def _bench61(m, c):
    """The synthetic wide context at BENCH61 and its four operands in the
    package of ``m``, made once."""
    cache = c.__dict__.setdefault("bench61", {})
    if id(m) not in cache:
        kw = {} if m is JAX else {"device": "cpu"}
        cache[id(m)] = m.wckks.make_synthetic_context(LOGN, 0, 0, moduli=BENCH61, seed=0,
                                                      num_rot=2, **kw)
    return cache[id(m)]


def _bwords(m, ring, y):
    """A wide ring's operand as words (the JAX package's pair31 pairs unpacked)."""
    if m is not JAX:
        return y
    y = np.asarray(y)
    return m.wide.unpack_pair(y, ring.moduli_tuple[: y.shape[-2]], True)


def _bench61_ring_ops(m, c):
    ctx, (c0, c1, _, _) = _bench61(m, c)
    out = []
    for ring, a, b in ((ctx.ring_q, c0, c1), (ctx.ring_p, ctx.rlk_p[0, 0], ctx.rlk_p[0, 1])):
        out += [_bwords(m, ring, y) for y in (
            ring.add(a, b), ring.sub(a, b), ring.mul_coeffs_montgomery(a, b), ring.ntt(a),
            ring.intt(a))]
    return out


BENCH_CASES = {
    "ring_ops": _bench61_ring_ops,
    "rescale": lambda m, c: [_bwords(m, _bench61(m, c)[0].ring_q,
                                     m.wrns.div_round_by_last_modulus_many_ntt(
                                         _bench61(m, c)[0].ring_q, _bench61(m, c)[1][0], 1))],
    "tensor": lambda m, c: [_bwords(m, _bench61(m, c)[0].ring_q, y)
                            for y in m.wckks.tensor(*_bench61(m, c)[:1], *_bench61(m, c)[1])],
    "full_step": lambda m, c: [_bwords(m, _bench61(m, c)[0].ring_q, y)
                               for y in m.wckks.mul_relin_rescale(*_bench61(m, c)[:1],
                                                                  *_bench61(m, c)[1])],
    "hoisted_rotations": lambda m, c: [
        _bwords(m, _bench61(m, c)[0].ring_q, y)
        for g, pair in sorted(m.wckks.rotations_hoisted(
            _bench61(m, c)[0], *_bench61(m, c)[1][:2], _bench61(m, c)[0].gal_els).items())
        for y in pair],
}
CASES.update({f"{name}[bench61]": fn for name, fn in BENCH_CASES.items()})

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "ring_ops[pair25]": "55c87b1ee530bf8a8c7562d92b1a579cdc6d2b8819d12931e8f612bef75076ea",
    "rescale[pair25]": "ffc1e617bc61d6f35e7cb0690e0e9b68ba8528490d638ea87ad7d182866ceb7d",
    "tensor[pair25]": "998e00f0ae690dad4ef4f8fb00ad35c868f33c202180c1444329fc70e5e3c0f9",
    "full_step[pair25]": "928f3337bcac23aedf9011cd418f4ce7e4d9f4a80c12329afe8b1bdc99a237c0",
    "rotation[pair25]": "4b7b00242e3af808328329e76d66733043841d194ac91d3a63b271eed12ab13d",
    "hoisted_rotations[pair25]": "4b7b00242e3af808328329e76d66733043841d194ac91d3a63b271eed12ab13d",
    "at_level_step[pair25]": "aced85b701fbaff2dd8b34b2207db07d92d583363727b6f938183b3be9402826",
    "ring_ops[pair31]": "cdd187adb370d37cd92a0a8831953a38743cb217ded3b43deac044b7891c5032",
    "rescale[pair31]": "d536e8a2f854a5815c87679b6e8220f8adb1a1886a01f78e38d16c2c3ec07dad",
    "tensor[pair31]": "f28fc3197fcf86d81aa9661321a6882db6d4d3ddc9c892f60c07a9417bc02f37",
    "full_step[pair31]": "1da5ce999d8d2d2744f99fc15f9bd39b512d8fd348a942c59d1a742918c77f54",
    "rotation[pair31]": "78cc96455c626765624404af640fa0bcef79bf2c69c8b11b3f06c287844b393b",
    "hoisted_rotations[pair31]": "78cc96455c626765624404af640fa0bcef79bf2c69c8b11b3f06c287844b393b",
    "at_level_step[pair31]": "a0d3e020da0b664df75d308693c91f6c052c29a76281bf69e0b94ffb6940cf4e",
    "ring_ops[bench61]": "3b9cab3ea27640f29e47bc457080aa757f1fa26c50e421bf99be3e8a1b9e6ea4",
    "rescale[bench61]": "a2714e1814f27ea83015af0a37a3d175fe30db75d570d5b3c7a19e1d4333ca75",
    "tensor[bench61]": "113c3d282643e2cf0f10b6f274ec435ad8df6d6ed9c037874d4baf744b14f56d",
    "full_step[bench61]": "ae4eb3e93c596bbafab1a088d0b8f4d887212a48a29f3c47eb949a96d695e1e7",
    "hoisted_rotations[bench61]": "4468ae09179e644d1a5378012d39c3e0de8db1a551a7ba11cb7379cbfe29e20b",
}


def _u64(name, s):
    """The port's u64 evaluator and ring on the same inputs: what each case
    must equal (tests/test_wring.py's references)."""
    ev = PORT.ckks.Evaluator(s.params, rlk=s.rlk, galois_keys=s.gks)
    urq = s.params.ring_q
    ct1, ct2 = s.cts
    a, b = ct1.value[0], ct2.value[0]
    if name == "ring_ops":
        x = urq.intt(a)
        return [urq.add(a, b), urq.sub(a, b), urq.mul_coeffs_montgomery(urq.mform(a), b),
                urq.ntt(x), x]
    if name == "rescale":
        return [rns_tools.div_round_by_last_modulus_ntt(urq, a)]
    if name == "tensor":
        return list(ev.mul(ct1, ct2).value)
    if name == "full_step":
        return list(ev.rescale(ev.mul_relin(ct1, ct2)).value)
    if name in ("rotation", "hoisted_rotations"):
        return list(ev.rotate(ct1, 1).value)
    lvl = s.params.max_level - 2
    ct1d, ct2d = (ev.drop_level(c, s.params.max_level - lvl) for c in (ct1, ct2))
    return list(ev.rescale(ev.mul_relin(ct1d, ct2d)).value)


@pytest.fixture(scope="module")
def ctx():
    j = jax_context()

    def session(s):
        return SimpleNamespace(v=s.v, rot_el=s.rot_el, **carry.carry(dict(
            params=s.params, sk=s.sk, rlk=s.rlk, gks=s.gks, cts=s.cts), "cpu"))

    return SimpleNamespace(jax=j, **{mode: session(getattr(j, mode)) for mode in MODES})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_wide_step(ctx, name, mode):
    got = check_case(CASES, DIGESTS, f"{name}[{mode}]", ctx)
    s = getattr(ctx, mode)
    eq(got, _u64(name, s))
    if name == "full_step":  # and it decrypts to the product
        ev = PORT.ckks.Evaluator(s.params, rlk=s.rlk)
        out = ev.rescale(ev.mul_relin(*s.cts)).with_value(tuple(got))
        dec = PORT.ckks.Encoder(s.params).decode(PORT.dec.decrypt(s.params, s.sk, out))
        np.testing.assert_allclose(dec[: s.params.max_slots].real, s.v[0] * s.v[1], atol=2e-3)


@pytest.mark.parametrize("name", list(BENCH_CASES))
def test_bench61_step(ctx, name):
    """bench.py's wide61 moduli, its P above 2^61: bit-identical to the JAX
    package (the digest), canonical words."""
    got = check_case(CASES, DIGESTS, f"{name}[bench61]", ctx)
    for y in got:
        assert y.dtype == torch.int64 and int(y.min()) >= 0


@pytest.mark.parametrize("mode", MODES)
def test_carry_wide(ctx, mode):
    """carry.carry_wide: a JAX wide context (its keys as pairs) and a JAX
    wide ciphertext, carried over, key-switch and decrypt as the port's own."""
    js, s = getattr(ctx.jax, mode), getattr(ctx, mode)
    got = carry.carry_wide(JAX.wckks.make_context(js.params, js.rlk, js.gks), device="cpu")
    own = PORT.wckks.make_context(s.params, s.rlk, s.gks)
    eq([got.rlk_q, got.rlk_p, got.gk_q, got.gk_p], [own.rlk_q, own.rlk_p, own.gk_q, own.gk_p])
    assert got.gal_els == own.gal_els and got.ring_q.pair31 == (mode == "pair31")
    c1 = s.cts[0].value[1]
    eq(list(PORT.wckks.gadget_product(got, c1)), list(PORT.wckks.gadget_product(own, c1)))
    ct = carry.carry_wide(JAX.weval.ct_to_wide(js.cts[0], js.params), js.params, "cpu")
    eq(ct, s.cts[0])
    eq(PORT.dec.decrypt(s.params, s.sk, ct), PORT.dec.decrypt(s.params, s.sk, s.cts[0]))

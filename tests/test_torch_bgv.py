"""PyTorch port, BGV / BFV (schemes/bgv) and its circuits
(circuits/bgv_circuits.py): every case of tests/test_bgv.py at its size
(logN 6, T = 65537, and T = 97 with a degree-16 plaintext ring), held
bit-exact against the JAX package.

The port's keys and ciphertexts are made from the arrays the JAX package
draws; the JAX side of the keys, the encryptions and every operation and
circuit runs once, in ``tools/port_circuit_digests.py test_torch_bgv``,
which pins their sha256 here (``DIGESTS``).  Decrypted and decoded slots
are compared exactly with numpy mod T, as the JAX tests do.  The JAX file
runs the BFV half of its Paterson-Stockmeyer case only with
MATRIX_FHE_RUN_SLOW; here both halves run, each against its digest.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import bgv as jbgv
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.ops import modmath as tmm
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import bgv as tbgv
from test_torch_matrix_ckks import _SAMPLE, evk_draws, galois_draws, sk_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

T = 65537
LITS = {"main": dict(logn=6, t=T, logq=(45, 40, 40), logp=(50,)),
        "ps": dict(logn=6, t=T, logq=(45,) + (40,) * 5, logp=(50,)),
        "small": dict(logn=6, t=97, logq=(45, 40, 40), logp=(50,))}
DIAG_IDX = [0, 1, 3]
RATIOS = (-1, 0)
PS_COEFFS = [5, 3, 0, 1, 7, 0, 2, 4]      # degree 7


def _u(rng, n, t=T, hi=None):
    return rng.integers(0, t if hi is None else hi, n, dtype=np.uint64)


def _inputs(n, n_t_small):
    """Every slot vector of tests/test_bgv.py, from its generators, and the
    encryption key of each ciphertext."""
    v = {}
    v["encode"] = _u(np.random.default_rng(0), n)
    v["encrypt"] = _u(np.random.default_rng(1), n)
    rng = np.random.default_rng(2)
    v["add1"], v["add2"] = _u(rng, n), _u(rng, n)
    rng = np.random.default_rng(3)
    v["mul1"], v["mul2"] = _u(rng, n), _u(rng, n)
    rng = np.random.default_rng(4)
    v["bfv1"], v["bfv2"] = _u(rng, n), _u(rng, n)
    v["rot"] = _u(np.random.default_rng(5), n)
    rng = np.random.default_rng(7)
    diags = {k: _u(rng, n) for k in DIAG_IDX}
    v["lt"] = _u(rng, n)
    v["poly"] = _u(np.random.default_rng(9), n, hi=100)
    v["ps"] = _u(np.random.default_rng(11), n)
    rng = np.random.default_rng(4)
    v["small1"], v["small2"] = _u(rng, n_t_small, 97), _u(rng, n_t_small, 97)
    return v, diags


# (ciphertext name, its slot vector, the JAX key of its encryption, context)
ENCRYPTIONS = [("encrypt", "encrypt", 2, "main"), ("add1", "add1", 3, "main"),
               ("add2", "add2", 4, "main"), ("mul1", "mul1", 5, "main"),
               ("mul2", "mul2", 6, "main"), ("bfv1", "bfv1", 7, "main"),
               ("bfv2", "bfv2", 8, "main"), ("rot", "rot", 10, "main"),
               ("lt", "lt", 18, "main"), ("poly", "poly", 19, "main"),
               ("ps", "ps", 7, "ps"), ("small1", "small1", 2, "small"),
               ("small2", "small2", 3, "small")]


def _jax_params():
    return {k: jbgv.new_parameters(jbgv.BGVParametersLiteral(**lit)) for k, lit in LITS.items()}


def _gal_els(m, params):
    return {"rot": [params.galois_element(1), params.galois_element_inverse()],
            **{f"lt{r}": m.lt.galois_elements(params, DIAG_IDX, params.n // 2, r)
               for r in RATIOS}}


def jax_context():
    """tests/test_bgv.py's three parameter sets, keys and ciphertexts."""
    from test_torch_polynomial import JAX
    params = _jax_params()
    enc = {k: jbgv.Encoder(p) for k, p in params.items()}
    sk, rlk = {}, {}
    for k, p in params.items():
        sk[k] = JK.gen_secret_key(jax.random.key(0), p)
        rlk[k] = JK.gen_relinearization_key(jax.random.key(1), p, sk[k])
    main = params["main"]
    gels = _gal_els(JAX, main)
    gks = {"rot": JK.gen_galois_keys(jax.random.key(9), main, sk["main"], gels["rot"]),
           **{f"lt{r}": JK.gen_galois_keys(jax.random.key(17), main, sk["main"], gels[f"lt{r}"])
              for r in RATIOS}}
    vals, diags = _inputs(main.n, params["small"].n_t)
    cts = {name: jenc.encrypt(jax.random.key(key), params[c], sk[c], enc[c].encode(vals[v]))
           for name, v, key, c in ENCRYPTIONS}
    return SimpleNamespace(params=params, enc=enc, sk=sk, rlk=rlk, gks=gks, vals=vals,
                           diags=diags, cts=cts)


def port_context():
    from test_torch_polynomial import PORT
    jparams = _jax_params()
    params = {k: carry.carry(p, "cpu") for k, p in jparams.items()}
    enc = {k: tbgv.Encoder(p) for k, p in params.items()}
    sk, rlk = {}, {}
    for k, p in params.items():
        jp_ = jparams[k]
        sk[k] = TK.secret_key_from_sample(p, _w(_SAMPLE(jax.random.key(0), jp_.ring_q, jp_.xs)))
        rows = p.base_rns_decomposition_vector_size(p.max_level)
        rlk[k] = TK.relinearization_key_from_samples(p, sk[k],
                                                     evk_draws(jax.random.key(1), jp_, rows))
    main, jmain = params["main"], jparams["main"]
    rows = main.base_rns_decomposition_vector_size(main.max_level)
    gels = _gal_els(PORT, main)

    def gks(key, els):
        return {g: TK.galois_key_from_samples(main, sk["main"], g, d)
                for g, d in galois_draws(jax.random.key(key), jmain, els, rows).items()}

    keys = {"rot": gks(9, gels["rot"]), **{f"lt{r}": gks(17, gels[f"lt{r}"]) for r in RATIOS}}
    vals, diags = _inputs(main.n, params["small"].n_t)
    cts = {name: tenc.encrypt_from_sample(
        params[c], sk[c], enc[c].encode(vals[v]),
        sk_draws(jax.random.key(key), jparams[c], params[c].max_level))
        for name, v, key, c in ENCRYPTIONS}
    return SimpleNamespace(params=params, enc=enc, sk=sk, rlk=rlk, gks=keys, vals=vals,
                           diags=diags, cts=cts, jparams=jparams)


def _ev(m, c, name="main", **kw):
    return m.bgv.Evaluator(c.params[name], rlk=c.rlk[name], **kw)


def _keys(m, c):
    out = []
    for k in LITS:
        out += [c.sk[k].value.q, c.sk[k].value.p, c.rlk[k].gadget.q, c.rlk[k].gadget.p]
    for name in sorted(c.gks):
        out += [c.gks[name][g].gadget.q for g in sorted(c.gks[name])]
    return out


def _mul_bgv(m, c):
    ev = _ev(m, c)
    a, b = c.cts["mul1"], c.cts["mul2"]
    ct3 = ev.rescale(ev.mul_relin(a, b))
    return [ct3, ev.mul(a, c.enc["main"].encode(c.vals["mul2"])), ev.add(ct3, a)]


def _rotation(m, c):
    ev = _ev(m, c, galois_keys=c.gks["rot"])
    return [ev.rotate_columns(c.cts["rot"], 1), ev.rotate_rows(c.cts["rot"])]


def _lintrans(m, c):
    params = c.params["main"]
    out = []
    for ratio in RATIOS:
        ltp = m.lt.LinearTransformationParameters(
            diagonals_index_list=DIAG_IDX, level_q=params.max_level,
            level_p=params.max_level_p, scale=1, log_dimensions=(1, params.log_n - 1),
            log_bsgs_ratio=ratio)
        transform = m.bgv_circuits.new_linear_transformation(params, c.enc["main"], c.diags, ltp)
        out.append(m.bgv_circuits.evaluate(params, c.cts["lt"], transform, c.gks[f"lt{ratio}"]))
    return out


def _poly_ps(m, c):
    return [m.bgv_circuits.evaluate_polynomial_ps(_ev(m, c, "ps", scale_invariant=inv),
                                                  c.enc["ps"], c.cts["ps"], PS_COEFFS)
            for inv in (False, True)]


def _small(m, c):
    ev = _ev(m, c, "small")
    return ev.rescale(ev.mul_relin(c.cts["small1"], c.cts["small2"]))


CASES = {
    "keys": _keys,
    "encode": lambda m, c: [c.enc["main"].encode(c.vals["encode"]),
                            c.enc["main"].encode(c.vals["encode"], level=1, scale=7)],
    "encrypt": lambda m, c: [c.cts[name] for name, *_ in ENCRYPTIONS],
    "add_sub": lambda m, c: [_ev(m, c).add(c.cts["add1"], c.cts["add2"]),
                             _ev(m, c).sub(c.cts["add1"], c.cts["add2"])],
    "mul_bgv": _mul_bgv,
    "mul_bfv": lambda m, c: _ev(m, c, scale_invariant=True).mul_relin(c.cts["bfv1"],
                                                                      c.cts["bfv2"]),
    "rotation": _rotation,
    "lintrans": _lintrans,
    "poly": lambda m, c: m.bgv_circuits.evaluate_polynomial(_ev(m, c), c.enc["main"],
                                                            c.cts["poly"], [3, 1, 2]),
    "poly_ps": _poly_ps,
    "small_order": _small,
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "keys": "79046e742bfd451c4149b8e871731d6ef78b1a49051152ed461ec39f2c304700",
    "encode": "0f10fc4ba46e5b38694c28a91c90302f2c7ec88f83d9f65c816704bc5d281467",
    "encrypt": "2812026f7a4e9dca5549e612a009eb1da2e051d57aaea084e45f5f35577aa6c4",
    "add_sub": "86fc72edf1822b640672b23e59f5f6b61dbbabb25c04038440c139cff5890354",
    "mul_bgv": "8136416d740632afecabbf00b55dbf807a951809c4f30d35e2356fa63ae5c277",
    "mul_bfv": "d93cdc6985ef9cee0e31297ab41f4c62ac7d94c0ab25c930a72eae02fe1439d6",
    "rotation": "cf5701f3157577940c135c91792e336628b9b1688c3dce1f6793831669143393",
    "lintrans": "799166e44c0f56d8bc2b15420b4596115acc2de1bab8bd8e104aa7c15876d44e",
    "poly": "0e61e4b2f9d683079c9ea3f84e103a626d56270b6ec0e4adedaf326c33e04f06",
    "poly_ps": "f48a9962348b073abeac2068732574a7b43f135799a183f85f2b08db22681029",
    "small_order": "d45fa68ab4abb416def740c8f17e8d9ed22a0b8019bb72a33d1c613bc24f326e",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def _dec(c, ct, name="main"):
    return c.enc[name].decode(tdec.decrypt(c.params[name], c.sk[name], ct))


def _obj(a):
    return np.asarray(a).astype(object)


def test_parameters_match_jax(ctx):
    for k, p in ctx.params.items():
        jp_ = ctx.jparams[k]
        assert (p.t, p.n_t) == (jp_.t, jp_.n_t)
        assert p.ring_qmul.moduli_tuple == tuple(jp_.ring_qmul.moduli_tuple)
        assert all(q < tmm.MAX_MODULUS for q in p.ring_qmul.moduli_tuple)
        np.testing.assert_array_equal(tbgv.scheme._permute_matrix(p.n_t.bit_length() - 1),
                                      jbgv.scheme._permute_matrix(p.n_t.bit_length() - 1))
    check_case(CASES, DIGESTS, "keys", ctx)


def test_encode_decode(ctx):
    """tests/test_bgv.py:38."""
    pts = check_case(CASES, DIGESTS, "encode", ctx)
    v = ctx.vals["encode"]
    np.testing.assert_array_equal(ctx.enc["main"].decode(pts[0]), v)
    np.testing.assert_array_equal(ctx.enc["main"].decode(pts[1]), v)


def test_encrypt_decrypt(ctx):
    """tests/test_bgv.py:45."""
    check_case(CASES, DIGESTS, "encrypt", ctx)
    np.testing.assert_array_equal(_dec(ctx, ctx.cts["encrypt"]), ctx.vals["encrypt"])


def test_add_sub(ctx):
    """tests/test_bgv.py:52."""
    add, sub = check_case(CASES, DIGESTS, "add_sub", ctx)
    v1, v2 = ctx.vals["add1"], ctx.vals["add2"]
    np.testing.assert_array_equal(_dec(ctx, add), (_obj(v1) + v2) % T)
    np.testing.assert_array_equal(_dec(ctx, sub), (_obj(v1) - v2) % T)


def test_mul_relin_rescale_bgv(ctx):
    """tests/test_bgv.py:66: the product, the plaintext product, and an add
    after the scale drifted (scale matching mod T)."""
    ct3, ct4, ct5 = check_case(CASES, DIGESTS, "mul_bgv", ctx)
    v1, v2 = ctx.vals["mul1"], ctx.vals["mul2"]
    np.testing.assert_array_equal(_dec(ctx, ct3), (_obj(v1) * v2) % T)
    np.testing.assert_array_equal(_dec(ctx, ct4), (_obj(v1) * v2) % T)
    np.testing.assert_array_equal(_dec(ctx, ct5), (_obj(v1) * v2 + v1) % T)


def test_mul_scale_invariant_bfv(ctx):
    """tests/test_bgv.py:86: BFV keeps the level."""
    ct3 = check_case(CASES, DIGESTS, "mul_bfv", ctx)
    assert ct3.level == ctx.cts["bfv1"].level
    np.testing.assert_array_equal(_dec(ctx, ct3),
                                  (_obj(ctx.vals["bfv1"]) * ctx.vals["bfv2"]) % T)


def test_rotation(ctx):
    """tests/test_bgv.py:99."""
    cols, rows = check_case(CASES, DIGESTS, "rotation", ctx)
    v = ctx.vals["rot"]
    half = len(v) // 2
    want = np.concatenate([np.roll(v[:half], -1), np.roll(v[half:], -1)])
    np.testing.assert_array_equal(_dec(ctx, cols), want)
    np.testing.assert_array_equal(_dec(ctx, rows), np.concatenate([v[half:], v[:half]]))


def test_bgv_lintrans(ctx):
    """tests/test_bgv.py:116: BGV slots rotate within each of the two rows
    of the [2, N/2] slot matrix."""
    outs = check_case(CASES, DIGESTS, "lintrans", ctx)
    cols = len(ctx.vals["lt"]) // 2
    vm = ctx.vals["lt"].reshape(2, cols)
    want = np.zeros_like(vm)
    for k, d in ctx.diags.items():
        want = (want + d.reshape(2, cols) * np.roll(vm, -k, axis=1)) % T
    for out in outs:
        np.testing.assert_array_equal(_dec(ctx, out).reshape(2, cols), want)


def test_bgv_polynomial_ps(ctx):
    """tests/test_bgv.py:145: degree 7 in 3 levels (BGV) / 0 levels (BFV)."""
    outs = check_case(CASES, DIGESTS, "poly_ps", ctx)
    v = ctx.vals["ps"]
    want = np.zeros(len(v), dtype=object)
    for c in reversed(PS_COEFFS):
        want = (want * _obj(v) + c) % T
    for invariant, out in zip((False, True), outs):
        np.testing.assert_array_equal(_obj(_dec(ctx, out, "ps")), want,
                                      err_msg=f"scale_invariant={invariant}")
    assert outs[0].level <= ctx.cts["ps"].level - 3  # log-depth consumption


def test_bgv_polynomial(ctx):
    """tests/test_bgv.py:183: Horner, 3 + x + 2 x^2."""
    out = check_case(CASES, DIGESTS, "poly", ctx)
    v = _obj(ctx.vals["poly"])
    np.testing.assert_array_equal(_obj(_dec(ctx, out)), (3 + v + 2 * v ** 2) % T)


def test_small_order_plaintext_modulus(ctx):
    """tests/test_bgv.py:196: T = 97 has order 32, so N = 64 gives 16 slots
    (a degree-16 plaintext ring, coefficients spread with gap 4)."""
    assert ctx.params["small"].n_t == 16
    out = check_case(CASES, DIGESTS, "small_order", ctx)
    want = (_obj(ctx.vals["small1"]) * ctx.vals["small2"]) % 97
    np.testing.assert_array_equal(_obj(_dec(ctx, out, "small")), want)
    with pytest.raises(ValueError):
        # order 2 (t-1 = 2 * odd) is far below the backend floor
        tbgv.new_parameters(tbgv.BGVParametersLiteral(logn=6, t=8191, logq=(45, 40),
                                                      logp=(50,)), device="cpu")


def test_lintrans_galois_elements_match(ctx):
    from test_torch_polynomial import JAX, PORT
    assert _gal_els(PORT, ctx.params["main"]) == _gal_els(JAX, ctx.jparams["main"])

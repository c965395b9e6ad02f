"""PyTorch port, the polynomial circuit (circuits/polynomial.py) on the u64
path: tests/test_polynomial.py's cases at logN 6 on the JAX package's keys
and ciphertexts, carried over.

Each case is one function over a namespace of modules (``JAX`` or ``PORT``,
the same names in both packages), so the same circuit runs on either side.
The JAX side of a whole circuit runs once, in
``tools/port_circuit_digests.py``, which pins the sha256 of its output
limbs and scale here (``DIGESTS``): on the same inputs the port's output
must hash to it.  The scalar ops run live on both sides (one jitted JAX
call).  Decoded values are held against the plaintext model with
tests/test_polynomial.py's own bounds (min L2 precision, bits).

The helpers here (``modules``, ``digest``, ``check_case``) serve the other
circuit test files too.
"""

import dataclasses
import hashlib
from importlib import import_module
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_rlwe import eq

_NAMES = {"poly": "circuits.polynomial", "bn": "utils.bignum", "ckks": "schemes.ckks",
          "mod1": "circuits.ckks.mod1", "dft": "circuits.ckks.dft",
          "lt": "circuits.lintrans", "ckks_lt": "circuits.ckks.lintrans",
          "btp": "circuits.ckks.bootstrapping", "fboot": "fast.fboot",
          "flintrans": "fast.flintrans", "fdft": "fast.fdft", "feval": "fast.feval", "fckks": "fast.fckks",
          "rlwe_eval": "rlwe.evaluator", "dec": "rlwe.decryptor",
          "wide": "ops.wide", "wckks": "fast.wckks", "wrns": "fast.wrns", "weval": "fast.weval",
          "minimax": "circuits.ckks.minimax", "comparison": "circuits.ckks.comparison",
          "inverse": "circuits.ckks.inverse", "rlwe_keys": "rlwe.keys", "encryptor": "rlwe.encryptor",
          "rs": "rlwe.ring_switch", "bridge": "schemes.ckks.bridge", "rpk": "rlwe.ring_packing",
          "noise": "rlwe.noise", "bgv": "schemes.bgv", "bgv_circuits": "circuits.bgv_circuits",
          "rgsw": "rgsw.rgsw", "blindrot": "rgsw.blindrot", "mp": "multiparty.protocols",
          "threshold": "multiparty.threshold", "mpckks": "multiparty.mpckks",
          "mpbgv": "multiparty.mpbgv", "staged": "circuits.ckks.staged"}


def modules(root: str) -> SimpleNamespace:
    """The circuit modules of one package, by the names both share."""
    return SimpleNamespace(**{k: import_module(f"{root}.{v}") for k, v in _NAMES.items()})


JAX, PORT = modules("matrix_fhe_tpu"), modules("matrix_fhe_tpu_torch")


def _arrays(x):
    if x is None:
        return
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _arrays(y)
    elif hasattr(x, "metadata") and hasattr(x, "value"):
        # a ciphertext or plaintext: its limbs, then its scale
        yield from _arrays(x.value)
        yield str(x.metadata.scale).encode()
    elif dataclasses.is_dataclass(x):  # a key or a share: its fields in order
        for f in dataclasses.fields(x):
            if f.name != "metadata":
                yield from _arrays(getattr(x, f.name))
    elif isinstance(x, torch.Tensor):
        yield x.cpu().numpy().astype("<i8").tobytes()
    else:
        yield np.asarray(x).astype("<i8").tobytes()


def digest(x) -> str:
    """sha256 over the limbs of ``x`` (ciphertexts, plaintexts, arrays,
    dataclasses of them such as keys and shares, or lists of them) as
    little-endian 64-bit words, each element's scale after its limbs: the
    same bytes from either package."""
    h = hashlib.sha256()
    for b in _arrays(x):
        h.update(b)
    return h.hexdigest()


def check_case(cases, digests, name, ctx):
    """Run case ``name`` on the port, require the JAX package's digest, and
    return the port's output."""
    out = cases[name](PORT, ctx)
    assert digest(out) == digests[name], f"{name}: the port's output != the JAX package's"
    return out


def as_i32(m, x):
    """u64-path limbs as the fast path's int32, in the package of ``m``."""
    if m is JAX:
        import jax.numpy as jnp
        return jnp.asarray(np.asarray(x).astype(np.int64).astype(np.int32))
    return x.to(torch.int32)


def decode(ctx, ct):
    """The port's decrypt + decode of a u64-path ciphertext."""
    return ctx.enc.decode(PORT.dec.decrypt(ctx.params, ctx.sk, ct))


# -- logN 6: tests/test_polynomial.py's context ---------------------------------

def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(55, 45, 45, 45, 45, 45), logp=(60,), log_default_scale=45))
    ks, kr = jax.random.split(jax.random.key(0))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    enc = jckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    # tests/test_polynomial.py: the input of each test, its seed and key
    vals, cts = {}, {}
    for name, seed, key, lo, cplx in (("scalar", 0, 1, -1, True), ("power", 1, 2, -0.9, False),
                                      ("sin", 2, 3, -1, False), ("monomial", 3, 4, -1, False),
                                      ("vector", 5, 5, -1, False), ("partial", 6, 6, -1, False)):
        rng = np.random.default_rng(seed)
        v = rng.uniform(lo, -lo, params.max_slots) + (
            1j * rng.uniform(lo, -lo, params.max_slots) if cplx else 0j)
        vals[name] = v
        cts[name] = encrypt(jax.random.key(key), sk, jax_encode(enc, params, v))
    return SimpleNamespace(params=params, sk=sk, rlk=rlk, enc=enc, ev=jckks.Evaluator(params, rlk=rlk),
                           vals=vals, cts=cts)


def port_context(j):
    params = carry.carry(j.params, "cpu")
    t = carry.carry(dict(sk=j.sk, rlk=j.rlk, cts=j.cts), "cpu")
    return SimpleNamespace(params=params, sk=t["sk"], rlk=t["rlk"], enc=PORT.ckks.Encoder(params),
                           ev=PORT.ckks.Evaluator(params, rlk=t["rlk"]), vals=j.vals, cts=t["cts"])


def _itv(m, nodes=15):
    return m.bn.Interval(-1, 1, nodes=nodes)


def _monomial(m, coeffs):
    p = m.bn.Polynomial.from_values(m.bn.MONOMIAL, coeffs)
    p.is_odd = p.is_even = False
    return p


MONOMIAL = [0.25, -0.5, 1.0, 0.75, -0.25, 0.125, 1.0, -1.0]
PARTIAL = [0.5, -1.0, 0.25, 0.75]
POWERS = (2, 3, 4, 7)


def _power_basis(m, c):
    pb = m.poly.PowerBasis(c.cts["power"], m.bn.CHEBYSHEV)
    for n in POWERS:
        pb.gen_power(n, c.ev)
    return [pb.value[n] for n in POWERS]


def _vector(m, c):
    slots = c.params.max_slots
    polys = m.poly.PolynomialVector(
        value=[m.bn.chebyshev_approximation(lambda x: m.bn.sin(x), _itv(m)),
               m.bn.chebyshev_approximation(lambda x: m.bn.cos(x), _itv(m))],
        mapping={0: list(range(0, slots, 2)), 1: list(range(1, slots, 2))})
    return m.poly.evaluate(c.ev, c.enc, c.cts["vector"], polys, c.params.default_scale)


def _partial(m, c):
    polys = m.poly.PolynomialVector(value=[_monomial(m, PARTIAL)],
                                    mapping={0: list(range(c.params.max_slots // 2))})
    return m.poly.evaluate(c.ev, c.enc, c.cts["partial"], polys, c.params.default_scale)


CASES = {
    "power_basis_chebyshev": _power_basis,
    "eval_chebyshev_sin": lambda m, c: m.poly.evaluate(
        c.ev, c.enc, c.cts["sin"], m.bn.chebyshev_approximation(lambda x: m.bn.sin(x), _itv(m)),
        c.params.default_scale),
    "eval_monomial_poly": lambda m, c: m.poly.evaluate(
        c.ev, c.enc, c.cts["monomial"], _monomial(m, MONOMIAL), c.params.default_scale),
    "eval_polynomial_vector": _vector,
    "polynomial_vector_partial_mapping": _partial,
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "power_basis_chebyshev": "e57b621ca053119e114af3745dec143b6b031c0cd00d939ebc60af0e49521f11",
    "eval_chebyshev_sin": "d8cddaea0e86bc010d7f356dd843119251e5e190c9c3efc1fdb9de7d13f57741",
    "eval_monomial_poly": "42e9fdfc6c145b51634ef0c0507db7561a35c05aa70d0ca4eebb7853f63d72d3",
    "eval_polynomial_vector": "80b64c1e3a6e2ccc89196510dffe39f27a33b340d2d36ea2ef51d449dc6f7ab9",
    "polynomial_vector_partial_mapping": "9e9a7685234a447cb9ab6d1ef1e50951616ad0350372a391403b26a11bbd8749",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    return port_context(jctx)


def _scalar_ops(m, c):
    ct, ev = c.cts["scalar"], c.ev
    return [ev.add_const(ct, 0.5 - 0.25j), ev.sub_const(ct, 1 + 1j),
            ev.rescale(ev.mul_const_complex(ct, 0.5 + 2j))]


def test_scalar_ops(jctx, ctx):
    want = jax.jit(lambda ct: _scalar_ops(JAX, SimpleNamespace(
        cts={"scalar": ct}, ev=jctx.ev)))(jctx.cts["scalar"])
    got = _scalar_ops(PORT, ctx)
    eq(got, carry.carry(want, "cpu"))
    v = ctx.vals["scalar"]
    for out, model, bits in zip(got, (v + (0.5 - 0.25j), v - (1 + 1j), v * (0.5 + 2j)), (20, 20, 18)):
        PORT.ckks.precision.assert_precision(model, decode(ctx, out), bits)


def test_power_basis_chebyshev(ctx):
    got = check_case(CASES, DIGESTS, "power_basis_chebyshev", ctx)
    x = np.real(ctx.vals["power"])
    for n, ct in zip(POWERS, got):
        PORT.ckks.precision.assert_precision(np.cos(n * np.arccos(x)), decode(ctx, ct), 12)


@pytest.mark.parametrize("name, inp, model, bits", [
    ("eval_chebyshev_sin", "sin", np.sin, 13),
    ("eval_monomial_poly", "monomial", lambda x: np.polyval(list(reversed(MONOMIAL)), x), 12)])
def test_eval_polynomial(ctx, name, inp, model, bits):
    out = check_case(CASES, DIGESTS, name, ctx)
    assert out.scale == ctx.params.default_scale
    x = np.real(ctx.vals[inp])
    PORT.ckks.precision.assert_precision(model(x), decode(ctx, out), bits)


def test_eval_polynomial_vector(ctx):
    out = check_case(CASES, DIGESTS, "eval_polynomial_vector", ctx)
    assert out.scale == ctx.params.default_scale
    x = np.real(ctx.vals["vector"])
    want = np.where(np.arange(len(x)) % 2 == 0, np.sin(x), np.cos(x))
    PORT.ckks.precision.assert_precision(want, decode(ctx, out), 13)


def test_polynomial_vector_partial_mapping(ctx):
    out = check_case(CASES, DIGESTS, "polynomial_vector_partial_mapping", ctx)
    x = np.real(ctx.vals["partial"])
    want = np.polyval(list(reversed(PARTIAL)), x)
    want[len(x) // 2:] = 0
    PORT.ckks.precision.assert_precision(want, decode(ctx, out), 12)
    p = _monomial(PORT, PARTIAL)
    with pytest.raises(ValueError):
        PORT.poly.PolynomialVector(
            value=[p, PORT.bn.Polynomial.from_values(PORT.bn.CHEBYSHEV, PARTIAL,
                                                      interval=PORT.bn.Interval(-1, 1))],
            mapping={0: [0], 1: [1]})
    with pytest.raises(ValueError):
        PORT.poly.PolynomialVector(value=[p, p], mapping={0: [0, 1], 1: [1]})


@pytest.mark.parametrize("degree", [7, 15, 30, 63])
def test_ps_decomposition_matches_jax(ctx, degree):
    """The Paterson-Stockmeyer split and the simulated level and scale of
    every sub-polynomial (host side) equal the JAX package's."""
    def run(m, params):
        p = m.bn.chebyshev_approximation(lambda x: m.bn.cos(x), _itv(m, degree))
        d = m.poly.ps_decompose(p, params.max_level, params.default_scale,
                                params.default_scale, m.poly.CKKSSim(params))
        return d.degree, d.base, d.level, d.scale, [
            (s.degree, s.max_deg, s.lead, s.level, s.scale, s.poly.coeffs) for s in d.value]
    jparams = SimpleNamespace(q=ctx.params.q, max_level=ctx.params.max_level,
                              default_scale=ctx.params.default_scale)
    assert run(PORT, ctx.params) == run(JAX, jparams)

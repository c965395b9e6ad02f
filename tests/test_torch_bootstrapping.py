"""PyTorch port, CKKS bootstrapping (circuits/ckks/bootstrapping.py) on the
u64 path: tests/test_bootstrapping.py's cases at logN 6.

On the JAX package's keys and ciphertexts: the evaluation keys made by the
port's deterministic part from JAX's draws equal JAX's; ``bootstrap`` and
the multiply after it hash to the JAX package's outputs (``DIGESTS``,
tools/port_circuit_digests.py) and decode with tests/test_bootstrapping.py's
bounds.  The JAX file's slow cases (``bootstrap_many``, META-BTS, the sparse
encapsulation) run here on the port alone, with keys from the port's own
generators, against the same bounds; the secret-key bootstrapper and the
presets as in the JAX file.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case, decode
from test_torch_rlwe import _w, eq, jax_evk_samples, jax_galois_samples


def literal(m, weight=0):
    """tests/test_bootstrapping.py's literal (dense key, or the ephemeral
    sparse secret of ``weight``)."""
    return m.btp.ParametersLiteral(
        log_n=6, residual_log_q=(55, 45), log_p=(61, 61), c2s_log_q=(56, 56, 56),
        s2c_log_q=(45, 45, 45), mod1_log_q=60, log_message_ratio=8, log_default_scale=45,
        ephemeral_secret_weight=weight)


def jax_evaluation_key_samples(key, p) -> "PORT.btp.EvaluationKeySamples":
    """The draws of the JAX package's bootstrapping.gen_evaluation_keys(key,
    p, sk), in the port's sample form: its five keys split as it splits them."""
    params = p.params
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    rows = -(-len(params.q) // len(params.p))
    s = PORT.btp.EvaluationKeySamples(
        rlk=jax_evk_samples(k1, params, rows),
        gks=jax_galois_samples(k2, params, p.galois_elements(), rows))
    if p.lit.ephemeral_secret_weight > 0:
        h = p.lit.ephemeral_secret_weight
        s.sparse = _w(jax.jit(lambda k: jsmp.sample(k, params.ring_q, jsmp.Ternary(h=h)))(k3))
        s.dense_to_sparse = jax_evk_samples(k4, params, rows)
        s.sparse_to_dense = jax_evk_samples(k5, params, rows)
    return s


def jax_context():
    p = JAX.btp.Parameters(literal(JAX))
    params = p.params
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    evk = JAX.btp.gen_evaluation_keys(jax.random.key(1), p, sk)
    enc = JAX.ckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    vals, cts = {}, {}
    for name, seed, key, cplx, hi in (("dense", 0, 3, True, 1), ("reuse", 1, 5, False, 0.5)):
        rng = np.random.default_rng(seed)
        v = rng.uniform(-hi, hi, params.max_slots) + (
            1j * rng.uniform(-hi, hi, params.max_slots) if cplx else 0j)
        vals[name] = v
        cts[name] = encrypt(jax.random.key(key), sk, jax_encode(enc, params, v,
                                                                level=p.residual_level))
    return SimpleNamespace(p=p, sk=sk, evk=evk, vals=vals, cts=cts)


def _bts(m, c):
    """The context's bootstrapper, made on first use."""
    if not hasattr(c, "bts"):
        c.bts = m.btp.Evaluator(c.p, c.evk)
    return c.bts


def _reuse(m, c):
    out = _bts(m, c).bootstrap(c.cts["reuse"])
    return [out, c.bts.ev.rescale(c.bts.ev.mul_relin(out, out))]


CASES = {"bootstrap_dense": lambda m, c: _bts(m, c).bootstrap(c.cts["dense"]),
         "bootstrap_consumed_then_reuse": _reuse}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "bootstrap_dense": "a0cff725352f2eae873e35d3e815e598132552f70b80ee2f57df5dd6974933e8",
    "bootstrap_consumed_then_reuse": "4b3c88f85a000ee1c7ed8eb8dff0e30b57c7047cb7e1de3dfea1879df5ab3583",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    p = carry.carry(jctx.p, "cpu")
    t = carry.carry(dict(sk=jctx.sk, evk=jctx.evk, cts=jctx.cts), "cpu")
    bts = PORT.btp.Evaluator(p, t["evk"])
    return SimpleNamespace(p=p, params=p.params, enc=bts.enc, bts=bts, vals=jctx.vals, **t)


@pytest.fixture(scope="module")
def own():
    """The port alone: keys from its own generators, sparse-encapsulated
    (weight 8, as tests/test_bootstrapping.py's sparse case) and dense."""
    out = {}
    for weight in (0, 8):
        p = PORT.btp.Parameters(literal(PORT, weight), device="cpu")
        gen = torch.Generator().manual_seed(40 + weight)
        sk = TK.gen_secret_key(gen, p.params)
        bts = PORT.btp.Evaluator(p, PORT.btp.gen_evaluation_keys(gen, p, sk))
        out[weight] = SimpleNamespace(p=p, params=p.params, sk=sk, enc=bts.enc, bts=bts, gen=gen)
    return out


def _encrypt(c, v, level):
    return tenc.encrypt(c.gen, c.params, c.sk, c.enc.encode(v, level=level))


def test_parameters_match_jax(jctx, ctx):
    p, jp = ctx.p, jctx.p
    assert list(p.params.q) == list(jp.params.q) and list(p.params.p) == list(jp.params.p)
    assert (p.log_slots, p.residual_level) == (jp.log_slots, jp.residual_level)
    for f in ("c2s_lit", "mod1_lit", "s2c_lit"):
        assert dataclasses.asdict(getattr(p, f)) == dataclasses.asdict(getattr(jp, f)), f
    assert p.galois_elements() == jp.galois_elements()


def test_evaluation_keys_from_jax_samples(jctx, ctx):
    eq(PORT.btp.evaluation_keys_from_samples(ctx.p, ctx.sk, jax_evaluation_key_samples(
        jax.random.key(1), jctx.p)), ctx.evk)


def test_bootstrap_dense(ctx):
    out = check_case(CASES, DIGESTS, "bootstrap_dense", ctx)
    assert out.level == ctx.p.residual_level
    PORT.ckks.precision.assert_precision(ctx.vals["dense"], decode(ctx, out), 10)


def test_bootstrap_consumed_then_reuse(ctx):
    out, out2 = check_case(CASES, DIGESTS, "bootstrap_consumed_then_reuse", ctx)
    v = ctx.vals["reuse"]
    PORT.ckks.precision.assert_precision(v * v, decode(ctx, out2), 8)


def test_bootstrap_many_pairs(own):
    c = own[0]
    rng = np.random.default_rng(2)
    vs = [rng.uniform(-1, 1, c.params.max_slots) + 0j for _ in range(2)]
    outs = c.bts.bootstrap_many([_encrypt(c, v, c.p.residual_level) for v in vs])
    assert len(outs) == 2
    for v, out in zip(vs, outs):
        PORT.ckks.precision.assert_precision(v, decode(c, out), 9)


def test_meta_bts_iterations(own):
    """A second META-BTS iteration beats the single bootstrap."""
    c = own[0]
    v = np.random.default_rng(3).uniform(-1, 1, c.params.max_slots) + 0j
    ct = _encrypt(c, v, c.p.residual_level)
    got1 = decode(c, c.bts.evaluate(ct, iterations=1))
    out2 = c.bts.evaluate(ct, iterations=2, reserved_bits=10)
    assert out2.scale == c.params.default_scale
    got2 = decode(c, out2)
    assert np.max(np.abs(got2 - v)) < np.max(np.abs(got1 - v))
    PORT.ckks.precision.assert_precision(v, got2, 12)


def test_bootstrap_sparse_secret_encapsulation(own):
    c = own[8]
    assert c.bts.evk_dense_to_sparse is not None and c.bts.evk_sparse_to_dense is not None
    v = np.random.default_rng(42).uniform(-1, 1, c.params.max_slots) + 0j
    out = c.bts.bootstrap(_encrypt(c, v, c.p.residual_level))
    assert out.level == c.p.residual_level
    PORT.ckks.precision.assert_precision(v, decode(c, out), 9)


def test_secret_key_bootstrapper(ctx):
    params = ctx.params
    rng = np.random.default_rng(4)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    gen = torch.Generator().manual_seed(30)
    ct = tenc.encrypt(gen, params, ctx.sk, ctx.enc.encode(v, level=0))
    skb = PORT.btp.SecretKeyBootstrapper(params, ctx.sk, gen)
    out = skb.bootstrap(ct)
    assert out.level == params.max_level and skb.counter == 1
    PORT.ckks.precision.assert_precision(v, decode(ctx, out), 20)


def test_default_parameter_presets():
    assert {k: dataclasses.asdict(v) for k, v in PORT.btp.DEFAULT_PARAMETERS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX.btp.DEFAULT_PARAMETERS.items()}
    for name, lit in PORT.btp.DEFAULT_PARAMETERS.items():
        assert lit.log_n >= 12, name
    p = PORT.btp.Parameters(PORT.btp.N12_TEST, device="cpu")
    assert p.residual_level == len(PORT.btp.N12_TEST.residual_log_q) - 1
    assert list(p.params.q) == list(JAX.btp.Parameters(JAX.btp.N12_TEST).params.q)

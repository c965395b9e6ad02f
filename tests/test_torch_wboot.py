"""PyTorch port, wide-path bootstrapping (fast/fboot.py's wide part).

tests/test_wboot.py's three cases:

* The keystone, bit-exact at logN 6: at ``wide_parameters_literal(6,
  residual_levels=2, sparse_weight=0)`` on JAX's keys ``key(0)`` /
  ``key(1)`` (the evaluation keys made by the port from JAX's draws) and
  encryption ``key(3)``, the port's wide ``bootstrap``
  hashes to the JAX package's wide bootstrap (``DIGESTS``, pinned by
  tools/port_circuit_digests.py), and the port's u64 bootstrap on the same
  keys hashes to the same digest (tests/test_wboot.py holds the JAX wide
  pipeline to its u64 one limb for limb).
* The staged bootstrap (circuits/ckks/staged.py, eager on the CPU) at the
  same inputs hashes to the same digest (tests/test_wboot_staged.py's case).
* Precision at logN 12 (the JAX package's 15-bit mean criterion) and the
  wide61 preset bit-exact against the u64 pipeline: slow-marked, as the JAX
  package marks the same cases (tests/test_wboot.py:49,78); they run on the
  port alone, with its own keys.

Also the presets and the chain check equal the JAX package's, and every
prime of the presets the card runs (logN 14 and 16) lies below 2^61, the
cap of the u64 rings that a bootstrap's parameters also build (the wide
path itself admits up to 2^61 + 2^55, as the JAX package does).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.circuits.ckks import mod1
from matrix_fhe_tpu_torch.rlwe import params as rparams
from test_torch_bootstrapping import jax_evaluation_key_samples
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case, digest


def _jax_inputs():
    """tests/test_wboot.py's bit-exact case: parameters, secret key, input
    and ciphertext."""
    p = JAX.btp.Parameters(JAX.fboot.wide_parameters_literal(6, residual_levels=2,
                                                             sparse_weight=0))
    params = p.params
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    pt = jax_encode(JAX.ckks.Encoder(params), params, v, level=p.residual_level)
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(jax.random.key(3), sk, pt)
    return SimpleNamespace(p=p, sk=sk, ct=ct)


def jax_context():
    """The inputs and the JAX package's evaluation keys (``key(1)``)."""
    c = _jax_inputs()
    c.evk = JAX.btp.gen_evaluation_keys(jax.random.key(1), c.p, c.sk)
    return c


def _wide_bts(m, c):
    if not hasattr(c, "bts"):
        c.bts = m.fboot.make_wide_bootstrapper(c.p, c.evk)
    return c.bts


CASES = {
    "wide_bootstrap": lambda m, c: m.weval.ct_to_u64(_wide_bts(m, c).bootstrap(
        m.weval.ct_to_wide(c.ct, c.p.params)), c.p.params),
    "wide_bootstrap_staged": lambda m, c: m.weval.ct_to_u64(m.staged.StagedBootstrapper(
        _wide_bts(m, c))(m.weval.ct_to_wide(c.ct, c.p.params)), c.p.params),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "wide_bootstrap": "997d8b8b8eeb6b20f8ed740ded9c91b9170a7d6559ab6c43da4cc9427868b2ad",
}


@pytest.fixture(scope="module")
def ctx():
    """The inputs carried over; the evaluation keys made by the port from
    JAX's draws of ``key(1)`` (equal to JAX's keys: test_torch_fboot.py)."""
    j = _jax_inputs()
    c = SimpleNamespace(p=carry.carry(j.p, "cpu"), **carry.carry(dict(sk=j.sk, ct=j.ct), "cpu"))
    c.evk = PORT.btp.evaluation_keys_from_samples(
        c.p, c.sk, jax_evaluation_key_samples(jax.random.key(1), j.p))
    return c


def test_wide_bootstrap_bit_exact(ctx):
    out = check_case(CASES, DIGESTS, "wide_bootstrap", ctx)
    assert out.level == ctx.p.residual_level
    u64 = PORT.btp.Evaluator(ctx.p, ctx.evk).bootstrap(ctx.ct)
    assert out.scale == u64.scale
    assert digest(u64) == DIGESTS["wide_bootstrap"]


def test_wide_bootstrap_staged_digest(ctx):
    """tests/test_wboot_staged.py:31: the staged wide bootstrap equals the
    eager one's digest, at the default scale; ``on_stage`` sees each stage."""
    st = PORT.staged.StagedBootstrapper(_wide_bts(PORT, ctx))
    names = []
    st.on_stage = names.append
    out = PORT.weval.ct_to_u64(st(PORT.weval.ct_to_wide(ctx.ct, ctx.p.params)), ctx.p.params)
    assert out.level == ctx.p.residual_level and out.scale == ctx.p.params.default_scale
    assert digest(out) == DIGESTS["wide_bootstrap"]
    assert names == ["head", "c2s[0]", "c2s[1]", "c2s[2]", "c2s_tail", "evalmod2", "s2c[0]",
                     "s2c[1]", "s2c[2]"]


def _own_session(lit, seed):
    """A bootstrap on the port's own keys (CPU generators of ``seed``)."""
    p = PORT.btp.Parameters(lit, device="cpu")
    params = p.params
    sk = PORT.rlwe_keys.gen_secret_key(torch.Generator().manual_seed(seed), params)
    evk = PORT.btp.gen_evaluation_keys(torch.Generator().manual_seed(seed + 1), p, sk)
    return p, sk, evk


def _encrypt(p, sk, v, seed):
    enc = PORT.ckks.Encoder(p.params)
    return PORT.encryptor.encrypt(torch.Generator().manual_seed(seed), p.params, sk,
                            enc.encode(v, level=p.residual_level))


@pytest.mark.slow  # as tests/test_wboot.py:49 marks the same case
def test_wide_bootstrap_precision_logn12():
    """The wide bootstrap at logN 12 on a reference-grade chain decodes to a
    mean precision >= 15 bits (min >= 5)."""
    p, sk, evk = _own_session(PORT.fboot.wide_parameters_literal(12, sparse_weight=32), 0)
    bts = PORT.fboot.make_wide_bootstrapper(p, evk)
    v = np.random.default_rng(0).uniform(-1, 1, p.params.max_slots)
    out = bts.bootstrap(_encrypt(p, sk, v, 3))
    assert out.level == p.residual_level
    got = bts.enc.decode(PORT.dec.decrypt(p.params, sk, out))
    prec = -np.log2(np.maximum(np.abs(np.asarray(got).real[: len(v)] - v), 1e-17))
    assert prec.mean() >= 15.0 and prec.min() >= 5.0, (prec.mean(), prec.min())


@pytest.mark.slow  # as tests/test_wboot.py:78 marks the same case
def test_wide61_bootstrap_bit_exact():
    """The reference-width preset (60-bit q0, 61-bit P, 58-bit C2S): the wide
    pipeline equals the u64 one limb for limb on the same keys."""
    p, sk, evk = _own_session(PORT.fboot.wide61_parameters_literal(6, residual_levels=2,
                                                                   sparse_weight=0), 10)
    assert PORT.wide.use_pair31(list(p.params.q) + list(p.params.p))
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, p.params.max_slots) + 1j * rng.uniform(-1, 1, p.params.max_slots)
    ct = _encrypt(p, sk, v, 13)
    out_u64 = PORT.btp.Evaluator(p, evk).bootstrap(ct)
    out_wide = PORT.fboot.make_wide_bootstrapper(p, evk).bootstrap(PORT.weval.ct_to_wide(ct))
    assert out_wide.scale == out_u64.scale
    for a, b in zip(out_wide.value, out_u64.value):
        assert torch.equal(a, b)


@pytest.mark.parametrize("make, args", [("wide_parameters_literal", (6, 2, 0)),
                                        ("wide_parameters_literal", (14, 3, 32)),
                                        ("wide61_parameters_literal", (6, 2, 0)),
                                        ("wide61_parameters_literal", (16, 5, 32, 2))])
def test_presets_match_jax(make, args):
    got = getattr(PORT.fboot, make)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(getattr(JAX.fboot, make)(*args))


@pytest.mark.parametrize("make, log_n", [("wide_parameters_literal", 14),
                                         ("wide61_parameters_literal", 14),
                                         ("wide61_parameters_literal", 16)])
def test_preset_chains_below_2_61(make, log_n):
    """The chain the preset's parameters generate (the port's GenModuli):
    every prime in [2^41, 2^61), so the u64 rings' cap costs it nothing."""
    lit = getattr(PORT.fboot, make)(log_n)
    depth = mod1.ParametersLiteral(
        level_q=0, log_scale=lit.mod1_log_q, mod1_type=lit.mod1_type, k=lit.mod1_k,
        mod1_degree=lit.mod1_degree, double_angle=lit.mod1_double_angle,
        mod1_inv_degree=lit.mod1_inv_degree).depth()
    logq = (tuple(lit.residual_log_q) + tuple(lit.s2c_log_q) + (lit.mod1_log_q,) * depth
            + tuple(lit.c2s_log_q))
    q, p = rparams.gen_moduli(log_n + 1, logq, lit.log_p)
    assert len(q) == len(logq) and len(p) == len(lit.log_p)
    PORT.fboot.check_wide_chain(SimpleNamespace(q=q, p=p))


def test_check_wide_chain():
    """The JAX package's range, [2^41, 2^61 + 2^55): a modulus above 2^61
    passes, 2^61 + 2^55 and one below 2^41 are refused, by both packages."""
    for bad in ((1 << 61) + (1 << 55), (1 << 23) - 15):
        with pytest.raises(ValueError, match="2\\^61"):
            PORT.fboot.check_wide_chain(SimpleNamespace(q=[bad], p=[]))
        with pytest.raises(ValueError):
            JAX.fboot.check_wide_chain(SimpleNamespace(q=[bad], p=[]))
    for good in ((1 << 61) + 1, 1 << 41):
        PORT.fboot.check_wide_chain(SimpleNamespace(q=[good], p=[]))
        JAX.fboot.check_wide_chain(SimpleNamespace(q=[good], p=[]))

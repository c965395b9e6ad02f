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

chip_smoke.py's phase 28 runs ``wide61_parameters_literal(*N16)`` (logN 16,
the reference's N16QP1547 widths) on the card, where the JAX package never
ran it.  Pinned from the JAX package here: its chain at logN 16 (``N16_Q``,
``N16_P``), the digest of its DFT matrices there (phase 28's gate, not run
here: ``n16_dft_matrices``) and at logN 6 (held here), and its wide
bootstrap of the same literal at logN 6 on its own keys (slow-marked, as
the wide61 case above).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
import chip_smoke
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


# wide61_parameters_literal(log_n, residual_levels, sparse_weight, num_p): the
# reference's N16QP1547 widths at logN 16, four 61-bit P primes (chip_smoke.py's
# phase 28), and the same literal at logN 6
N16 = (16, 5, 32, 4)
N16_AT_6 = (6,) + N16[1:]


def jax_context_wide61_inputs():
    """The wide61 literal at logN 6 (``N16_AT_6``): the JAX package's
    parameters, secret ``key(10)`` and an encryption ``key(13)`` of complex
    slots from ``default_rng(1)``."""
    p = JAX.btp.Parameters(JAX.fboot.wide61_parameters_literal(*N16_AT_6))
    params = p.params
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(10))
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    pt = jax_encode(JAX.ckks.Encoder(params), params, v, level=p.residual_level)
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(jax.random.key(13), sk, pt)
    return SimpleNamespace(p=p, sk=sk, ct=ct)


def jax_context_wide61():
    """``jax_context_wide61_inputs`` and the JAX package's evaluation keys
    ``key(11)``."""
    c = jax_context_wide61_inputs()
    c.evk = JAX.btp.gen_evaluation_keys(jax.random.key(11), c.p, c.sk)
    return c


def jax_context_n16():
    """The literal at logN 16: its parameters only (the chain and the DFT
    matrices need no key)."""
    return SimpleNamespace(p=JAX.btp.Parameters(JAX.fboot.wide61_parameters_literal(*N16)))


def dft_matrices(m, p):
    """The CoeffsToSlots and SlotsToCoeffs matrices ``btp.Evaluator`` makes
    for ``p`` (they need no key), in the package of ``m``."""
    bts = m.btp.Evaluator(p, m.btp.EvaluationKeys(rlk=None, gks={}))
    return bts.c2s_matrix, bts.s2c_matrix


CASES = {
    "wide_bootstrap": lambda m, c: m.weval.ct_to_u64(_wide_bts(m, c).bootstrap(
        m.weval.ct_to_wide(c.ct, c.p.params)), c.p.params),
    "wide_bootstrap_staged": lambda m, c: m.weval.ct_to_u64(m.staged.StagedBootstrapper(
        _wide_bts(m, c))(m.weval.ct_to_wide(c.ct, c.p.params)), c.p.params),
    "wide61_bootstrap": lambda m, c: m.weval.ct_to_u64(_wide_bts(m, c).bootstrap(
        m.weval.ct_to_wide(c.ct, c.p.params)), c.p.params),
    "wide61_dft_matrices": lambda m, c: chip_smoke.dft_matrices_digest(*dft_matrices(m, c.p)),
    "n16_chain": lambda m, c: repr((tuple(c.p.params.q), tuple(c.p.params.p))),
    "n16_dft_matrices": lambda m, c: chip_smoke.dft_matrices_digest(*dft_matrices(m, c.p)),
}
JAX_CONTEXTS = {"wide61_bootstrap": jax_context_wide61, "wide61_dft_matrices": jax_context_wide61,
                "n16_chain": jax_context_n16, "n16_dft_matrices": jax_context_n16}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "wide_bootstrap": "997d8b8b8eeb6b20f8ed740ded9c91b9170a7d6559ab6c43da4cc9427868b2ad",
    "wide61_bootstrap": "09f9ec083dc5450be2f8732dbfde999d0d7f0170ff7560c2262a20dec36cebc5",
    "wide61_dft_matrices": "ae7b132e54b79c2953d6ef25564af688774c36b14e39d60cf2bace5d7c8d031d",
    # held on the card only (chip_smoke.py:N16_MATRICES_SHA256, phase 28's gate)
    "n16_dft_matrices": "56e7bf3d243c16c731588da20bfe48b906b0ae29b8f9b5dfe1cf5cba1c251681",
}
# tools/port_circuit_digests.py test_torch_wboot:n16_chain: the JAX package's
# Q and P primes at ``N16``
N16_Q = (1152921504606584833, 35184372744193, 35184373006337, 35184368025601, 35184376545281,
         4398044938241, 4398043496449, 4398042972161, 1152921504614055937, 1152921504598720513,
         1152921504615628801, 1152921504616808449, 1152921504597016577, 1152921504595968001,
         1152921504618381313, 1152921504620347393, 288230376155250689, 288230376147386369,
         288230376158396417)
N16_P = (2305843009211596801, 2305843009210023937, 2305843009208713217, 2305843009202159617)


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
                                        ("wide61_parameters_literal", (16, 5, 32, 2)),
                                        ("wide61_parameters_literal", N16)])
def test_presets_match_jax(make, args):
    got = getattr(PORT.fboot, make)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(getattr(JAX.fboot, make)(*args))


@pytest.mark.parametrize("make, log_n", [("wide_parameters_literal", 14),
                                         ("wide61_parameters_literal", 14),
                                         ("wide61_parameters_literal", 16)])
def test_preset_chains_below_2_61(make, log_n):
    """The chain the preset's parameters generate (the port's GenModuli):
    every prime in [2^41, 2^61), so the u64 rings' cap costs it nothing."""
    q, p = _chain(getattr(PORT.fboot, make)(log_n))
    PORT.fboot.check_wide_chain(SimpleNamespace(q=q, p=p))


def _chain(lit):
    """The Q and P primes ``btp.Parameters(lit)`` generates (the port's
    GenModuli over the bootstrap's levels, residual first)."""
    depth = mod1.ParametersLiteral(
        level_q=0, log_scale=lit.mod1_log_q, mod1_type=lit.mod1_type, k=lit.mod1_k,
        mod1_degree=lit.mod1_degree, double_angle=lit.mod1_double_angle,
        mod1_inv_degree=lit.mod1_inv_degree).depth()
    logq = (tuple(lit.residual_log_q) + tuple(lit.s2c_log_q) + (lit.mod1_log_q,) * depth
            + tuple(lit.c2s_log_q))
    q, p = rparams.gen_moduli(lit.log_n + 1, logq, lit.log_p)
    assert len(q) == len(logq) and len(p) == len(lit.log_p)
    return q, p


def test_n16_pins_agree():
    """The digest phase 28 holds the card's matrices to is this file's pin."""
    assert chip_smoke.N16_MATRICES_SHA256 == DIGESTS["n16_dft_matrices"]
    assert chip_smoke.N16_LITERAL == N16


def test_n16_chain_equals_jax():
    """chip_smoke.py's phase 28 literal at logN 16: the port's chain is the
    JAX package's, 19 Q and 4 P primes, all below 2^61."""
    q, p = _chain(PORT.fboot.wide61_parameters_literal(*N16))
    assert (tuple(q), tuple(p)) == (N16_Q, N16_P)
    assert len(q) == 19 and len(p) == 4 and max(q + p) < 1 << 61


def test_wide61_dft_matrices_equal_jax():
    """The CoeffsToSlots and SlotsToCoeffs matrices of the phase-28 literal
    at logN 6 hash as the JAX package's do (the digest phase 28 takes of
    its matrices at logN 16, ``chip_smoke.dft_matrices_digest``)."""
    p = PORT.btp.Parameters(PORT.fboot.wide61_parameters_literal(*N16_AT_6), device="cpu")
    assert chip_smoke.dft_matrices_digest(*dft_matrices(PORT, p)) == \
        DIGESTS["wide61_dft_matrices"]


@pytest.mark.slow  # as tests/test_wboot.py:78 marks the wide61 preset's bootstrap
def test_wide61_n16_literal_bootstrap_at_logn6():
    """The phase-28 literal at logN 6 (five residual levels, four 61-bit P
    primes, sparse secret weight 32) on the JAX package's keys and input:
    the port's wide bootstrap hashes to the JAX package's, and the port's
    u64 bootstrap on the same keys to the same digest."""
    j = jax_context_wide61_inputs()
    c = SimpleNamespace(p=carry.carry(j.p, "cpu"), **carry.carry(dict(sk=j.sk, ct=j.ct), "cpu"))
    c.evk = PORT.btp.evaluation_keys_from_samples(
        c.p, c.sk, jax_evaluation_key_samples(jax.random.key(11), j.p))
    out = check_case(CASES, DIGESTS, "wide61_bootstrap", c)
    assert out.level == c.p.residual_level and out.scale == c.p.params.default_scale
    assert digest(PORT.btp.Evaluator(c.p, c.evk).bootstrap(c.ct)) == DIGESTS["wide61_bootstrap"]


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

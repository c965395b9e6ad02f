"""PyTorch port, the int32 DFT chain (fast/fdft.py): tests/test_fdft.py's case
at logN 7 on the JAX package's keys and ciphertext.  The chain equals the
port's u64 DFT (``dft._dft``) limb for limb and hashes to the JAX package's
(``DIGESTS``, tools/port_circuit_digests.py); through the FastEvaluator
(``evaluate_lintrans`` + rescale a level) CoeffsToSlots gives the same limbs.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.fast import fring as jfring
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, as_i32, check_case
from test_torch_rlwe import eq


def _c2s_literal(m, params):
    return m.dft.MatrixLiteral(
        type=m.dft.HOMOMORPHIC_ENCODE, log_slots=params.log_max_slots, level_q=params.max_level,
        level_p=params.max_level_p, levels=[1, 1, 1], format=m.dft.SPLIT_REAL_AND_IMAG)


def jax_context():
    logn, lq, lp = 7, 6, 2
    moduli = jfring.find_fast_primes(1 << logn, lq + lp)
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=logn, q=tuple(moduli[:lq]), p=tuple(moduli[lq:]), log_default_scale=21))
    enc = jckks.Encoder(params)
    ks, kr, ke = jax.random.split(jax.random.key(0), 3)
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gks = JK.gen_galois_keys(jax.random.key(7), params, sk,
                             JAX.dft.galois_elements(params, _c2s_literal(JAX, params)))
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(
        ke, sk, jax_encode(enc, params, v))
    return SimpleNamespace(params=params, rlk=rlk, gks=gks, ct=ct)


def _matrix(m, c):
    return m.dft.new_matrix_from_literal(c.params, _c2s_literal(m, c.params), m.ckks.Encoder(c.params))


def _chain(m, c):
    fctx = m.fckks.make_context(c.params, c.rlk, gks=c.gks)
    fmats = m.fdft.convert_matrices(c.params, _matrix(m, c).matrices)
    c0, c1, level = m.fdft.dft(fctx, fmats, as_i32(m, c.ct.value[0]), as_i32(m, c.ct.value[1]),
                               c.params.galois_element, c.ct.level)
    return [c0, c1, np.int64(level)]


CASES = {"dft_chain": _chain}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "dft_chain": "3ab2c3687bf8b4b0aa4bfc710c06221f0f5f3c1af7e7c43cb4d5d197e8ae7bd3",
}


@pytest.fixture(scope="module")
def ctx():
    j = jax_context()
    params = carry.carry(j.params, "cpu")
    return SimpleNamespace(params=params, **carry.carry(dict(rlk=j.rlk, gks=j.gks, ct=j.ct), "cpu"))


def test_dft_chain_matches_u64(ctx):
    c0, c1, level = check_case(CASES, DIGESTS, "dft_chain", ctx)
    mat = _matrix(PORT, ctx)
    ev = PORT.ckks.Evaluator(ctx.params, rlk=ctx.rlk, galois_keys=ctx.gks)
    want = PORT.dft._dft(ctx.params, ev, ctx.ct, mat.matrices, ctx.gks)
    assert int(level) == want.level
    assert torch.equal(c0.long(), want.value[0]) and torch.equal(c1.long(), want.value[1])


def test_fast_evaluator_dft_matches_chain(ctx):
    """dft._dft through the FastEvaluator (its evaluate_lintrans and
    rescale) equals fdft.dft."""
    c0, c1, level = CASES["dft_chain"](PORT, ctx)
    fev = PORT.feval.make_fast_evaluator(ctx.params, ctx.rlk, ctx.gks)
    out = PORT.dft._dft(ctx.params, fev, PORT.feval.ct_to_fast(ctx.ct),
                        _matrix(PORT, ctx).matrices, ctx.gks)
    assert out.level == int(level) and out.scale == ctx.ct.scale
    eq(list(out.value), [c0, c1])

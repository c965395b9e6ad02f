"""PyTorch port, the homomorphic DFT (circuits/ckks/dft.py) on the u64 path:
tests/test_dft.py's cases at logN 6 on the JAX package's keys and
ciphertexts.  The factorized matrices and galois elements (host side) equal
the JAX package's; each case's encoded matrices and outputs hash to the JAX
package's (``DIGESTS``, tools/port_circuit_digests.py) and decode with
tests/test_dft.py's bounds.  The fractional-levels case shows that a group
of ``levels[i]`` factors shares one rescale.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.schemes.ckks.encoder import _bit_reverse_perm, crt_reconstruct_centered
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case, decode

# name: (C2S levels, input seed, galois key, encryption key, with S2C)
DFT_CASES = {"c2s_s2c_roundtrip_dense": ([1, 1, 1], 0, 7, 3, True),
             "c2s_matches_plain_coeffs": ([1, 1, 1], 1, 8, 5, False),
             "c2s_s2c_fractional_levels": ([2, 1], 1, 8, 4, True)}


def _literals(m, params, levels):
    L, d = params.max_level, len(levels)
    c2s = m.dft.MatrixLiteral(type=m.dft.HOMOMORPHIC_ENCODE, log_slots=params.log_max_slots,
                              level_q=L, level_p=params.max_level_p, levels=list(levels),
                              format=m.dft.SPLIT_REAL_AND_IMAG)
    s2c = m.dft.MatrixLiteral(type=m.dft.HOMOMORPHIC_DECODE, log_slots=params.log_max_slots,
                              level_q=L - d, level_p=params.max_level_p, levels=list(levels),
                              format=m.dft.SPLIT_REAL_AND_IMAG)
    return c2s, s2c


def jax_context():
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(55,) + (45,) * 7, logp=(60,), log_default_scale=45))
    ks, kr = jax.random.split(jax.random.key(0))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(ks)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    enc = jckks.Encoder(params)
    encrypt = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))
    c = SimpleNamespace(params=params, sk=sk, rlk=rlk, vals={}, pts={}, cts={}, gks={})
    for name, (levels, seed, gkey, ekey, s2c) in DFT_CASES.items():
        c2s_lit, s2c_lit = _literals(JAX, params, levels)
        els = set(JAX.dft.galois_elements(params, c2s_lit))
        if s2c:
            els |= set(JAX.dft.galois_elements(params, s2c_lit))
        c.gks[name] = JK.gen_galois_keys(jax.random.key(gkey), params, sk, sorted(els))
        rng = np.random.default_rng(seed)
        v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
        c.vals[name] = v
        c.pts[name] = jax_encode(enc, params, v)
        c.cts[name] = encrypt(jax.random.key(ekey), sk, c.pts[name])
    return c


def _dft_case(name):
    def run(m, c):
        """The encoded matrices, CoeffsToSlots' two outputs and, where the
        case has it, SlotsToCoeffs' output."""
        levels, _, _, _, with_s2c = DFT_CASES[name]
        params, gks = c.params, c.gks[name]
        enc = m.ckks.Encoder(params)
        ev = m.ckks.Evaluator(params, rlk=c.rlk, galois_keys=gks)
        c2s_lit, s2c_lit = _literals(m, params, levels)
        c2s = m.dft.new_matrix_from_literal(params, c2s_lit, enc)
        mats = [mt.vec[k] for mt in c2s.matrices for k in sorted(mt.vec)]
        re, im = m.dft.coeffs_to_slots(params, ev, c.cts[name], c2s, gks)
        if not with_s2c:
            return mats, re, im
        s2c = m.dft.new_matrix_from_literal(params, s2c_lit, enc)
        mats += [mt.vec[k] for mt in s2c.matrices for k in sorted(mt.vec)]
        return mats, re, im, m.dft.slots_to_coeffs(params, ev, re, im, s2c, gks)
    return run


CASES = {name: _dft_case(name) for name in DFT_CASES}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "c2s_s2c_roundtrip_dense": "bdacfbf78a64cbd4b0cf396ddbb6daa593243c62ad20805039fcf3a2ccb199af",
    "c2s_matches_plain_coeffs": "0317b7261e7b2cf01bf4406a463c1d60dc1b32b46c25bfa39ca188a3307ec508",
    "c2s_s2c_fractional_levels": "c0c8c28d5ecf578759f39c574f11515a364496028800bb547f5c68627c8dc2ce",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    params = carry.carry(jctx.params, "cpu")
    t = carry.carry(dict(sk=jctx.sk, rlk=jctx.rlk, gks=jctx.gks, pts=jctx.pts, cts=jctx.cts),
                    "cpu")
    return SimpleNamespace(params=params, enc=PORT.ckks.Encoder(params), vals=jctx.vals, **t)


def test_c2s_s2c_roundtrip_dense(ctx):
    _, re, im, out = check_case(CASES, DIGESTS, "c2s_s2c_roundtrip_dense", ctx)
    assert np.max(np.abs(np.imag(decode(ctx, re)))) < 1e-3
    assert np.max(np.abs(np.imag(decode(ctx, im)))) < 1e-3
    PORT.ckks.precision.assert_precision(ctx.vals["c2s_s2c_roundtrip_dense"], decode(ctx, out), 12)


def test_c2s_matches_plain_coeffs(ctx):
    """CoeffsToSlots' slots are the plaintext's coefficients / scale, in
    bit-reversed slot order."""
    name = "c2s_matches_plain_coeffs"
    _, re, im = check_case(CASES, DIGESTS, name, ctx)
    pt = ctx.pts[name]
    coeffs = crt_reconstruct_centered(ctx.params.ring_q.intt(pt.value).numpy(), ctx.params.q)
    coeffs = np.array([float(x) for x in coeffs]) / float(pt.scale)
    n2 = ctx.params.max_slots
    br = _bit_reverse_perm(n2)
    PORT.ckks.precision.assert_precision(coeffs[:n2][br], np.real(decode(ctx, re)), 10)
    PORT.ckks.precision.assert_precision(coeffs[n2:][br], np.real(decode(ctx, im)), 10)


def test_c2s_s2c_fractional_levels(ctx):
    """levels = [2, 1]: two factors share one rescaling prime, so the round
    trip spends 4 levels on 6 factors."""
    name = "c2s_s2c_fractional_levels"
    mats, re, im, out = check_case(CASES, DIGESTS, name, ctx)
    L = ctx.params.max_level
    assert re.level == L - 2 and out.level == L - 4
    PORT.ckks.precision.assert_precision(ctx.vals[name], decode(ctx, out), 10)


@pytest.mark.parametrize("kind", ["encode", "decode"])
@pytest.mark.parametrize("levels", [[1, 1, 1], [2, 1], [3, 2]])
def test_matrices_match_jax(ctx, kind, levels):
    """gen_matrices (numpy) and galois_elements equal the JAX package's."""
    def run(m):
        lit = _literals(m, ctx.params, levels)[kind == "decode"]
        lit = dataclasses.replace(lit, scaling=0.75)
        return m.dft.gen_matrices(lit, ctx.params.log_n), m.dft.galois_elements(ctx.params, lit)
    (got, gels), (want, jels) = run(PORT), run(JAX)
    assert gels == jels
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])

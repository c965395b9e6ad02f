"""PyTorch port, ring packing (rlwe/ring_packing.py): the cases of
tests/test_ring_packing.py (Expand / Pack at logN 5) and of
tests/test_ring_packing_xdeg.py (the RingPackingEvaluator across logN 4..6:
Split / Merge, Extract / Repack in its three pairings, strided indices), at
their sizes, held bit-exact against the JAX package.

The port's secrets, galois keys, ring-switching keys and ciphertexts are
made from the arrays the JAX package draws (the evaluator's one key split
4 (log_n_max - log_n_min + 2) ways, ``jax_ring_packing_samples``); the JAX
side of the keys and of every tree runs once, in
``tools/port_circuit_digests.py test_torch_ring_packing``, which pins their
sha256 here (``DIGESTS``).  Decrypted coefficients are held to the JAX
tests' bounds (0.01 / 0.05 / 0.2).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.rlwe import ring_packing as jrp
from matrix_fhe_tpu.utils import primes as jp
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe import ring_packing as trp
from test_torch_matrix_ckks import _SAMPLE, evk_draws, galois_draws
from test_torch_polynomial import check_case
from test_torch_ring_switch import coeffs, encrypt_coeffs, jax_encrypt_coeffs
from test_torch_rlwe import _w

SCALE = 1 << 30
LOGN = 5                     # tests/test_ring_packing.py
LOG_MIN, LOG_MAX = 4, 6      # tests/test_ring_packing_xdeg.py
PAIRINGS = {"ff": (False, False), "tf": (True, False), "ft": (False, True)}


def _chain(log_n_max):
    n = 1 << log_n_max
    q = jp.NTTFriendlyPrimesGenerator(45, 2 * n).next_alternating_primes(2)
    p = jp.NTTFriendlyPrimesGenerator(50, 2 * n).next_alternating_primes(1)
    return tuple(q), tuple(p)


def _jax_params(logn, log_n_max):
    q, p = _chain(log_n_max)
    return jrlwe.new_parameters(jrlwe.ParametersLiteral(logn=logn, q=q, p=p))


def _gal_els(m, params):
    return sorted(set(m.rpk.galois_elements_for_expand(params))
                  | set(m.rpk.galois_elements_for_pack(params, params.log_n)))


def _strided_values():
    """tests/test_ring_packing.py:test_pack_strided's four values."""
    rng = np.random.default_rng(1)
    return [int(rng.integers(-100, 100)) for _ in range(4)]


def _strided_limbs(n, v):
    vals = np.zeros(n, dtype=np.int64)
    vals[0] = v
    return vals


def _xdeg_values(seed, n):
    return np.random.default_rng(seed).integers(-100, 100, n)


def jax_context():
    """Both JAX test files' fixtures and inputs."""
    from matrix_fhe_tpu.rlwe import encryptor  # noqa: F401
    from test_torch_polynomial import JAX
    params = _jax_params(LOGN, LOGN)
    sk = JK.gen_secret_key(jax.random.key(0), params)
    gks = JK.gen_galois_keys(jax.random.key(1), params, sk, _gal_els(JAX, params))
    ct = jax_encrypt_coeffs(params, sk, _xdeg_values(0, params.n), SCALE, 3)
    stride = params.n // 4
    strided = {j * stride: jax_encrypt_coeffs(params, sk, _strided_limbs(params.n, v), SCALE,
                                              10 + j)
               for j, v in enumerate(_strided_values())}
    q, p = _chain(LOG_MAX)
    ev = jrp.RingPackingEvaluator(
        jax.random.key(0), lambda ln: jrlwe.new_parameters(jrlwe.ParametersLiteral(
            logn=ln, q=q, p=p)), LOG_MIN, LOG_MAX)
    xcts = {key: jax_encrypt_coeffs(ev.params[LOG_MAX], ev.sk[LOG_MAX],
                                    _xdeg_values(seed, 1 << LOG_MAX), SCALE, key)
            for seed, key in ((0, 3), (1, 5), (2, 7))}
    return SimpleNamespace(params=params, sk=sk, gks=gks, ct=ct, strided=strided, ev=ev,
                           xcts=xcts)


def jax_ring_packing_samples(key, jparams: dict) -> trp.RingPackingSamples:
    """The draws of the JAX package's RingPackingEvaluator.__init__(key, ...)
    (ring_packing.py:189-222): one key split 4 (max - min + 2) ways, taken
    in turn by the secrets, each degree's down and up key, and the galois
    keys at the minimum degree."""
    lns = sorted(jparams)
    keys = iter(jax.random.split(key, 4 * (lns[-1] - lns[0] + 2)))
    sk = {ln: _w(_SAMPLE(next(keys), jparams[ln].ring_q, jparams[ln].xs)) for ln in lns}
    down, up = {}, {}
    for ln in lns[1:]:
        jp_ = jparams[ln]
        rows = jp_.base_rns_decomposition_vector_size(jp_.max_level)
        down[ln] = evk_draws(next(keys), jp_, rows)
        up[ln] = evk_draws(next(keys), jp_, rows)
    pmin = jparams[lns[0]]
    rows = pmin.base_rns_decomposition_vector_size(pmin.max_level)
    els = sorted(set(jrp.galois_elements_for_expand(pmin))
                 | set(jrp.galois_elements_for_pack(pmin, pmin.log_n)))
    return trp.RingPackingSamples(sk=sk, evk_down=down, evk_up=up,
                                  gks_min=galois_draws(next(keys), pmin, els, rows))


def port_context():
    from test_torch_polynomial import PORT
    jparams = _jax_params(LOGN, LOGN)
    params = carry.carry(jparams, "cpu")
    sk = TK.secret_key_from_sample(params, _w(_SAMPLE(jax.random.key(0), jparams.ring_q,
                                                      jparams.xs)))
    rows = params.base_rns_decomposition_vector_size(params.max_level)
    els = _gal_els(PORT, params)
    gks = {g: TK.galois_key_from_samples(params, sk, g, d)
           for g, d in galois_draws(jax.random.key(1), jparams, els, rows).items()}
    ct = encrypt_coeffs(params, jparams, sk, _xdeg_values(0, params.n), SCALE, 3)
    stride = params.n // 4
    strided = {j * stride: encrypt_coeffs(params, jparams, sk, _strided_limbs(params.n, v),
                                          SCALE, 10 + j)
               for j, v in enumerate(_strided_values())}
    jx = {ln: _jax_params(ln, LOG_MAX) for ln in range(LOG_MIN, LOG_MAX + 1)}
    ev = trp.RingPackingEvaluator.from_samples(
        {ln: carry.carry(p, "cpu") for ln, p in jx.items()},
        jax_ring_packing_samples(jax.random.key(0), jx))
    xcts = {key: encrypt_coeffs(ev.params[LOG_MAX], jx[LOG_MAX], ev.sk[LOG_MAX],
                                _xdeg_values(seed, 1 << LOG_MAX), SCALE, key)
            for seed, key in ((0, 3), (1, 5), (2, 7))}
    return SimpleNamespace(params=params, sk=sk, gks=gks, ct=ct, strided=strided, ev=ev,
                           xcts=xcts, jx=jx)


def _ordered(cts: dict) -> list:
    return [cts[k] for k in sorted(cts)]


def _expand_pack(m, c):
    cts = m.rpk.expand(c.params, c.ct, log_gap=0, gks=c.gks)
    packed = m.rpk.pack(c.params, cts, input_log_gap=c.params.log_n, zero_garbage_slots=True,
                        gks=c.gks)
    return _ordered(cts) + [packed]


def _xdeg_keys(m, c):
    ev = c.ev
    out = [ev.sk[ln].value.q for ln in sorted(ev.sk)]
    for ln in sorted(ev.evk_up):
        out += [ev.evk_down[ln].gadget.q, ev.evk_down[ln].gadget.p,
                ev.evk_up[ln].gadget.q, ev.evk_up[ln].gadget.p]
    for g in sorted(ev.gks_min):
        out += [ev.gks_min[g].gadget.q, ev.gks_min[g].gadget.p]
    for ln in sorted(ev.x_pow2):
        out += list(ev.x_pow2[ln]) + list(ev.x_inv_pow2[ln])
    return out


def _split_merge(m, c):
    even, odd = c.ev.split(c.xcts[3], LOG_MAX)
    return [even, odd, c.ev.merge(even, odd, LOG_MAX)]


def _extract_repack(naive_extract, naive_repack):
    def case(m, c):
        cts = c.ev.extract(c.xcts[5], list(range(1 << LOG_MAX)), naive=naive_extract)
        return _ordered(cts) + [c.ev.repack(cts, naive=naive_repack)]
    return case


def _extract_sparse(m, c):
    return _ordered(c.ev.extract(c.xcts[7], list(range(0, 1 << LOG_MAX, 4))))


CASES = {
    "keys": lambda m, c: [c.sk.value.q, c.sk.value.p] + [
        x for g in sorted(c.gks) for x in (c.gks[g].gadget.q, c.gks[g].gadget.p)],
    "encrypt": lambda m, c: [c.ct] + _ordered(c.strided),
    "expand_pack": _expand_pack,
    "pack_strided": lambda m, c: m.rpk.pack(c.params, c.strided, input_log_gap=c.params.log_n,
                                            zero_garbage_slots=True, gks=c.gks),
    "xdeg_keys": _xdeg_keys,
    "xdeg_encrypt": lambda m, c: _ordered(c.xcts),
    "split_merge": _split_merge,
    **{f"extract_repack_{k}": _extract_repack(*v) for k, v in PAIRINGS.items()},
    "extract_sparse": _extract_sparse,
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "keys": "af3f5ea3982db85e75a2fd86f6386a0fd6b545f33ae0f20dbce165eefe736131",
    "encrypt": "7913d04ae1fa433a83f65b6a9353ca3dedb4eb1befef5c44c68a2213ecd29771",
    "expand_pack": "cfab9d9193b2eb684d15c406dc575cb70ea932ed17ebbd9eba32d3bf9660733a",
    "pack_strided": "1d2865ffdf88213fe2ed85a5405b4c6e29981050875da4efcbc171a26da0bf2b",
    "xdeg_keys": "60925856f7604e378934fe98a4c9231d538b250540aa57ae1b93b7abe591d914",
    "xdeg_encrypt": "3d1d5fd5e80c540c63883cdf5f121921014e2a07853b3b1e3d174153a66b1b36",
    "split_merge": "bfbfefa6748e82e463239c3ea30892c40a5a98a2feed36385a0e3477aaecfb3f",
    "extract_repack_ff": "213dbe6c89840dab85e95179ac1deccd2fd214e4deafff713d4bb075dd13da13",
    "extract_repack_tf": "9584936a7535dba66a1c413a2bd406667992db41a9a97598594887a5a87cb55a",
    "extract_repack_ft": "2e1326477f0f2fc61b913f4fb652b8a5158b7300527a13b72bcaee747ae36b5e",
    "extract_sparse": "be6e3415100bf14f86a3d00c52b4bfff813383914bb5b98e89da4d2d41a6b9f9",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def test_keys_and_encryptions_match_jax(ctx):
    for case in ("keys", "encrypt", "xdeg_keys", "xdeg_encrypt"):
        check_case(CASES, DIGESTS, case, ctx)


def test_monomials_built_once_on_the_ring_device(ctx):
    a = trp.gen_x_pow2_ntt(ctx.params, div=True)
    assert a is trp.gen_x_pow2_ntt(ctx.params, div=True)
    assert all(m.device == ctx.params.device and m.shape == (len(ctx.params.q), ctx.params.n)
               for m in a)
    s = trp._scalar_big(ctx.params.ring_q.moduli_tuple, 7, ctx.params.device)
    assert s is trp._scalar_big(ctx.params.ring_q.moduli_tuple, 7, ctx.params.device)


def test_expand_then_pack_roundtrip(ctx):
    """tests/test_ring_packing.py:40."""
    c = ctx
    out = check_case(CASES, DIGESTS, "expand_pack", c)
    cts, packed = out[:-1], out[-1]
    vals = _xdeg_values(0, c.params.n)
    assert len(cts) == c.params.n
    for i in (0, 1, 7, c.params.n - 1):
        got = coeffs(c.params, c.sk, cts[i])
        assert abs(got[0] / SCALE - vals[i]) < 0.01, (i, got[0] / SCALE, vals[i])
        # all other coefficients are zeroed by the expand tree
        assert np.max(np.abs(got[1:] / SCALE)) < 0.01
    np.testing.assert_allclose(coeffs(c.params, c.sk, packed, SCALE), vals, atol=0.05)


def test_pack_strided(ctx):
    """tests/test_ring_packing.py:67: 4 ciphertexts with a value in the
    constant coefficient, packed at stride N/4."""
    c = ctx
    packed = check_case(CASES, DIGESTS, "pack_strided", c)
    got = coeffs(c.params, c.sk, packed, SCALE)
    stride = c.params.n // 4
    for j, v in enumerate(_strided_values()):
        assert abs(got[j * stride] - v) < 0.05, (j, got[j * stride], v)


def test_split_merge_roundtrip(ctx):
    """tests/test_ring_packing_xdeg.py:54."""
    c = ctx
    even, odd, back = check_case(CASES, DIGESTS, "split_merge", c)
    vals = _xdeg_values(0, 1 << LOG_MAX)
    ev = c.ev
    small = ev.params[LOG_MAX - 1]
    np.testing.assert_allclose(coeffs(small, ev.sk[LOG_MAX - 1], even, SCALE), vals[::2],
                               atol=0.05)
    np.testing.assert_allclose(coeffs(small, ev.sk[LOG_MAX - 1], odd, SCALE), vals[1::2],
                               atol=0.05)
    np.testing.assert_allclose(coeffs(ev.params[LOG_MAX], ev.sk[LOG_MAX], back, SCALE), vals,
                               atol=0.05)


@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_extract_then_repack(ctx, pairing):
    """tests/test_ring_packing_xdeg.py:70: a naive (non-zeroing) half is
    composed with a zeroing other half, as the reference does."""
    c = ctx
    naive_extract, _ = PAIRINGS[pairing]
    out = check_case(CASES, DIGESTS, f"extract_repack_{pairing}", c)
    cts, packed = out[:-1], out[-1]
    n = 1 << LOG_MAX
    vals = _xdeg_values(1, n)
    assert len(cts) == n
    ev = c.ev
    for i in (0, 1, 5, n - 1):
        got = coeffs(ev.params[LOG_MIN], ev.sk[LOG_MIN], cts[i], SCALE)
        assert abs(got[0] - vals[i]) < 0.05, (i, got[0], vals[i])
        if not naive_extract:
            assert np.max(np.abs(got[1:])) < 0.05
    np.testing.assert_allclose(coeffs(ev.params[LOG_MAX], ev.sk[LOG_MAX], packed, SCALE), vals,
                               atol=0.2)


def test_extract_sparse_indices(ctx):
    """tests/test_ring_packing_xdeg.py:94: strided index sets exercise the
    bucket bookkeeping."""
    c = ctx
    cts = check_case(CASES, DIGESTS, "extract_sparse", c)
    idx = list(range(0, 1 << LOG_MAX, 4))
    assert sorted(c.ev.extract(c.xcts[7], idx)) == idx
    vals = _xdeg_values(2, 1 << LOG_MAX)
    for i, ct in zip(idx, cts):
        got = coeffs(c.ev.params[LOG_MIN], c.ev.sk[LOG_MIN], ct, SCALE)
        assert abs(got[0] - vals[i]) < 0.05, (i, got[0], vals[i])


def test_own_generator_evaluator(ctx):
    """The constructor draws from a torch.Generator and builds on the device
    it is given: the same evaluator as from_samples on its draws."""
    jx = ctx.jx

    def make(ln, device):
        return carry.carry(jx[ln], device)

    ev = trp.RingPackingEvaluator(torch.Generator().manual_seed(9), make, LOG_MIN, LOG_MAX,
                                  device="cpu")
    params = {ln: make(ln, "cpu") for ln in jx}
    want = trp.RingPackingEvaluator.from_samples(
        params, trp.sample_ring_packing_keys(torch.Generator().manual_seed(9), params))
    for ln in jx:
        assert torch.equal(ev.sk[ln].value.q, want.sk[ln].value.q)
    for g in want.gks_min:
        assert torch.equal(ev.gks_min[g].gadget.q, want.gks_min[g].gadget.q)
    assert sorted(ev.gks_min) == trp.galois_elements_for_ring_packing(params[LOG_MIN])

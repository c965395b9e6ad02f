"""PyTorch port, the standard <-> conjugate-invariant CKKS bridge
(schemes/ckks/bridge.py): tests/test_bridge.py's case at its size
(standard logN 6 <-> CI logN 5, three 45-bit Q primes and a 55-bit P),
held bit-exact against the JAX package.

The port's secrets, swap keys and ciphertext are made from the arrays the
JAX package draws; the JAX side of the keys, the encryption and both
switches runs once, in ``tools/port_circuit_digests.py test_torch_bridge``,
which pins their sha256 here (``DIGESTS``).  At logN 6 the CI ring's NTT
order decides where the unfold mirrors the slots, so equal digests hold
the port's CI transform order to the JAX ``_ntt_ci``'s.  The decoded
values are held to the JAX test's floors (15 bits after the switch, 12
after the return).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu.utils import primes as jp
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from matrix_fhe_tpu_torch.schemes.ckks import bridge as tbr
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

LOGN = 6


def _jax_params():
    n = 1 << LOGN
    q = tuple(jp.NTTFriendlyPrimesGenerator(45, 2 * n).next_alternating_primes(3))
    p = tuple(jp.NTTFriendlyPrimesGenerator(55, 2 * n).next_alternating_primes(1))
    std = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=LOGN, q=q, p=p, log_default_scale=40, ring_type="standard"))
    ci = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=LOGN - 1, q=q, p=p, log_default_scale=40, ring_type="conjugate_invariant"))
    return std, ci


def _values(n):
    return np.random.default_rng(0).uniform(-1, 1, n)  # real values


def jax_context():
    """tests/test_bridge.py's fixture and input."""
    from matrix_fhe_tpu.schemes.ckks import bridge as jbr
    std, ci = _jax_params()
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    sk_std = JK.gen_secret_key(k0, std)
    sk_ci = JK.gen_secret_key(k1, ci)
    s2c, c2s = jbr.gen_ring_swap_keys_ci(k2, std, sk_std, sk_ci)
    ct = jenc.encrypt(jax.random.key(5), std, sk_std,
                      jckks.Encoder(std).encode(_values(std.max_slots) + 0j))
    return SimpleNamespace(std=std, ci=ci, sk_std=sk_std, sk_ci=sk_ci, s2c=s2c, c2s=c2s, ct=ct)


def port_context():
    jstd, jci = _jax_params()
    std, ci = carry.carry(jstd, "cpu"), carry.carry(jci, "cpu")
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    sk_std = TK.secret_key_from_sample(std, _w(_SAMPLE(k0, jstd.ring_q, jstd.xs)))
    sk_ci = TK.secret_key_from_sample(ci, _w(_SAMPLE(k1, jci.ring_q, jci.xs)))
    rows = std.base_rns_decomposition_vector_size(std.max_level)
    ka, kb = jax.random.split(k2)  # gen_ring_swap_keys_ci's split
    s2c, c2s = tbr.ring_swap_keys_ci_from_samples(
        std, sk_std, sk_ci, (evk_draws(ka, jstd, rows), evk_draws(kb, jstd, rows)))
    ct = tenc.encrypt_from_sample(std, sk_std,
                                  tckks.Encoder(std).encode(_values(std.max_slots) + 0j),
                                  sk_draws(jax.random.key(5), jstd, std.max_level))
    return SimpleNamespace(std=std, ci=ci, sk_std=sk_std, sk_ci=sk_ci, s2c=s2c, c2s=c2s, ct=ct)


def _keys(m, c):
    return [c.sk_std.value.q, c.sk_std.value.p, c.sk_ci.value.q, c.sk_ci.value.p,
            c.s2c.gadget.q, c.s2c.gadget.p, c.c2s.gadget.q, c.c2s.gadget.p]


def _bridge(m, c):
    ct_ci = m.bridge.complex_to_real(c.std, c.ct, c.s2c)
    return [ct_ci, m.bridge.real_to_complex(c.std, ct_ci, c.c2s)]


CASES = {"keys": _keys, "encrypt": lambda m, c: c.ct, "bridge": _bridge}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "keys": "c80795d0746fdbf5f7cace8abe822ec941d487d9c7b9a52ce866ed109ebcca01",
    "encrypt": "ce5a20292ebce7afa6e0e70145d4190e463ee35fa9aff945748ab6ff63fc0420",
    "bridge": "98291d9adbcb5dc3181deb067c9b9ef2db1f3fdc8fa4cccac867047f20a9de49",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def test_keys_and_encryption_match_jax(ctx):
    assert ctx.std.max_slots == ctx.ci.max_slots
    check_case(CASES, DIGESTS, "keys", ctx)
    check_case(CASES, DIGESTS, "encrypt", ctx)
    gen_a, gen_b = (torch.Generator().manual_seed(5) for _ in range(2))
    got = tbr.gen_ring_swap_keys_ci(gen_a, ctx.std, ctx.sk_std, ctx.sk_ci)
    want = tbr.ring_swap_keys_ci_from_samples(ctx.std, ctx.sk_std, ctx.sk_ci,
                                              tbr.sample_ring_swap_keys_ci(gen_b, ctx.std))
    for g, w in zip(got, want):
        assert torch.equal(g.gadget.q, w.gadget.q) and torch.equal(g.gadget.p, w.gadget.p)


def test_fold_index_and_unfold_match_jax(ctx):
    from matrix_fhe_tpu.schemes.ckks import bridge as jbr
    jstd, _ = _jax_params()
    idx = tbr._fold_idx(ctx.std)
    assert idx.device == ctx.std.device and idx is tbr._fold_idx(ctx.std)  # built once
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jbr._fold_idx(jstd)))
    x = np.random.default_rng(2).integers(0, 1 << 40, (2, 3, 32), dtype=np.uint64)
    np.testing.assert_array_equal(tbr.unfold_ci_to_std(ctx.std, _w(x)).numpy().view(np.uint64),
                                  np.asarray(jbr.unfold_ci_to_std(jstd, x)))


def test_complex_to_real_and_back(ctx):
    """tests/test_bridge.py:33."""
    c = ctx
    ct_ci, ct_std = check_case(CASES, DIGESTS, "bridge", c)
    v = _values(c.std.max_slots)
    assert ct_ci.value[0].shape[-1] == c.ci.n and ct_ci.scale == 2 * c.ct.scale
    # std -> CI: decrypt under the CI key in the CI ring
    got = tckks.Encoder(c.ci).decode(tdec.decrypt(c.ci, c.sk_ci, ct_ci))
    tckks.precision.assert_precision(v, np.real(got), 15)
    # CI -> std: back under the standard key
    got2 = tckks.Encoder(c.std).decode(tdec.decrypt(c.std, c.sk_std, ct_std))
    tckks.precision.assert_precision(v, np.real(got2), 12)

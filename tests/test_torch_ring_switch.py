"""PyTorch port, ring-degree switching n <-> N (rlwe/ring_switch.py):
tests/test_ring_switch.py's case at its size (logN 6 <-> 4, two 45-bit Q
primes and a 50-bit P), held bit-exact against the JAX package.

The port's secrets, ring-swap keys and ciphertext are made from the arrays
the JAX package draws (``ring_swap_keys_from_samples`` on the draws of
``gen_ring_swap_keys``'s split key); the JAX side of the keys and of
switch_up / switch_down runs once, in ``tools/port_circuit_digests.py
test_torch_ring_switch``, which pins their sha256 here (``DIGESTS``).  The
decrypted coefficients are held to the JAX test's 0.01.

The helpers here (``coeffs``, ``encrypt_coeffs``) serve the ring-packing
tests too.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.rlwe.elements import MetaData as JMetaData, Plaintext as JPlaintext
from matrix_fhe_tpu.utils import primes as jp
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe import ring_switch as trs
from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

LOGN_L, LOGN_S = 6, 4
SCALE = 1 << 30


def coeffs(params, sk, ct, scale=1) -> np.ndarray:
    """The decrypted coefficients of ``ct``, centered, over ``scale``."""
    pt = tdec.decrypt(params, sk, ct)
    ring = params.ring_q.at_level(pt.level)
    v = ring.intt(pt.value) if pt.metadata.is_ntt else pt.value
    c = crt_reconstruct_centered(v.cpu().numpy(), params.q[:pt.level + 1])
    return np.array([float(x) for x in c]) / scale


def coeff_limbs(params, vals, scale) -> np.ndarray:
    """The integer polynomial vals * scale, [L, N] over the whole chain."""
    return np.stack([(vals * scale) % q for q in params.q]).astype(np.uint64)


def encrypt_coeffs(params, jparams, sk, vals, scale, key):
    """The port's secret-key encryption of the coefficients vals * scale,
    from the draws of the JAX package's encrypt(key(key), ...)."""
    arr = coeff_limbs(params, vals, scale)
    pt = Plaintext(value=params.ring_q.ntt(_w(arr)), metadata=MetaData(is_ntt=True))
    return tenc.encrypt_from_sample(params, sk, pt,
                                    sk_draws(jax.random.key(key), jparams, params.max_level))


def jax_encrypt_coeffs(params, sk, vals, scale, key):
    """tests/test_ring_switch.py's _encrypt_coeffs."""
    pt = JPlaintext(value=params.ring_q.ntt(jnp.asarray(coeff_limbs(params, vals, scale))),
                    metadata=JMetaData(is_ntt=True))
    return jenc.encrypt(jax.random.key(key), params, sk, pt)


def _values(n):
    return np.random.default_rng(0).integers(-50, 50, n)


def _jax_params():
    # moduli NTT-friendly for the LARGE ring (1 mod 2N divides both)
    q = jp.NTTFriendlyPrimesGenerator(45, 2 << LOGN_L).next_alternating_primes(2)
    p = jp.NTTFriendlyPrimesGenerator(50, 2 << LOGN_L).next_alternating_primes(1)
    return tuple(jrlwe.new_parameters(jrlwe.ParametersLiteral(logn=logn, q=tuple(q), p=tuple(p)))
                 for logn in (LOGN_L, LOGN_S))


def jax_context():
    """tests/test_ring_switch.py's fixture and input."""
    pl, ps = _jax_params()
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    sk_l = JK.gen_secret_key(k0, pl)
    sk_s = JK.gen_secret_key(k1, ps)
    from matrix_fhe_tpu.rlwe import ring_switch as jrs
    evk_up, evk_down = jrs.gen_ring_swap_keys(k2, ps, pl, sk_s, sk_l)
    ct_s = jax_encrypt_coeffs(ps, sk_s, _values(ps.n), SCALE, 5)
    return SimpleNamespace(pl=pl, ps=ps, sk_l=sk_l, sk_s=sk_s, evk_up=evk_up,
                           evk_down=evk_down, ct_s=ct_s)


def port_context():
    """The same on the port: parameters carried over, secrets, keys and the
    ciphertext made from JAX's draws."""
    jpl, jps = _jax_params()
    pl, ps = carry.carry(jpl, "cpu"), carry.carry(jps, "cpu")
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    sk_l = TK.secret_key_from_sample(pl, _w(_SAMPLE(k0, jpl.ring_q, jpl.xs)))
    sk_s = TK.secret_key_from_sample(ps, _w(_SAMPLE(k1, jps.ring_q, jps.xs)))
    rows = pl.base_rns_decomposition_vector_size(pl.max_level)
    ku, kd = jax.random.split(k2)  # gen_ring_swap_keys's split
    evk_up, evk_down = trs.ring_swap_keys_from_samples(
        ps, pl, sk_s, sk_l, (evk_draws(ku, jpl, rows), evk_draws(kd, jpl, rows)))
    ct_s = encrypt_coeffs(ps, jps, sk_s, _values(ps.n), SCALE, 5)
    return SimpleNamespace(pl=pl, ps=ps, sk_l=sk_l, sk_s=sk_s, evk_up=evk_up,
                           evk_down=evk_down, ct_s=ct_s, jpl=jpl, jps=jps)


def _keys(m, c):
    return [c.sk_l.value.q, c.sk_l.value.p, c.sk_s.value.q, c.sk_s.value.p,
            c.evk_up.gadget.q, c.evk_up.gadget.p, c.evk_down.gadget.q, c.evk_down.gadget.p]


def _switch(m, c):
    ct_l = m.rs.switch_up(c.ps, c.pl, c.ct_s, c.evk_up)
    return [ct_l, m.rs.switch_down(c.pl, c.ps, ct_l, c.evk_down)]


CASES = {"keys": _keys, "encrypt": lambda m, c: c.ct_s, "switch": _switch}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "keys": "845f032eb1a78b1483776493c2d8782e9769f4846ab2f2bd3a4de578cfc13c9a",
    "encrypt": "c55e0e076e12c02ea315b758e869d4396167d1ead3b0cc88906a8ef28838166e",
    "switch": "8fb8372a86ae3c19fe97d5b0e4df62a1c18d18f69f8d038bd70940dc9df79fe7",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


def test_keys_and_encryption_match_jax(ctx):
    check_case(CASES, DIGESTS, "keys", ctx)
    check_case(CASES, DIGESTS, "encrypt", ctx)
    # the generator composes the same two halves
    gen_a, gen_b = (torch.Generator().manual_seed(3) for _ in range(2))
    got = trs.gen_ring_swap_keys(gen_a, ctx.ps, ctx.pl, ctx.sk_s, ctx.sk_l)
    want = trs.ring_swap_keys_from_samples(ctx.ps, ctx.pl, ctx.sk_s, ctx.sk_l,
                                           trs.sample_ring_swap_keys(gen_b, ctx.pl))
    for g, w in zip(got, want):
        assert torch.equal(g.gadget.q, w.gadget.q) and torch.equal(g.gadget.p, w.gadget.p)


def test_maps_match_jax(ctx):
    """The slot replication and the coefficient gather equal jnp.repeat and
    the strided slice."""
    from matrix_fhe_tpu.rlwe import ring_switch as jrs
    x = np.random.default_rng(1).integers(0, 1 << 40, (2, 3, 16), dtype=np.uint64)
    assert np.array_equal(trs.map_small_to_large_ntt(4, _w(x)).numpy().view(np.uint64),
                          np.asarray(jrs.map_small_to_large_ntt(4, jnp.asarray(x))))
    got = trs.map_large_to_small_coeff(4, _w(x))
    assert got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint64),
                          np.asarray(jrs.map_large_to_small_coeff(4, jnp.asarray(x))))


def test_switch_up_then_down(ctx):
    """tests/test_ring_switch.py:46."""
    c = ctx
    ct_l, ct_s2 = check_case(CASES, DIGESTS, "switch", c)
    vals = _values(c.ps.n)
    # up: Y = X^gap -> X; the small poly appears at stride-gap coefficients
    gap = c.pl.n // c.ps.n
    got = coeffs(c.pl, c.sk_l, ct_l, SCALE)
    np.testing.assert_allclose(got[::gap], vals, atol=0.01)
    assert np.max(np.abs(np.delete(got, np.arange(0, c.pl.n, gap)))) < 0.01
    # down again: the original small poly under sk_s
    np.testing.assert_allclose(coeffs(c.ps, c.sk_s, ct_s2, SCALE), vals, atol=0.01)


def test_mismatched_chains_raise(ctx):
    other = carry.carry(jrlwe.new_parameters(jrlwe.ParametersLiteral(
        logn=LOGN_S, logq=(45, 45), logp=(50,))), "cpu")
    with pytest.raises(ValueError, match="identical moduli"):
        trs.gen_ring_swap_keys(torch.Generator().manual_seed(0), other, ctx.pl, ctx.sk_s,
                               ctx.sk_l)

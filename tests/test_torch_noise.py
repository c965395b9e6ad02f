"""PyTorch port, the noise and norm utilities (rlwe/noise.py):
tests/test_noise.py's cases at its size (logN 6, 45 + 40-bit Q, a 50-bit P),
held against the JAX package.

The port's keys and ciphertext are made from the arrays the JAX package
draws; the JAX side's measurements run once, in
``tools/port_circuit_digests.py test_torch_noise``, which pins the sha256
of their float64 bits here (``DIGESTS``): the port reports the same
numbers, bit for bit.  Each is also held to the JAX test's bound (fresh
noise below 2^4, the message's norm at least 2^19).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.rlwe.elements import MetaData as JMetaData, Plaintext as JPlaintext
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe import noise as tnoise
from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws, zero_draws
from test_torch_polynomial import check_case
from test_torch_rlwe import _w

LIT = dict(logn=6, logq=(45, 40), logp=(50,))


def _message(params):
    """tests/test_noise.py:48's plaintext: 20-bit integers on every limb."""
    m = np.random.default_rng(7).integers(0, 1 << 20, params.n)
    return np.stack([(m % q).astype(np.uint64) for q in params.q])


def jax_context():
    """tests/test_noise.py's fixture and ciphertext."""
    params = jrlwe.new_parameters(jrlwe.ParametersLiteral(**LIT))
    ks, kp, kr, kg = jax.random.split(jax.random.key(0), 4)
    sk = JK.gen_secret_key(ks, params)
    pk = JK.gen_public_key(kp, params, sk)
    rlk = JK.gen_relinearization_key(kr, params, sk)
    gk = JK.gen_galois_key(kg, params, sk, params.galois_element(1))
    limbs = _message(params)
    pt = JPlaintext(value=params.ring_q.ntt(limbs), metadata=JMetaData(is_ntt=True))
    ct = jenc.encrypt(jax.random.key(3), params, sk, pt)
    return SimpleNamespace(params=params, sk=sk, pk=pk, rlk=rlk, gk=gk, ct=ct, limbs=limbs)


def port_context():
    jparams = jrlwe.new_parameters(jrlwe.ParametersLiteral(**LIT))
    params = carry.carry(jparams, "cpu")
    ks, kp, kr, kg = jax.random.split(jax.random.key(0), 4)
    sk = TK.secret_key_from_sample(params, _w(_SAMPLE(ks, jparams.ring_q, jparams.xs)))
    pk = TK.public_key_from_sample(params, sk, zero_draws(kp, jparams))
    rows = params.base_rns_decomposition_vector_size(params.max_level)
    rlk = TK.relinearization_key_from_samples(params, sk, evk_draws(kr, jparams, rows))
    g = params.galois_element(1)
    gk = TK.galois_key_from_samples(params, sk, g, evk_draws(kg, jparams, rows))
    limbs = _message(params)
    pt = Plaintext(value=params.ring_q.ntt(_w(limbs)), metadata=MetaData(is_ntt=True))
    ct = tenc.encrypt_from_sample(params, sk, pt,
                                  sk_draws(jax.random.key(3), jparams, params.max_level))
    return SimpleNamespace(params=params, sk=sk, pk=pk, rlk=rlk, gk=gk, ct=ct, limbs=limbs)


def _bits(values) -> np.ndarray:
    """float64 values as the int64 words of their bits (digest input)."""
    return np.asarray(values, dtype=np.float64).view(np.int64)


def _noise(m, c):
    return _bits([m.noise.noise_public_key(c.params, c.pk, c.sk),
                  m.noise.noise_relinearization_key(c.params, c.rlk, c.sk),
                  m.noise.noise_galois_key(c.params, c.gk, c.sk),
                  *m.noise.norm(c.params, c.sk, c.ct),
                  m.noise.noise_ciphertext(c.params, c.sk, c.ct, c.limbs)])


CASES = {"keys": lambda m, c: [c.sk.value.q, c.pk.value[0].q, c.pk.value[0].p,
                               c.rlk.gadget.q, c.gk.gadget.q, c.ct],
         "noise": _noise}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "keys": "26810fe7f7ec0666a3d2a4217d51cde556d34997d1ff38b68c6ab0aa8cf4b22f",
    "noise": "3d1d92fa6e34b68f75a5555558254ef13e746938a1945aea898dc80f252a165f",
}


@pytest.fixture(scope="module")
def ctx():
    return port_context()


@pytest.fixture(scope="module")
def noise(ctx):
    check_case(CASES, DIGESTS, "keys", ctx)
    return check_case(CASES, DIGESTS, "noise", ctx).view(np.float64)


def test_noise_public_key(noise):
    # fresh noise: sigma = 3.2 -> log2 std ~ 1.7 (sampling variance on N=64)
    assert noise[0] < 4.0


def test_noise_relinearization_key(noise):
    assert noise[1] < 4.0


def test_noise_galois_key(noise):
    assert noise[2] < 4.0


def test_norm_and_noise_ciphertext(noise):
    std, mn, mx, fresh = noise[3:]
    assert mx >= 19.0      # the message dominates
    assert fresh < 4.0     # against the exact plaintext: fresh encryption noise only
    assert std > fresh and mn <= mx


def test_norm_stats_exact():
    std, mn, mx = tnoise.norm_stats([-4, 4, -4, 4])
    assert std == 2.0 and mn == 2.0 and mx == 2.0


def test_evaluation_key_noise_of_a_ring_swap_key():
    """noise_evaluation_key on an n -> N key, as chip_smoke.py's phase 17
    prints it: fresh noise on the port's own keys."""
    import torch
    from matrix_fhe_tpu_torch.rlwe import ring_switch as trs
    from test_torch_ring_switch import _jax_params
    jpl, jps = _jax_params()
    pl, ps = carry.carry(jpl, "cpu"), carry.carry(jps, "cpu")
    gen = torch.Generator().manual_seed(11)
    sk_l, sk_s = TK.gen_secret_key(gen, pl), TK.gen_secret_key(gen, ps)
    up, down = trs.gen_ring_swap_keys(gen, ps, pl, sk_s, sk_l)
    emb = trs.embed_secret_key(ps, pl, sk_s)
    assert tnoise.noise_evaluation_key(pl, up.gadget, emb.value.q, sk_l) < 4.0
    assert tnoise.noise_evaluation_key(pl, down.gadget, sk_l.value.q, emb) < 4.0

"""PyTorch port, the flagship step (``flagship.py``): held bit-exact against
the JAX package's ``build_flagship`` / ``make_step`` at logN 5 with 3 q-limbs
and one 61-bit P (the PN14QP438 shape, cut in degree and depth).

The port's deterministic half (``flagship_from_samples``) gets the arrays
the JAX package drew, split as its ``build_flagship`` splits its key, and
must give its keys and ciphertexts back; the port's step on the carried
objects must equal the jitted JAX step; and the port's own
``build_flagship`` must decode at tests/test_ckks.py's 20 bits.
"""

import jax
import pytest
import torch

from matrix_fhe_tpu import flagship as jflagship
from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu_torch import carry, flagship
from matrix_fhe_tpu_torch.rlwe import decryptor
from matrix_fhe_tpu_torch.schemes import ckks

from test_torch_rlwe import _w, eq, jax_evk_samples, jax_sk_sample

LOGN, NUM_Q, NUM_P, SEED = 5, 3, 1, 0


@pytest.fixture(scope="module")
def jax_flagship():
    return jflagship.build_flagship(LOGN, NUM_Q, NUM_P, seed=SEED)


@pytest.fixture(scope="module")
def port_params(jax_flagship):
    return carry.carry(jax_flagship[0], "cpu")


def test_parameters_are_the_jax_packages(jax_flagship, port_params):
    jp = jax_flagship[0]
    built = flagship.flagship_parameters(LOGN, NUM_Q, NUM_P, device="cpu")
    assert (built.q, built.p, built.n, built.default_scale) == \
        (jp.q, jp.p, jp.n, jp.default_scale)
    assert (port_params.q, port_params.p) == (jp.q, jp.p)


def test_from_jax_samples_equals_jax_objects(jax_flagship, port_params):
    jp, jsk, jrlk, _, jct1, jct2 = jax_flagship
    ks, kr, k1, k2 = jax.random.split(jax.random.key(SEED), 4)
    secret = _w(jax.jit(lambda k: jsmp.sample(k, jp.ring_q, jp.xs))(ks))
    s = flagship.FlagshipSamples(
        secret=secret, rlk=jax_evk_samples(kr, jp, jrlk.gadget.num_digits),
        ct1=jax_sk_sample(k1, jp, jp.max_level), ct2=jax_sk_sample(k2, jp, jp.max_level))
    sk, rlk, _, ct1, ct2 = flagship.flagship_from_samples(port_params, s, SEED)
    eq(sk, jsk)
    eq(rlk, jrlk)
    eq(ct1, jct1)
    eq(ct2, jct2)


def test_step_equals_jitted_jax_step(jax_flagship, port_params):
    jp, _, jrlk, jev, jct1, jct2 = jax_flagship
    want = jax.jit(jflagship.make_step(jp, jev, jct1.metadata))(*jct1.value, *jct2.value, jrlk)
    ct1, ct2, rlk = (carry.carry(o, "cpu") for o in (jct1, jct2, jrlk))
    step = flagship.make_step(port_params, None, ct1.metadata)
    got = step(*ct1.value, *ct2.value, rlk)
    assert len(got) == 2 and got[0].shape == (NUM_Q - 1, 1 << LOGN)
    eq(got, want)


def test_port_build_flagship_decodes():
    params, sk, rlk, ev, ct1, ct2 = flagship.build_flagship(LOGN, NUM_Q, NUM_P, seed=SEED,
                                                            device="cpu")
    v1, v2 = flagship.flagship_vectors(params, SEED)
    out = flagship.make_step(params, ev, ct1.metadata)(*ct1.value, *ct2.value, rlk)
    res = ev.rescale(ev.mul_relin(ct1, ct2))
    assert all(torch.equal(a, b) for a, b in zip(out, res.value))
    got = ckks.Encoder(params).decode(decryptor.decrypt(params, sk, res))
    ckks.precision.assert_precision(v1 * v2, got, 20)
    # the same seed draws the same objects again, another seed others
    again = flagship.build_flagship(LOGN, NUM_Q, NUM_P, seed=SEED, device="cpu")
    assert torch.equal(again[1].value.q, sk.value.q)
    assert all(torch.equal(a, b) for a, b in zip(again[4].value, ct1.value))
    assert not torch.equal(again[2].gadget.q, flagship.build_flagship(
        LOGN, NUM_Q, NUM_P, seed=SEED + 1, device="cpu")[2].gadget.q)

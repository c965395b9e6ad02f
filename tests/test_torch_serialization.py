"""PyTorch port, binary serialization (``utils/serialization.py``): the
JAX package's wire format, byte for byte, in both directions.

For each of the ten types the JAX package serializes, on
tests/test_serialization.py's parameter set (logN 6): the port's object
(the JAX one carried over) round-trips; its blob equals the JAX package's
blob of the same object; the port loads the JAX blob back to the carried
object, and the JAX package loads the port's blob back to its own.  Then
the three digests tests/test_serialization.py pins, from the port's own
encoder and from the JAX package's draws through the port's
``*_from_sample(s)`` halves, and the errors ``save`` and ``load`` raise.
"""

import hashlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rgsw as jrgsw
from matrix_fhe_tpu.ops import samplers as jsmp
from matrix_fhe_tpu.rlwe import elements as jelements
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu.utils import serialization as jser
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.schemes import ckks
from matrix_fhe_tpu_torch.utils import serialization as ser

from test_torch_rlwe import _w, eq, jax_evk_samples

TYPES = ("params", "pt", "ct", "sk", "pk", "gct", "rlk", "evk", "gk", "rgsw")

# tests/test_serialization.py:test_const_wire_vectors
WIRE_LITERAL = dict(logn=6, logq=(45, 45), logp=(45,), log_default_scale=40)
WIRE_SHA256 = {
    "pt": "c41d1ceaadc10de792cab7744df18b2415947e379c058c3f0a8f3f1374af7b81",
    "sk": "d9c48cc67d4295c6038b9d5f612f1dbcea5b93869fe13e80ea0d1236dfa41f3c",
    "rlk": "4b2784f830a504c3037f2bcc0e8d9172c56853b49b847904208eba2a0a8a1b09",
}


@pytest.fixture(scope="module")
def jobjs():
    """One JAX object of each type, made as tests/test_serialization.py
    makes them (its parameters, its keys' seeds)."""
    params = jckks.new_parameters(jckks.CKKSParametersLiteral(
        logn=6, logq=(55, 45), logp=(60,), log_default_scale=45))
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    # the port's encoder (bit-exact to the JAX package's, test_torch_ckks.py):
    # the JAX encoder runs eagerly, for seconds
    rng = np.random.default_rng(0)
    tpt = ckks.Encoder(carry.carry(params, "cpu")).encode(
        rng.uniform(-1, 1, params.max_slots) + 0j)
    pt = jelements.Plaintext(value=jnp.asarray(tpt.value.numpy().view(np.uint64)),
                             metadata=jelements.MetaData(**vars(tpt.metadata)))
    # jitted: eager, the u64 ops compile one by one, for seconds a key
    rlk = jax.jit(lambda k: JK.gen_relinearization_key(k, params, sk))(jax.random.key(3))
    sk2 = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(6))
    return {
        "params": params, "pt": pt,
        "ct": jax.jit(lambda k, p: jenc.encrypt(k, params, sk, p))(jax.random.key(1), pt),
        "sk": sk,
        "pk": jax.jit(lambda k: JK.gen_public_key(k, params, sk))(jax.random.key(2)),
        "gct": rlk.gadget, "rlk": rlk,
        "evk": jax.jit(lambda k: JK.gen_evaluation_key(k, params, sk.value.q, sk2))(
            jax.random.key(7)),
        "gk": jax.jit(lambda k: JK.gen_galois_key(k, params, sk, params.galois_element(1)))(
            jax.random.key(4)),
        "rgsw": jax.jit(lambda k: jrgsw.encrypt_plaintext(k, params, sk, 3))(jax.random.key(5)),
    }


def _same_params(got, want) -> None:
    """Parameters equal by their literal and by their regenerated rings."""
    for f in ("n", "nth_root", "q", "p", "ring_type", "ntt_flag", "xe", "xs"):
        assert getattr(got, f) == getattr(want, f), f
    assert float(got.default_scale) == float(want.default_scale)
    for rg, rw in ((got.ring_q, want.ring_q), (got.ring_p, want.ring_p)):
        assert rg.moduli_tuple == rw.moduli_tuple
        for t in ("psi2", "ipsi2"):
            assert torch.equal(getattr(rg, t), getattr(rw, t)), t


def _same(got, jobj) -> None:
    """A loaded port object equals the JAX object ``jobj``, field by field
    (parameters: the carried ones, by their literal and rings)."""
    if isinstance(got, Parameters):
        _same_params(got, carry.carry(jobj, "cpu"))
    else:
        eq(got, jobj)


@pytest.mark.parametrize("kind", TYPES)
def test_round_trip(jobjs, kind):
    obj = carry.carry(jobjs[kind], "cpu")
    data = ser.save(obj)
    back = ser.load(data, device="cpu")
    assert type(back) is (Parameters if kind == "params" else type(obj))
    _same(back, jobjs[kind])
    assert ser.save(back) == data
    # a writer gets the same bytes and their count
    w = io.BytesIO()
    assert ser.save(obj, w) == len(data) and w.getvalue() == data
    assert type(ser.load(io.BytesIO(data), device="cpu")) is type(back)


@pytest.mark.parametrize("kind", TYPES)
def test_blob_equals_jax_blob(jobjs, kind):
    assert ser.save(carry.carry(jobjs[kind], "cpu")) == jser.save(jobjs[kind])


@pytest.mark.parametrize("kind", TYPES)
def test_each_package_loads_the_others_blob(jobjs, kind):
    jobj = jobjs[kind]
    _same(ser.load(jser.save(jobj), device="cpu"), jobj)
    back = jser.load(ser.save(carry.carry(jobj, "cpu")))
    assert jser.save(back) == jser.save(jobj)


def test_loaded_parameters_regenerate_the_rings(jobjs):
    jp = jobjs["params"]
    loaded = ser.load(jser.save(jp), device="cpu")
    built = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=6, logq=(55, 45), logp=(60,), log_default_scale=45), "cpu")
    _same_params(loaded, built)
    # the JAX package's forward roots, the same tables on both sides
    np.testing.assert_array_equal(
        np.asarray(jser.load(ser.save(loaded)).ring_q.roots_fwd),
        np.asarray(jp.ring_q.roots_fwd))
    assert loaded.decomposer(1, 0).num_digits == jp.decomposer(1, 0).num_digits


def test_const_wire_vectors():
    """tests/test_serialization.py:105-110's digests: the plaintext from the
    port's encoder alone, the secret and relinearization keys from the JAX
    package's draws of key(0) and key(1) through the port's deterministic
    halves."""
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**WIRE_LITERAL), "cpu")
    v = np.arange(params.max_slots) / params.max_slots + 0j
    pt = ckks.Encoder(params).encode(v)
    assert hashlib.sha256(ser.save(pt)).hexdigest() == WIRE_SHA256["pt"]

    jp = jckks.new_parameters(jckks.CKKSParametersLiteral(**WIRE_LITERAL))
    small = _w(jax.jit(lambda k: jsmp.sample(k, jp.ring_q, jp.xs))(jax.random.key(0)))
    sk = TK.secret_key_from_sample(params, small)
    rows = len(jp.q)  # one P prime: a row a q-limb
    rlk = TK.relinearization_key_from_samples(params, sk,
                                              jax_evk_samples(jax.random.key(1), jp, rows))
    assert hashlib.sha256(ser.save(sk)).hexdigest() == WIRE_SHA256["sk"]
    assert hashlib.sha256(ser.save(rlk)).hexdigest() == WIRE_SHA256["rlk"]


def _bad_magic():
    head = b'{"h":{"t":"pt"},"m":[]}'
    ser.load(b"MFT0" + len(head).to_bytes(4, "little") + head, device="cpu")


def _unknown_tag():
    head = b'{"h":{"t":"nope"},"m":[]}'
    ser.load(ser.MAGIC + len(head).to_bytes(4, "little") + head, device="cpu")


def _base_two_gadget():
    """A base-two gadget: the JAX package writes it and loads it back with
    base_two 0, the RNS gadget; the port refuses it."""
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**WIRE_LITERAL), "cpu")
    sk = TK.gen_secret_key(torch.Generator().manual_seed(0), params)
    rlk = TK.gen_relinearization_key(torch.Generator().manual_seed(1), params, sk,
                                     TK.EvaluationKeyParameters(level_p=0, base_two_decomposition=20))
    assert rlk.gadget.base_two == 20
    ser.save(rlk)


@pytest.mark.parametrize("call, error, match", [
    (_bad_magic, ValueError, "bad magic"),
    (_unknown_tag, ValueError, "unknown type tag"),
    (lambda: ser.save({"not": "serializable"}), TypeError, "cannot serialize dict"),
    (_base_two_gadget, ValueError, "base-two gadget"),
], ids=["bad magic", "unknown tag", "unsupported type", "base-two gadget"])
def test_errors(call, error, match):
    with pytest.raises(error, match=match):
        call()

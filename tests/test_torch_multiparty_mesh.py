"""PyTorch port, the multiparty share aggregation over a party axis
(multiparty/mesh.py): tests/test_multiparty_mesh.py's two tests at its
parameters (logN 7, two 45-bit Q primes, a 45-bit P, scale 2^40) and 8
parties, one a gloo rank on the CPU (``parallel/launch.py``).

Each party's secret and share noise, and the common polynomial, are the
arrays the JAX test draws (``K.gen_secret_key(k)``, ``gen_share`` under
``fold_in(k, 1)``, ``sample_crp`` from key 11), handed to
``collective_pk_over_mesh_from_samples``.  The JAX package's sequential
``gen_share`` / ``aggregate`` / ``finalize`` (equal to its mesh version,
tests/test_multiparty_mesh.py) and its secrets are pinned as digests
(``DIGESTS``, from ``tools/port_circuit_digests.py
test_torch_multiparty_mesh``: eagerly, the secrets alone take ~18 s).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import multiparty as jmp
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch.multiparty import mesh as mpm
from matrix_fhe_tpu_torch.multiparty import protocols
from matrix_fhe_tpu_torch.parallel import api, launch
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import ckks
from matrix_fhe_tpu_torch.schemes.ckks import precision
from test_torch_matrix_ckks import _SAMPLE, _UNIFORM
from test_torch_polynomial import digest
import torch_worlds

PARTIES = 8
LITERAL = dict(logn=7, logq=(45, 45), logp=(45,), log_default_scale=40)


def _jax_params():
    return jckks.new_parameters(jckks.CKKSParametersLiteral(**LITERAL))


def _party_keys():
    return jax.random.split(jax.random.key(0), PARTIES)


@functools.lru_cache(maxsize=None)
def jax_draws():
    """The arrays tests/test_multiparty_mesh.py draws: each party's secret
    (Xs) and share noise (Xe, under fold_in(k, 1)), and the crp's (Q, P)
    uniform draws from key 11 (sample_crp_qp's split), as int64 words."""
    jp = _jax_params()
    samples = [(np.array(_SAMPLE(k, jp.ring_q, jp.xs)).view(np.int64),
                np.array(_SAMPLE(jax.random.fold_in(k, 1), jp.ring_q, jp.xe)).view(np.int64))
               for k in _party_keys()]
    kq, kp = jax.random.split(jax.random.key(11))
    crp = (np.array(_UNIFORM(kq, jp.ring_q)).view(np.int64),
           np.array(_UNIFORM(kp, jp.ring_p)).view(np.int64))
    return samples, crp


def jax_context():
    params = _jax_params()
    sks = [JK.gen_secret_key(k, params) for k in _party_keys()]
    return params, sks, jmp.PublicKeyGen.sample_crp(jax.random.key(11), params)


def _sequential_pk(m, c):
    params, sks, crp = c
    shares = [jmp.PublicKeyGen.gen_share(jax.random.fold_in(k, 1), params, sks[i], crp)
              for i, k in enumerate(_party_keys())]
    agg = shares[0]
    for s in shares[1:]:
        agg = jmp.PublicKeyGen.aggregate(params, agg, s)
    pk = jmp.PublicKeyGen.finalize(params, agg, crp)
    return [pk.value[0].q, pk.value[0].p]


CASES = {
    "secrets": lambda m, c: [[s.value.q, s.value.p] for s in c[1]],
    "sequential pk": _sequential_pk,
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "secrets": "c573dd6feb2c863591e69177a6774242f3d24f0c54aefe854951507f99e726a3",
    "sequential pk": "3a61202183deaebdfdb222cde9a45f5962ed6b3c6035d92483cea8b0b946886e",
}


@pytest.fixture(scope="module")
def world():
    samples, crp = jax_draws()
    return launch.run(torch_worlds.pk_world, PARTIES, LITERAL, samples, crp, device="cpu")


@pytest.fixture(scope="module")
def params():
    return ckks.new_parameters(ckks.CKKSParametersLiteral(**LITERAL), "cpu")


def test_matches_sequential_aggregation(world, params):
    pks = [r["pk"] for r in world]
    assert all(all(np.array_equal(a, b) for a, b in zip(pk, pks[0])) for pk in pks)
    assert digest(list(pks[0])) == DIGESTS["sequential pk"]
    assert digest([list(r["sk"]) for r in world]) == DIGESTS["secrets"]
    # and the port's own sequential aggregation of the same shares
    samples, crp = jax_draws()
    crp_qp = protocols.crp_qp_from_samples(params, *(torch.from_numpy(a) for a in crp))
    agg = None
    for s, e in samples:
        sk = TK.secret_key_from_sample(params, torch.from_numpy(s))
        share = protocols.PublicKeyGen.share_from_sample(params, sk, crp_qp, torch.from_numpy(e))
        agg = share if agg is None else protocols.PublicKeyGen.aggregate(params, agg, share)
    want = protocols.PublicKeyGen.finalize(params, agg, crp_qp).value[0]
    assert np.array_equal(pks[0][0], want.q.numpy()) and np.array_equal(pks[0][1], want.p.numpy())


def test_collective_budget(world):
    for r in world:  # one psum for each of the Q and P planes
        assert {k: r["counts"][k] for k in api.counts} == {
            "all_gather": 0, "psum": 2, "all_to_all": 0}, r["counts"]


def test_collective_pk_encrypts(world, params):
    rq, rp = params.ring_q, params.ring_p
    sk_q, sk_p = (torch.from_numpy(a) for a in world[0]["sk"])
    for r in world[1:]:
        sk_q = rq.add(sk_q, torch.from_numpy(r["sk"][0]))
        sk_p = rp.add(sk_p, torch.from_numpy(r["sk"][1]))
    sk_ideal = TK.SecretKey(value=TK.QPPoly(q=sk_q, p=sk_p))
    pk = TK.PublicKey(value=(TK.QPPoly(*(torch.from_numpy(a) for a in world[0]["pk"])),
                             protocols.crp_qp_from_samples(
                                 params, *(torch.from_numpy(a) for a in jax_draws()[1]))))
    enc = ckks.Encoder(params)
    v = np.random.default_rng(0).uniform(-1, 1, params.max_slots) + 0j
    ct = encryptor.encrypt(torch.Generator().manual_seed(5), params, pk, enc.encode(v))
    got = enc.decode(decryptor.decrypt(params, sk_ideal, ct))
    precision.assert_precision(v, got, 10)


def test_bound_raises(params):
    """n_parties * q >= 2^52 raises, as multiparty/mesh.py:58 of the JAX
    package does (8 parties at a 55-bit prime)."""
    wide = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45), logp=(45,), log_default_scale=40), "cpu")
    mesh = api.Mesh(axis_names=("party",), axis_sizes=(PARTIES,), coords=(0,), groups=(None,),
                    device=torch.device("cpu"))
    crp = protocols.sample_crp_qp(torch.Generator().manual_seed(0), wide)
    with pytest.raises(ValueError, match="2\\^52"):
        mpm.collective_pk_over_mesh_from_samples(wide, mesh, [], crp)


def test_sample_split():
    """The draws: each party's secret then noise, from one generator."""
    p = ckks.new_parameters(ckks.CKKSParametersLiteral(**LITERAL), "cpu")
    a = mpm.sample_collective_pk_over_mesh(p, 3, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    for s in a:
        assert torch.equal(s.secret, TK.sample_secret(g, p))
        assert torch.equal(s.noise, protocols.PublicKeyGen.sample_share(g, p))

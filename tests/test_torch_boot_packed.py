"""PyTorch port, the packed and the sparse batch bootstrap
(circuits/ckks/bootstrapping.py's ``bootstrap_packed`` and
``bootstrap_sparse``, over rlwe/ring_packing.py and rlwe/ring_switch.py):
tests/test_boot_packed.py's two cases at their size
(``wide_parameters_literal(6, residual_levels=2, sparse_weight=0)``),
slow-marked as the JAX package marks them (tests/test_boot_packed.py:18,53).

The port's keys and ciphertexts are made from the arrays the JAX package
draws (the evaluation keys of ``key(1)``, the extra galois keys of
``key(2)``, the logN-5 secret of ``key(5)`` and the ring-swap keys of
``key(6)``); the JAX side of both refreshes runs once, in
``tools/port_circuit_digests.py test_torch_boot_packed``, which pins their
sha256 here (``DIGESTS``).  The decoded payloads are held to the JAX tests'
floors (min precision above 8 bits packed, above 7 sparse).  The wide
bootstrapper (``make_wide_bootstrapper``, which the card runs) gives the
u64 evaluator's outputs bit for bit on the same keys.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.rlwe import ring_switch as trs
from test_torch_bootstrapping import jax_evaluation_key_samples
from test_torch_matrix_ckks import _SAMPLE, evk_draws, sk_draws
from test_torch_polynomial import JAX, PORT, check_case, digest
from test_torch_rlwe import _w, jax_galois_samples


def _jax_parameters():
    p = JAX.btp.Parameters(JAX.fboot.wide_parameters_literal(6, residual_levels=2,
                                                             sparse_weight=0))
    params = p.params
    small = JAX.ckks.new_parameters(JAX.ckks.CKKSParametersLiteral(
        logn=params.log_n - 1, q=tuple(params.q), p=tuple(params.p),
        log_default_scale=p.lit.log_default_scale))
    return p, small


def _payloads(half):
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, half), rng.uniform(-1, 1, half)


def _extra(m, params, gks):
    return [g for g in m.btp.galois_elements_for_packed_bootstrap(params, 2) if g not in gks]


def jax_context():
    """tests/test_boot_packed.py's two sessions (one key set serves both)."""
    p, small = _jax_parameters()
    params = p.params
    sk = JK.gen_secret_key(jax.random.key(0), params)
    evk = JAX.btp.gen_evaluation_keys(jax.random.key(1), p, sk)
    evk.gks.update(JK.gen_galois_keys(jax.random.key(2), params, sk,
                                      _extra(JAX, params, evk.gks)))
    enc = JAX.ckks.Encoder(params)
    va, vb = _payloads(params.max_slots // 2)
    packed = [jenc.encrypt(jax.random.key(k), params, sk,
                           enc.encode(np.tile(v, 2), level=p.residual_level))
              for k, v in ((3, va), (4, vb))]
    from matrix_fhe_tpu.rlwe import ring_switch as jrs
    sk_small = JK.gen_secret_key(jax.random.key(5), small)
    up, down = jrs.gen_ring_swap_keys(jax.random.key(6), small, params, sk_small, sk)
    enc_small = JAX.ckks.Encoder(small)
    sa, sb = _payloads(small.max_slots)
    sparse = [jenc.encrypt(jax.random.key(k), small, sk_small,
                           enc_small.encode(v, level=p.residual_level))
              for k, v in ((3, sa), (4, sb))]
    return SimpleNamespace(p=p, small=small, sk=sk, evk=evk, packed=packed, sk_small=sk_small,
                           up=up, down=down, sparse=sparse)


def port_context():
    jp_, jsmall = _jax_parameters()
    p, small = carry.carry(jp_, "cpu"), carry.carry(jsmall, "cpu")
    params, jparams = p.params, jp_.params
    sk = TK.secret_key_from_sample(params, _w(_SAMPLE(jax.random.key(0), jparams.ring_q,
                                                      jparams.xs)))
    evk = PORT.btp.evaluation_keys_from_samples(
        p, sk, jax_evaluation_key_samples(jax.random.key(1), jp_))
    rows = params.base_rns_decomposition_vector_size(params.max_level)
    extra = _extra(PORT, params, evk.gks)
    evk.gks.update({g: TK.galois_key_from_samples(params, sk, g, d) for g, d in
                    jax_galois_samples(jax.random.key(2), jparams, extra, rows).items()})
    enc = PORT.ckks.Encoder(params)
    level = p.residual_level
    va, vb = _payloads(params.max_slots // 2)
    packed = [tenc.encrypt_from_sample(params, sk, enc.encode(np.tile(v, 2), level=level),
                                       sk_draws(jax.random.key(k), jparams, level))
              for k, v in ((3, va), (4, vb))]
    sk_small = TK.secret_key_from_sample(small, _w(_SAMPLE(jax.random.key(5), jsmall.ring_q,
                                                           jsmall.xs)))
    ku, kd = jax.random.split(jax.random.key(6))
    up, down = trs.ring_swap_keys_from_samples(
        small, params, sk_small, sk, (evk_draws(ku, jparams, rows), evk_draws(kd, jparams, rows)))
    enc_small = PORT.ckks.Encoder(small)
    sa, sb = _payloads(small.max_slots)
    sparse = [tenc.encrypt_from_sample(small, sk_small, enc_small.encode(v, level=level),
                                       sk_draws(jax.random.key(k), jsmall, level))
              for k, v in ((3, sa), (4, sb))]
    return SimpleNamespace(p=p, small=small, sk=sk, evk=evk, packed=packed, sk_small=sk_small,
                           up=up, down=down, sparse=sparse)


def _bts(m, c):
    if not hasattr(c, "bts"):
        c.bts = m.btp.Evaluator(c.p, c.evk)
    return c.bts


CASES = {
    "inputs": lambda m, c: c.packed + c.sparse + [c.up.gadget.q, c.down.gadget.q],
    "packed": lambda m, c: _bts(m, c).bootstrap_packed(c.packed),
    "sparse": lambda m, c: _bts(m, c).bootstrap_sparse(c.sparse, c.small, c.up, c.down),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "inputs": "555f1801a9957f3f73a33f40e3d92d858805601cb7403ef7a925b6bdfb87cd8f",
    "packed": "1b491d6e5b6c5811994445023c06b4f11c80e7488982c07a9a05dfdebed2adf3",
    "sparse": "e905db5218b3717160f909e2eee711f66f07d5d420f1d3debf80199bc016adc6",
}


@pytest.fixture(scope="module")
def ctx():
    c = port_context()
    check_case(CASES, DIGESTS, "inputs", c)
    return c


def _min_precision(enc, params, sk, ct, want) -> float:
    got = enc.decode(tdec.decrypt(params, sk, ct))
    err = np.abs(np.asarray(got).real[:len(want)] - want)
    return -np.log2(np.maximum(err.max(), 1e-17))


@pytest.mark.slow  # as tests/test_boot_packed.py:18 marks the same case
def test_bootstrap_packed_two(ctx):
    c = ctx
    outs = check_case(CASES, DIGESTS, "packed", c)
    assert len(outs) == 2
    params = c.p.params
    enc = PORT.ckks.Encoder(params)
    for out, v in zip(outs, _payloads(params.max_slots // 2)):
        assert out.level == c.p.residual_level
        prec = _min_precision(enc, params, c.sk, out, v)
        assert prec > 8, f"packed refresh precision {prec:.1f} bits"
    # the wide pipeline between the same pack and expand: the same words
    wide = PORT.fboot.make_wide_bootstrapper(c.p, c.evk)
    assert digest(wide.bootstrap_packed(c.packed)) == DIGESTS["packed"]


@pytest.mark.slow  # as tests/test_boot_packed.py:53 marks the same case
def test_bootstrap_sparse_cross_degree(ctx):
    c = ctx
    outs = check_case(CASES, DIGESTS, "sparse", c)
    assert len(outs) == 2
    enc = PORT.ckks.Encoder(c.small)
    for out, v in zip(outs, _payloads(c.small.max_slots)):
        assert out.level == c.p.residual_level
        prec = _min_precision(enc, c.small, c.sk_small, out, v)
        assert prec > 7, f"sparse cross-degree refresh precision {prec:.1f}"

"""PyTorch port, fast-path bootstrapping (fast/fboot.py): the int32 pipeline
on the JAX package's keys and ciphertexts at logN 6.

* The keystone: at ``fast_parameters_literal(6, residual_levels=2,
  sparse_weight=0)`` with JAX's keys ``key(0)`` / ``key(1)`` and encryption
  ``key(3)``, the port's fast ``bootstrap`` hashes to tests/test_fboot.py's
  ``U64_BOOT_DIGEST``, the JAX package's u64 pipeline's output; so does the
  port's own u64 pipeline on the same inputs.
* The sparse encapsulation (``sparse_weight=8``) and META-BTS
  (``evaluate(iterations=2)``): the port's outputs hash to the JAX package's
  fast pipeline's (``DIGESTS``, tools/port_circuit_digests.py); the
  encapsulation keys made from JAX's draws equal JAX's.
* The staged bootstrap (circuits/ckks/staged.py; on the CPU every stage
  runs eagerly): its output hashes to ``U64_BOOT_DIGEST``, as
  tests/test_fboot.py's staged case, and its stages' names and outputs
  (``run_stages``) hash to the JAX package's ``StagedBootstrapper``'s.
* The presets and the chain check equal the JAX package's.

No precision is asserted, as in tests/test_fboot.py: this chain decodes to
noise (ROADMAP C).
"""

import dataclasses
import gzip
import hashlib
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from test_fboot import U64_BOOT_DIGEST
from test_torch_bootstrapping import jax_evaluation_key_samples
from test_torch_ckks import jax_encode
from test_torch_polynomial import JAX, PORT, check_case
from test_torch_rlwe import eq


def _jax_session(weight, seed, cplx):
    """tests/test_fboot.py's keys and input at sparse weight ``weight``."""
    p = JAX.btp.Parameters(JAX.fboot.fast_parameters_literal(6, residual_levels=2,
                                                            sparse_weight=weight))
    params = p.params
    sk = jax.jit(lambda k: JK.gen_secret_key(k, params))(jax.random.key(0))
    evk = JAX.btp.gen_evaluation_keys(jax.random.key(1), p, sk)
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, params.max_slots) + (
        1j * rng.uniform(-1, 1, params.max_slots) if cplx else 0j)
    pt = jax_encode(JAX.ckks.Encoder(params), params, v, level=p.residual_level)
    ct = jax.jit(lambda k, s, pt: jenc.encrypt(k, params, s, pt))(jax.random.key(3), sk, pt)
    return SimpleNamespace(p=p, sk=sk, evk=evk, ct=ct)


def jax_context():
    return SimpleNamespace(dense=_jax_session(0, 0, True), sparse=_jax_session(8, 2, False))


# the dense session for the card's test, where JAX is absent
# (tests/test_torch_staged_cuda.py; written by tools/port_staged_fixture.py)
FIXTURE = pathlib.Path(__file__).parent / "data" / "fboot_logn6_jax.mft.gz"


def jax_blobs(s) -> bytes:
    """A JAX session's relinearization key, ciphertext and galois keys (by
    element), one after the other in the JAX package's wire format."""
    from matrix_fhe_tpu.utils import serialization as js
    return b"".join([js.save(s.evk.rlk), js.save(s.ct)]
                    + [js.save(s.evk.gks[g]) for g in sorted(s.evk.gks)])


def _bts(m, s):
    """The session's fast bootstrapper, made on first use."""
    if not hasattr(s, "bts"):
        s.bts = m.fboot.make_fast_bootstrapper(s.p, s.evk)
    return s.bts


def _stages(m, s):
    """The staged bootstrap's stages: each one's name (as bytes) and output,
    in order; run on first use."""
    if not hasattr(s, "stages"):
        st = m.staged.StagedBootstrapper(_bts(m, s))
        s.stages = [(np.frombuffer(name.encode(), np.uint8), ct)
                    for name, ct in st.run_stages(m.feval.ct_to_fast(s.ct))]
    return s.stages


CASES = {
    "bootstrap_sparse": lambda m, c: _bts(m, c.sparse).bootstrap(
        m.feval.ct_to_fast(c.sparse.ct)),
    "evaluate_iterations_2": lambda m, c: _bts(m, c.dense).evaluate(
        m.feval.ct_to_fast(c.dense.ct), iterations=2),
    "staged_stages": lambda m, c: _stages(m, c.dense),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "bootstrap_sparse": "261e8485c1d9a4391f2eee31aa35ddae3dfc1837519c73563fe47d6c9355fe2e",
    "evaluate_iterations_2": "4f6d572347dcf3f92488e9c855484f3779d03ee4cf23dc03293d6eb5164ef297",
    "staged_stages": "f747427f6bd85876387030109d6d91b9b441ccdf2726b6aa7acf7f5f93363dc5",
}


@pytest.fixture(scope="module")
def jctx():
    return jax_context()


@pytest.fixture(scope="module")
def ctx(jctx):
    out = SimpleNamespace()
    for name in ("dense", "sparse"):
        s = getattr(jctx, name)
        setattr(out, name, SimpleNamespace(
            p=carry.carry(s.p, "cpu"), **carry.carry(dict(sk=s.sk, evk=s.evk, ct=s.ct), "cpu")))
    return out


def _u64_digest(ct) -> str:
    """tests/test_fboot.py's hash: the limbs as uint64 words."""
    h = hashlib.sha256()
    for v in ct.value:
        h.update(v.long().numpy().astype("<u8").tobytes())
    return h.hexdigest()


def test_fast_bootstrap_matches_u64_digest(ctx):
    s = ctx.dense
    bts = _bts(PORT, s)
    out = bts.bootstrap(PORT.feval.ct_to_fast(s.ct))
    assert out.level == s.p.residual_level and out.scale == s.p.params.default_scale
    assert all(v.dtype == torch.int32 for v in out.value)
    assert _u64_digest(out) == U64_BOOT_DIGEST


def test_u64_bootstrap_matches_u64_digest(ctx):
    """The port's u64 pipeline on the fast chain: the same limbs."""
    s = ctx.dense
    assert _u64_digest(PORT.btp.Evaluator(s.p, s.evk).bootstrap(s.ct)) == U64_BOOT_DIGEST


def test_fast_bootstrap_staged_digest(ctx):
    """tests/test_fboot.py:65: the staged bootstrap gives the eager one's
    limbs (its last stage's output; ``__call__`` returns it, as
    tests/test_torch_wboot.py's staged case checks)."""
    s = ctx.dense
    out = _stages(PORT, s)[-1][1]
    assert out.level == s.p.residual_level and out.scale == s.p.params.default_scale
    assert _u64_digest(out) == U64_BOOT_DIGEST


def test_staged_stages(ctx):
    """Stage by stage, the names and outputs of the JAX package's
    StagedBootstrapper."""
    out = check_case(CASES, DIGESTS, "staged_stages", ctx)
    assert [bytes(name).decode() for name, _ in out] == [
        "head", "c2s[0]", "c2s[1]", "c2s[2]", "c2s_tail", "evalmod2", "s2c[0]", "s2c[1]",
        "s2c[2]"]


def test_staged_refuses_divergent_stages(ctx):
    """The stages follow the DFT's level groups, and refuse a format whose
    CoeffsToSlots has no conjugate split."""
    bts = _bts(PORT, ctx.dense)
    lit = bts.c2s_matrix.literal
    grouped = SimpleNamespace(literal=dataclasses.replace(lit, levels=[2, 1]),
                              matrices=bts.c2s_matrix.matrices)
    assert [len(g) for g in PORT.staged._level_groups(grouped)] == [2, 1]
    standard = SimpleNamespace(**vars(bts))
    standard.c2s_matrix = SimpleNamespace(literal=dataclasses.replace(lit, format="standard"),
                                          matrices=bts.c2s_matrix.matrices)
    with pytest.raises(ValueError, match="format"):
        PORT.staged.StagedBootstrapper(standard)


def test_card_fixture_is_the_jax_session(jctx):
    assert gzip.decompress(FIXTURE.read_bytes()) == jax_blobs(jctx.dense)


def test_fast_bootstrap_sparse_encapsulation(ctx):
    out = check_case(CASES, DIGESTS, "bootstrap_sparse", ctx)
    assert out.level == ctx.sparse.p.residual_level


def test_evaluate_iterations_2(ctx):
    out = check_case(CASES, DIGESTS, "evaluate_iterations_2", ctx)
    p = ctx.dense.p
    assert out.level == p.residual_level - 1 and out.scale == p.params.default_scale


def test_encapsulation_keys_from_jax_samples(jctx, ctx):
    s = ctx.sparse
    assert s.evk.evk_dense_to_sparse is not None
    eq(PORT.btp.evaluation_keys_from_samples(s.p, s.sk, jax_evaluation_key_samples(
        jax.random.key(1), jctx.sparse.p)), s.evk)


@pytest.mark.parametrize("log_n, residual, weight", [(6, 2, 0), (8, 3, 32), (12, 3, 32),
                                                     (13, 3, 32), (14, 3, 32)])
def test_fast_parameters_literal(log_n, residual, weight):
    got = PORT.fboot.fast_parameters_literal(log_n, residual, weight)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JAX.fboot.fast_parameters_literal(log_n, residual, weight))
    if log_n == 14:
        assert dataclasses.asdict(PORT.fboot.FAST_N14) == dataclasses.asdict(got)


def test_check_fast_chain():
    with pytest.raises(ValueError, match="2\\^23"):
        PORT.fboot.check_fast_chain(SimpleNamespace(q=[(1 << 23) + 15], p=[]))
    with pytest.raises(ValueError, match="residual"):
        PORT.fboot.fast_parameters_literal(14, residual_levels=4)

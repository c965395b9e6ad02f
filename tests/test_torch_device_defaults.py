"""PyTorch port: every public constructor puts its tensors on the card
unless asked for another device.  Without a card, a call that names no
device raises instead of building on the CPU; with one, it builds on the
card.  Decided inside the test, not at import."""

import os
import tempfile
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from matrix_fhe_tpu_torch import carry, flagship, rlwe
from matrix_fhe_tpu_torch.examples import ckks_template
from matrix_fhe_tpu_torch.multiparty import mesh as mpm
from matrix_fhe_tpu_torch.multiparty import mpbgv, mpckks, protocols, threshold
from matrix_fhe_tpu_torch.fast import fckks, fring, frns, wckks, wring, wrns
from matrix_fhe_tpu_torch.ops import ntt_3n, ntt_cuda, ntt_w22, rings, rns_tools
from matrix_fhe_tpu_torch.parallel import api, launch, ntt_sharded
from matrix_fhe_tpu_torch.rgsw import blindrot, rgsw
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe import params as rparams
from matrix_fhe_tpu_torch.rlwe import ring_packing
from matrix_fhe_tpu_torch.schemes import bgv, ckks, matrix_ckks
from matrix_fhe_tpu_torch.utils import primes, serialization

N = 1 << 5
Q = ntt_cuda.find_v2_primes(N, 4)
Q, P = Q[:2], Q[2:]
W22 = ntt_w22.find_w22_primes(N, 2)
WIDE = list(wckks.PN14QP438_Q[:2]), list(wckks.PN14QP438_P)
N3 = 48  # a 3N ring's degree, and its primes
Q3 = primes.find_3n_rns_primes(N3, 40, 2)
CI = primes.NTTFriendlyPrimesGenerator(40, 4 * N).next_alternating_primes(2)


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32).numpy()


def _params():
    return rlwe.new_parameters(rlwe.ParametersLiteral(logn=5, q=tuple(Q), p=tuple(P)))


def _lwe_params():
    return rlwe.new_parameters(rlwe.ParametersLiteral(logn=4, q=tuple(Q[:1])))


def _gen():
    return torch.Generator().manual_seed(0)


def _share(params):
    """A zero (Q, P) share on the parameters' device."""
    return K.QPPoly(q=torch.zeros((len(params.q), params.n), dtype=torch.int64,
                                  device=params.device),
                    p=torch.zeros((len(params.p), params.n), dtype=torch.int64,
                                  device=params.device))


def _mesh():
    """make_mesh() with its default device, in a one-rank world of this
    process (gloo, a file store)."""
    fd, store = tempfile.mkstemp()
    os.close(fd)
    os.unlink(store)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        return api.make_mesh()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)


# each builds with its default device and returns one of the tensors it made
CONSTRUCTORS = {
    "ntt_cuda.build_tables": lambda: ntt_cuda.build_tables(N, Q).psi,
    "ntt_w22.build_tables": lambda: ntt_w22.build_tables(N, W22).psi,
    "fring.new_fast_ring": lambda: fring.new_fast_ring(N, Q).moduli,
    "frns.gen_fast_modup_constants": lambda: frns.gen_fast_modup_constants(Q, P).src_q_f64,
    "frns.gen_fast_moddown_constants": lambda: frns.gen_fast_moddown_constants(Q, P).pinv_mod_q,
    "frns.gen_fast_decomposer": lambda: frns.gen_fast_decomposer(Q, P).mucs[0].src_q_f64,
    "fckks.context_from_arrays": lambda: fckks.context_from_arrays(
        N, Q, P, _zeros(1, 2, 2, N), _zeros(1, 2, 2, N)).rlk_q,
    "fckks.make_synthetic_context": lambda: fckks.make_synthetic_context(5, 2, 2)[1][0],
    "rings.new_ring": lambda: rings.new_ring(N, Q).moduli,
    "rns_tools.gen_modup_constants": lambda: rns_tools.gen_modup_constants(Q, P).src_q_f64,
    "rns_tools.gen_moddown_constants":
        lambda: rns_tools.gen_moddown_constants(Q, P).moddown_const,
    "rns_tools.gen_decomposer": lambda: rns_tools.gen_decomposer(Q, P).mucs[0].src_q_f64,
    "rlwe.new_parameters": lambda: rlwe.new_parameters(
        rlwe.ParametersLiteral(logn=5, q=tuple(Q), p=tuple(P))).ring_q.moduli,
    "rlwe.Parameters": lambda: rlwe.Parameters(
        n=N, nth_root=2 * N, q=Q, p=P, xe=rparams.DEFAULT_XE, xs=rparams.DEFAULT_XS,
        ring_type=rings.STANDARD, ntt_flag=True, default_scale=1.0).ring_p.moduli,
    "ckks.new_parameters": lambda: ckks.new_parameters(
        ckks.CKKSParametersLiteral(logn=5, q=tuple(Q), p=tuple(P))).ring_q.moduli,
    "carry.carry": lambda: carry.carry(_zeros(2, N).astype("uint64")),
    "wring.new_wide_ring": lambda: wring.new_wide_ring(N, WIDE[0]).psi2,
    "wrns.gen_wide_decomposer": lambda: wrns.gen_wide_decomposer(*WIDE).mucs[0].src_q_f64,
    "wckks.context_from_arrays": lambda: wckks.context_from_arrays(
        N, *WIDE, _zeros(1, 2, 2, N), _zeros(1, 2, 2, N)).rlk_q,
    "wckks.make_synthetic_context": lambda: wckks.make_synthetic_context(5, 2, 2)[1][0],
    "carry.carry_wide": lambda: carry.carry_wide(_zeros(2, 2, N), SimpleNamespace(
        q=WIDE[0], p=WIDE[1])),
    "rings.new_ring(matrix)": lambda: rings.new_ring(N3, Q3, rings.MATRIX).moduli,
    "rings.new_ring(conjugate_invariant)":
        lambda: rings.new_ring(N, CI, rings.CONJUGATE_INVARIANT).psi2,
    "ntt_3n.build_tables": lambda: ntt_3n.build_tables(N3, Q3[:1], [
        primes.find_3n_primitive_root(Q3[0], 3 * N3)[0]]).wr,
    "rlwe.new_parameters_3n": lambda: rlwe.new_parameters_3n(
        rlwe.Parameters3NLiteral(order2=4, order3=1, q=tuple(Q3))).ring_q.moduli,
    "matrix_ckks.new_parameters": lambda: matrix_ckks.new_parameters(
        matrix_ckks.example_parameters()[0]).ring_q.moduli,
    "ckks.new_parameters(conjugate_invariant)": lambda: ckks.new_parameters(
        ckks.CKKSParametersLiteral(logn=5, q=tuple(CI), ring_type=rings.CONJUGATE_INVARIANT)
        ).ring_q.moduli,
    "bgv.new_parameters": lambda: bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=5, t=257, q=tuple(Q), p=tuple(P))).ring_t.moduli,
    "bgv.Encoder": lambda: bgv.Encoder(bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=5, t=257, q=tuple(Q), p=tuple(P))))._perm_dev,
    "ring_packing.RingPackingEvaluator": lambda: ring_packing.RingPackingEvaluator(
        torch.Generator().manual_seed(0), lambda ln, device: rlwe.new_parameters(
            rlwe.ParametersLiteral(logn=ln, q=tuple(Q), p=tuple(P)), device),
        4, 5).x_pow2[5][0],
    "rgsw.sample_rgsw": lambda: rgsw.sample_rgsw(_gen(), _params()).g0[0].a_q,
    "blindrot.init_test_polynomial": lambda: blindrot.init_test_polynomial(
        abs, 1.0, _params(), -1, 1),
    "blindrot.sample_evaluation_key": lambda: blindrot.sample_evaluation_key(
        _gen(), _params(), _lwe_params()).brks[0].g1[0].e,
    "blindrot.Evaluator":
        lambda: blindrot.Evaluator(_params(), _lwe_params()).params_br.ring_q.moduli,
    "protocols.sample_crp_qp": lambda: protocols.sample_crp_qp(_gen(), _params()).p,
    "protocols.sample_crp_q": lambda: protocols.sample_crp_q(_gen(), _params(), 0),
    "protocols.RelinKeyGen.sample_round1": lambda: protocols.RelinKeyGen.sample_round1(
        _gen(), _params()).u,
    "threshold.Thresholdizer.sample_shamir_polynomial":
        lambda: threshold.Thresholdizer.sample_shamir_polynomial(_gen(), _params(), 2)[0].q,
    "threshold.Combiner": lambda: (lambda p: threshold.Combiner(p, 1, [1, 2], 2).gen_additive_share(
        [1, 2], _share(p)))(_params()).value.q,
    "mpckks.set_coefficients_bigint": lambda: (lambda p: mpckks.set_coefficients_bigint(
        p, 0, [1, -2], rlwe.MetaData()))(_params()),
    "mpbgv.EncToShare.sample_share": lambda: (lambda p: mpbgv.EncToShare.sample_share(
        _gen(), p, rlwe.Ciphertext(value=(p.ring_q.moduli[None, :1],) * 2)).mask_t)(
        bgv.new_parameters(bgv.BGVParametersLiteral(logn=5, t=257, q=tuple(Q), p=tuple(P)))),
    "serialization.load": lambda: serialization.load(serialization.save(K.SecretKey(
        value=_share(rlwe.new_parameters(rlwe.ParametersLiteral(logn=5, q=tuple(Q), p=tuple(P)),
                                         "cpu"))))).value.q,
    "flagship.build_flagship": lambda: flagship.build_flagship(logn=5, num_q=2)[4].value[0],
    "examples.ckks_template.main": lambda: ckks_template.main()["words"]["template"],
    "ntt_sharded.build_tables": lambda: ntt_sharded.build_tables(N, Q).a_mat,
    "api.make_mesh": _mesh,
    "launch.run (the rank's device)": lambda: SimpleNamespace(
        device=launch.run(api.rank_device, 1)[0]),
    "mesh.sample_collective_pk_over_mesh": lambda: mpm.sample_collective_pk_over_mesh(
        _params(), 2, _gen())[0].secret,
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    build = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()

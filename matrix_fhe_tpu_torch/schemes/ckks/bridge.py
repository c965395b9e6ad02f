"""Domain switcher: standard CKKS <-> conjugate-invariant CKKS.

Counterpart of ``matrix_fhe_tpu/schemes/ckks/bridge.py`` (the reference's
schemes/ckks/bridge.go and ring/conjugate_invariant.go): the standard ring
Z[X]/(X^N+1) (complex vectors, N/2 slots) and the conjugate-invariant ring
Z[X+X^-1] of degree N/2 (real vectors, N/2 slots) exchange ciphertexts
through a key switch to the "folded" key and an NTT-domain fold or unfold:

  * complex_to_real: ct_std -> ct_ci with ct_ci = fold(ks(ct_std)),
    fold(p)[j] = p[j] + p[conj_idx[j]] for j < N/2; the output scale doubles;
  * real_to_complex: unfold (mirror the N/2 CI NTT slots into conjugate
    pairs), then key-switch to the standard key.

The keys come from ``gen_ring_swap_keys_ci`` (keygenerator.go:207-228
GenEvaluationKeysForRingSwapNew), split as every generator of the port is
into ``sample_ring_swap_keys_ci`` (a ``torch.Generator``'s draws) and
``ring_swap_keys_ci_from_samples``.  The fold's gather index is built once
per (N, NthRoot, device), on the ring's device.
"""

from __future__ import annotations

import functools

import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.params import Parameters


@functools.lru_cache(maxsize=None)
def _fold_index(n: int, nth_root: int, device: torch.device) -> torch.Tensor:
    """The NTT permutation of the conjugation X -> X^{2N-1} on the standard
    ring, as an int64 tensor on ``device``."""
    idx = am.automorphism_ntt_index(n, nth_root, nth_root - 1)
    return torch.from_numpy(idx.astype("int64")).to(device)


def _fold_idx(params_std: Parameters) -> torch.Tensor:
    """NTT permutation of the conjugation X -> X^{2N-1} on the std ring."""
    return _fold_index(params_std.n, params_std.nth_root, params_std.device)


def fold_std_to_ci(params_std: Parameters, rq_std, p: torch.Tensor) -> torch.Tensor:
    """FoldStandardToConjugateInvariant (ring/conjugate_invariant.go:27-45):
    NTT domain, [., L, N] -> [., L, N/2]."""
    half = params_std.n // 2
    return rq_std.add(p[..., :half], p[..., _fold_idx(params_std)[:half]])


def unfold_ci_to_std(params_std: Parameters, p: torch.Tensor) -> torch.Tensor:
    """UnfoldConjugateInvariantToStandard (:7-23): NTT domain,
    [., L, N/2] -> [., L, N] (mirror the conjugate pairs)."""
    return torch.cat([p, torch.flip(p, (-1,))], dim=-1)


def _mapped_secret(params_std: Parameters, sk_ci: K.SecretKey) -> K.SecretKey:
    """The CI secret unfolded into the standard ring, lifted into P by its
    small centered coefficients (ringqp ExtendBasisSmallNormAndCenter)."""
    rq, rp = params_std.ring_q, params_std.ring_p
    mapped_q = unfold_ci_to_std(params_std, sk_ci.value.q)
    mapped_p = None
    if rp is not None:
        small = rq.intt(rq.imform(mapped_q))
        lifted = K.extend_basis_small_norm(params_std.q[0], rp.moduli, small[0])
        mapped_p = rp.mform(rp.ntt(lifted))
    return K.SecretKey(value=K.QPPoly(q=mapped_q, p=mapped_p))


def sample_ring_swap_keys_ci(gen: torch.Generator, params_std: Parameters
                             ) -> tuple[list[K.ZeroSample], list[K.ZeroSample]]:
    """The draws of both keys over the standard ring: std_to_ci's, then
    ci_to_std's."""
    return (K.sample_evaluation_key(gen, params_std),
            K.sample_evaluation_key(gen, params_std))


def ring_swap_keys_ci_from_samples(params_std: Parameters, sk_std: K.SecretKey,
                                   sk_ci: K.SecretKey, samples
                                   ) -> tuple[K.EvaluationKey, K.EvaluationKey]:
    """(std_to_ci, ci_to_std) evaluation keys, both in the standard ring
    (keygenerator.go:207-228)."""
    sk_mapped = _mapped_secret(params_std, sk_ci)
    s2c, c2s = samples
    std_to_ci = K.evaluation_key_from_samples(params_std, sk_std.value.q, sk_mapped, s2c)
    ci_to_std = K.evaluation_key_from_samples(params_std, sk_mapped.value.q, sk_std, c2s)
    return std_to_ci, ci_to_std


def gen_ring_swap_keys_ci(gen: torch.Generator, params_std: Parameters,
                          sk_std: K.SecretKey, sk_ci: K.SecretKey
                          ) -> tuple[K.EvaluationKey, K.EvaluationKey]:
    return ring_swap_keys_ci_from_samples(params_std, sk_std, sk_ci,
                                          sample_ring_swap_keys_ci(gen, params_std))


def complex_to_real(params_std: Parameters, ct: Ciphertext,
                    std_to_ci: K.EvaluationKey) -> Ciphertext:
    """bridge.go:57-90: the CI-ring ciphertext (half degree), with doubled
    scale (real part extraction)."""
    level = ct.level
    rq = params_std.ring_q.at_level(level)
    d0, d1 = rlwe_eval.gadget_product(params_std, level, ct.value[1], std_to_ci.gadget)
    d0 = rq.add(d0, ct.value[0])
    out0 = fold_std_to_ci(params_std, rq, d0)
    out1 = fold_std_to_ci(params_std, rq, d1)
    return ct.with_value((out0, out1)).with_metadata(scale=ct.scale * 2)


def real_to_complex(params_std: Parameters, ct: Ciphertext,
                    ci_to_std: K.EvaluationKey) -> Ciphertext:
    """bridge.go:92-130: CI-ring ciphertext -> standard ring."""
    level = ct.level
    rq = params_std.ring_q.at_level(level)
    c0 = unfold_ci_to_std(params_std, ct.value[0])
    c1 = unfold_ci_to_std(params_std, ct.value[1])
    d0, d1 = rlwe_eval.gadget_product(params_std, level, c1, ci_to_std.gadget)
    return ct.with_value((rq.add(c0, d0), d1))

"""Ring-degree switching: re-encrypt ciphertexts between ring degrees n <-> N.

Counterpart of ``matrix_fhe_tpu/rlwe/ring_switch.py`` (the reference's
core/rlwe/evaluator_evaluationkey.go:37-125, ApplyEvaluationKey with
NIn != NOut; ring/operations.go MapSmallDimensionToLargerDimensionNTT; and
keygenerator.go:208-256, evaluation keys across degrees):

  * up (n -> N): map Y = X^{N/n} -> X (NTT slots replicated N/n times),
    then key-switch from the embedded small key to the large key;
  * down (N -> n): key-switch from the large key to the embedded small key,
    then keep every (N/n)-th coefficient.

Both parameter sets must share the same moduli chain.  The key generator is
split as every generator of the port is: ``sample_ring_swap_keys`` draws
from a ``torch.Generator``, ``ring_swap_keys_from_samples`` computes the
keys from the draws, ``gen_ring_swap_keys`` composes the two.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.params import Parameters


def map_small_to_large_ntt(gap: int, p: torch.Tensor) -> torch.Tensor:
    """MapSmallDimensionToLargerDimensionNTT (ring/operations.go:380-392):
    NTT slot i of the small ring covers slots [i*gap, (i+1)*gap) of the
    large ring (Y = X^gap -> X)."""
    return torch.repeat_interleave(p, gap, dim=-1)


def map_large_to_small_coeff(gap: int, p: torch.Tensor) -> torch.Tensor:
    """Coefficient-domain X -> Y = X^gap: keep every gap-th coefficient
    (SwitchCiphertextRingDegree semantics for NIn > NOut), contiguous for
    the small ring's NTT."""
    return p[..., ::gap].contiguous()


def embed_secret_key(params_small: Parameters, params_large: Parameters,
                     sk_small: K.SecretKey) -> K.SecretKey:
    """Embed the degree-n secret into the degree-N ring (NTT + MForm
    domains replicate; keygenerator.go:240-256)."""
    gap = params_large.n // params_small.n
    q = map_small_to_large_ntt(gap, sk_small.value.q)
    p = None if sk_small.value.p is None else map_small_to_large_ntt(gap, sk_small.value.p)
    return K.SecretKey(value=K.QPPoly(q=q, p=p))


def _check_chains(params_small: Parameters, params_large: Parameters) -> None:
    if list(params_small.q) != list(params_large.q) or \
            list(params_small.p) != list(params_large.p):
        raise ValueError("ring swap requires identical moduli chains")


def sample_ring_swap_keys(gen: torch.Generator, params_large: Parameters
                          ) -> tuple[list[K.ZeroSample], list[K.ZeroSample]]:
    """The draws of both keys, each over the large ring: up's, then down's."""
    return (K.sample_evaluation_key(gen, params_large),
            K.sample_evaluation_key(gen, params_large))


def ring_swap_keys_from_samples(params_small: Parameters, params_large: Parameters,
                                sk_small: K.SecretKey, sk_large: K.SecretKey,
                                samples) -> tuple[K.EvaluationKey, K.EvaluationKey]:
    """(evk_up, evk_down): n -> N and N -> n re-encryption keys, both in the
    large ring (keygenerator.go GenEvaluationKeyNew across degrees)."""
    _check_chains(params_small, params_large)
    sk_emb = embed_secret_key(params_small, params_large, sk_small)
    up, down = samples
    evk_up = K.evaluation_key_from_samples(params_large, sk_emb.value.q, sk_large, up)
    evk_down = K.evaluation_key_from_samples(params_large, sk_large.value.q, sk_emb, down)
    return evk_up, evk_down


def gen_ring_swap_keys(gen: torch.Generator, params_small: Parameters,
                       params_large: Parameters, sk_small: K.SecretKey,
                       sk_large: K.SecretKey) -> tuple[K.EvaluationKey, K.EvaluationKey]:
    _check_chains(params_small, params_large)
    return ring_swap_keys_from_samples(params_small, params_large, sk_small, sk_large,
                                       sample_ring_swap_keys(gen, params_large))


def switch_up(params_small: Parameters, params_large: Parameters,
              ct: Ciphertext, evk_up: K.EvaluationKey) -> Ciphertext:
    """n -> N (NTT-domain degree-1 ciphertext)."""
    gap = params_large.n // params_small.n
    lifted = ct.with_value(tuple(map_small_to_large_ntt(gap, v) for v in ct.value))
    return rlwe_eval.apply_evaluation_key(params_large, lifted, evk_up)


def switch_down(params_large: Parameters, params_small: Parameters,
                ct: Ciphertext, evk_down: K.EvaluationKey) -> Ciphertext:
    """N -> n (NTT-domain degree-1 ciphertext)."""
    gap = params_large.n // params_small.n
    switched = rlwe_eval.apply_evaluation_key(params_large, ct, evk_down)
    rq_l = params_large.ring_q.at_level(ct.level)
    rq_s = params_small.ring_q.at_level(ct.level)
    return ct.with_value(tuple(rq_s.ntt(map_large_to_small_coeff(gap, rq_l.intt(v)))
                               for v in switched.value))

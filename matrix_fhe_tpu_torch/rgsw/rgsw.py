"""RGSW: gadget-ciphertext pairs and the RLWE x RGSW external product.

Counterpart of ``matrix_fhe_tpu/rgsw/rgsw.py`` (the reference's
core/rgsw/: elements.go, encryptor.go, evaluator.go):

  * RGSW(m) = (GadgetEnc(m) on component 0, GadgetEnc(m) on component 1),
    rows [(-a s + P w m + e, a), (-b s + e, b + P w m)]
    (evaluator.go:85-87);
  * ExternalProduct(ct, RGSW(m)) ~= m * ct: decompose both parts of ct,
    the inner product with the two gadget ciphertexts, ModDown
    (evaluator.go:42-257, the multiple-P path).

Encryption is split as the keys are (``rlwe/keys.py``): ``sample_rgsw``
draws one zero-encryption sample a gadget row of each of the two gadget
ciphertexts, ``encrypt_from_samples`` makes the ciphertext from them.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.params import Parameters


@dataclasses.dataclass(frozen=True)
class RGSWCiphertext:
    """elements.go:12-34: two gadget ciphertexts (m and m*s)."""
    g0: K.GadgetCiphertext
    g1: K.GadgetCiphertext


@dataclasses.dataclass(frozen=True)
class RGSWSample:
    """The draws of one RGSW encryption: a zero-encryption sample over
    (Q, P) a gadget row, for g0 and for g1."""
    g0: list[K.ZeroSample]
    g1: list[K.ZeroSample]


def _num_rows(params: Parameters, evk_params: K.EvaluationKeyParameters | None) -> int:
    if evk_params is not None and evk_params.base_two_decomposition > 0:
        return sum(K.base_two_counts(params.q, evk_params.base_two_decomposition))
    alpha = max(len(params.p), 1)
    return -(-len(params.q) // alpha)


def sample_rgsw(gen: torch.Generator, params: Parameters,
                evk_params: K.EvaluationKeyParameters | None = None) -> RGSWSample:
    rows = _num_rows(params, evk_params)
    g0 = [K.sample_zero_qp(gen, params) for _ in range(rows)]
    return RGSWSample(g0=g0, g1=[K.sample_zero_qp(gen, params) for _ in range(rows)])


def _zero_gadget(params: Parameters, sk: K.SecretKey, samples: list[K.ZeroSample],
                 base_two: int) -> K.GadgetCiphertext:
    """A zero gadget ciphertext [rows, 2, L, N] over (Q, P), a row a sample."""
    zeros = [K.encrypt_zero_qp(params, sk, s) for s in samples]
    gq = torch.stack([torch.stack([c0.q, c1.q]) for c0, c1 in zeros])
    gp = None
    if params.ring_p is not None:
        gp = torch.stack([torch.stack([c0.p, c1.p]) for c0, c1 in zeros])
    return K.GadgetCiphertext(q=gq, p=gp, base_two=base_two)


def _add_pt_times_gadget(params: Parameters, pt_q: torch.Tensor, gct: K.GadgetCiphertext,
                         component: int) -> K.GadgetCiphertext:
    """AddPolyTimesGadgetVectorToGadgetCiphertext (gadgetciphertext.go:172)
    on ``component``; pt_q in NTT + MForm."""
    rq = params.ring_q
    big_p = params.big_p()
    L = len(params.q)
    q = rq.moduli[:, None]
    rows = []
    if gct.base_two > 0:
        # (limb i)-major x base-2^B digit j rows: P 2^{jB} pt on limb i only,
        # by the scalar MForm(P 2^{jB} mod q_i) there and 0 elsewhere
        counts = K.base_two_counts(params.q, gct.base_two)
        r = 0
        for i, qi in enumerate(params.q):
            for j in range(counts[i]):
                sc = [0] * L
                sc[i] = (((big_p << (j * gct.base_two)) % qi) << 64) % qi
                row = [gct.q[r, 0], gct.q[r, 1]]
                row[component] = mm.cred(row[component] + rq.mul_scalar_montgomery(pt_q, sc), q)
                rows.append(torch.stack(row))
                r += 1
        return K.GadgetCiphertext(q=torch.stack(rows), p=gct.p, base_two=gct.base_two)
    scaled = rq.mul_scalar_montgomery(pt_q, [(big_p << 64) % qi for qi in params.q])
    alpha = max(len(params.p), 1)
    for i in range(gct.num_digits):
        mask = torch.zeros((L, 1), dtype=torch.int64, device=rq.device)
        mask[i * alpha: min((i + 1) * alpha, L)] = 1
        row = [gct.q[i, 0], gct.q[i, 1]]
        row[component] = mm.cred(row[component] + scaled * mask, q)
        rows.append(torch.stack(row))
    return K.GadgetCiphertext(q=torch.stack(rows), p=gct.p)


def encrypt_from_samples(params: Parameters, sk: K.SecretKey, pt_q: torch.Tensor,
                         samples: RGSWSample,
                         evk_params: K.EvaluationKeyParameters | None = None
                         ) -> RGSWCiphertext:
    """RGSW encryption of pt (NTT + MForm mod Q) under sk
    (encryptor.go:25-72); ``evk_params`` selects the base-2^B gadget."""
    rows = _num_rows(params, evk_params)
    if len(samples.g0) != rows or len(samples.g1) != rows:
        raise ValueError(f"{len(samples.g0)} + {len(samples.g1)} samples for 2 x {rows} "
                         "gadget rows")
    b2 = 0 if evk_params is None else evk_params.base_two_decomposition
    g0 = _add_pt_times_gadget(params, pt_q, _zero_gadget(params, sk, samples.g0, b2), 0)
    g1 = _add_pt_times_gadget(params, pt_q, _zero_gadget(params, sk, samples.g1, b2), 1)
    return RGSWCiphertext(g0=g0, g1=g1)


def encrypt(gen: torch.Generator, params: Parameters, sk: K.SecretKey, pt_q: torch.Tensor,
            evk_params: K.EvaluationKeyParameters | None = None) -> RGSWCiphertext:
    return encrypt_from_samples(params, sk, pt_q, sample_rgsw(gen, params, evk_params),
                                evk_params)


def constant_plaintext(params: Parameters, value: int) -> torch.Tensor:
    """The constant ``value`` mod Q in NTT + MForm (NewGadgetPlaintext's
    scalar path)."""
    rq = params.ring_q
    pt = torch.zeros((len(params.q), params.n), dtype=torch.int64, device=rq.device)
    pt[:, 0] = torch.tensor([value % q for q in params.q], dtype=torch.int64)
    return rq.mform(rq.ntt(pt))


def encrypt_plaintext_from_samples(params: Parameters, sk: K.SecretKey, value: int,
                                   samples: RGSWSample,
                                   evk_params: K.EvaluationKeyParameters | None = None
                                   ) -> RGSWCiphertext:
    return encrypt_from_samples(params, sk, constant_plaintext(params, value), samples,
                                evk_params)


def encrypt_plaintext(gen: torch.Generator, params: Parameters, sk: K.SecretKey, value: int,
                      evk_params: K.EvaluationKeyParameters | None = None) -> RGSWCiphertext:
    """RGSW of the constant ``value``."""
    return encrypt(gen, params, sk, constant_plaintext(params, value), evk_params)


def external_product(params: Parameters, ct: Ciphertext, rgsw: RGSWCiphertext) -> Ciphertext:
    """opOut = [<decomp(ct), rgsw.g0>, <decomp(ct), rgsw.g1>]
    (evaluator.go:188-257, the multiple-P path, then ModDown)."""
    level = ct.level
    rq = params.ring_q.at_level(level)
    if rgsw.g0.base_two > 0:
        d0 = rlwe_eval.decompose_ntt_base2(params, level, ct.value[0], rgsw.g0.base_two,
                                           rgsw.g0.level_p)
        d1 = rlwe_eval.decompose_ntt_base2(params, level, ct.value[1], rgsw.g1.base_two,
                                           rgsw.g1.level_p)
    else:
        d0 = rlwe_eval.decompose_ntt(params, level, ct.value[0])
        d1 = rlwe_eval.decompose_ntt(params, level, ct.value[1])
    a0 = rlwe_eval.gadget_product_hoisted_lazy(params, level, d0, rgsw.g0)
    a1 = rlwe_eval.gadget_product_hoisted_lazy(params, level, d1, rgsw.g1)
    rp = None if rgsw.g0.p is None else params.ring_p.at_level(rgsw.g0.level_p)
    out = [rq.add(a0[0], a1[0]), rq.add(a0[1], a1[1]),
           None if rp is None else rp.add(a0[2], a1[2]),
           None if rp is None else rp.add(a0[3], a1[3])]
    c0 = rlwe_eval.mod_down_qp(params, level, out[0], out[2])
    c1 = rlwe_eval.mod_down_qp(params, level, out[1], out[3])
    return ct.with_value((c0, c1))

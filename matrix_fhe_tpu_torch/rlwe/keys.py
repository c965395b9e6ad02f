"""Keys and key generation.

Counterpart of ``matrix_fhe_tpu/rlwe/keys.py`` (the reference's
core/rlwe/keys.go and keygenerator.go):

  * SecretKey: ternary/Gaussian secret in NTT + Montgomery form over (Q, P)
    (keygenerator.go:61-73);
  * PublicKey: (b, a) = (-a s + e, a), NTT + Montgomery (keygenerator.go:82);
  * EvaluationKey skIn -> skOut: gadget ciphertext with rows
    evk[i] = (-a_i s_out + w_i P skIn + e_i, a_i), w_i selecting RNS digit i
    (gadgetciphertext.go:169-242), or, with ``base_two_decomposition`` > 0,
    rows (limb i, base-2^B digit j) encrypting P' 2^{jB} skIn on limb i
    (gadgetciphertext.go:172-249);
  * RelinearizationKey: evk for skIn = s^2 (keygenerator.go:116-120);
  * GaloisKey: evk for skIn = s(X^{galEl}) (keygenerator.go:140-174).

Every generator comes in two parts: ``sample_*`` draws the random arrays
from a ``torch.Generator``, and ``*_from_sample(s)`` computes the key from
them, deterministically.  ``gen_*`` composes the two.  The tests hand the
deterministic part the arrays that the JAX package sampled, and get the JAX
package's keys back bit for bit: the arrays are the same, the random streams
are not (``ops/samplers.py``).

Keys are stored as in the JAX package (NTT + Montgomery form); a gadget
ciphertext is dense, q-part [rows, 2, LQ, N] and p-part [rows, 2, LP, N].

The deterministic part of an evaluation key on the default gadget runs
through ``_EVK_GRAPH_CACHE``, the counterpart of the JAX package's
``_EVK_JIT_CACHE``: on the card one CUDA graph a parameter set and input
signature (``utils/graphs.py``).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.utils import graphs


@dataclasses.dataclass(frozen=True)
class QPPoly:
    """A polynomial over the extended basis (Q, P) (ring/ringqp/poly.go:17)."""
    q: torch.Tensor          # [LQ, N]
    p: torch.Tensor | None   # [LP, N], or None when P is empty


@dataclasses.dataclass(frozen=True)
class SecretKey:
    value: QPPoly  # NTT + Montgomery form


@dataclasses.dataclass(frozen=True)
class PublicKey:
    value: tuple[QPPoly, QPPoly]  # (b, a), NTT + Montgomery form


@dataclasses.dataclass(frozen=True)
class GadgetCiphertext:
    """core/rlwe/gadgetciphertext.go:19, rows first: q [rows, 2, LQ, N],
    p [rows, 2, LP, N] (NTT + Montgomery form).  ``base_two`` > 0 is the
    single-P bit-decomposition gadget (keys.go:298): rows (RNS limb i)-major
    x (base-2^B digit j), j < ceil(log2 q_i / B), and at most one P prime."""
    q: torch.Tensor
    p: torch.Tensor | None
    base_two: int = 0

    @property
    def num_digits(self) -> int:
        return int(self.q.shape[0])

    @property
    def level_p(self) -> int:
        return -1 if self.p is None else int(self.p.shape[-2]) - 1


@dataclasses.dataclass(frozen=True)
class EvaluationKeyParameters:
    """core/rlwe/keys.go:293-298: per-key auxiliary level and base-2^B
    decomposition (> 0 only with level_p <= 0, params.go:615-633)."""
    level_p: int | None = None           # -1 = no auxiliary primes
    base_two_decomposition: int = 0


@dataclasses.dataclass(frozen=True)
class EvaluationKey:
    gadget: GadgetCiphertext


@dataclasses.dataclass(frozen=True)
class GaloisKey:
    gadget: GadgetCiphertext
    gal_el: int


@dataclasses.dataclass(frozen=True)
class RelinearizationKey:
    gadget: GadgetCiphertext


@dataclasses.dataclass(frozen=True)
class ZeroSample:
    """The random part of one zero encryption over (Q, P): the uniform mask
    a (NTT domain, the ciphertext's c1) and the error e (coefficient domain,
    the same small values on every limb)."""
    a_q: torch.Tensor          # [LQ, N]
    a_p: torch.Tensor | None   # [LP, N]
    e: torch.Tensor            # [LQ, N]


def base_two_counts(moduli, base_two: int) -> list[int]:
    """BaseTwoDecompositionVectorSize (params.go:615-633): digits per limb."""
    return [(int(q).bit_length() + base_two - 1) // base_two for q in moduli]


def _key_params_view(params: Parameters, level_p: int) -> Parameters:
    """Parameters with the auxiliary basis cut to P[:level_p+1] (level_p = -1
    drops P): the key's (Q, P') basis."""
    if level_p == params.max_level_p:
        return params
    return Parameters(n=params.n, nth_root=params.nth_root, q=params.q,
                      p=params.p[: level_p + 1], xe=params.xe, xs=params.xs,
                      ring_type=params.ring_type, ntt_flag=params.ntt_flag,
                      default_scale=params.default_scale, device=params.device)


# ---------------------------------------------------------------------------
# Small-norm basis extension (ringqp ExtendBasisSmallNormAndCenter).
# ---------------------------------------------------------------------------

def extend_basis_small_norm(src_q0: int, dst_moduli: torch.Tensor,
                            coeffs_q0: torch.Tensor) -> torch.Tensor:
    """coeffs_q0 [N]: a small centered polynomial mod q0; returns [LDst, N],
    its value mod each destination modulus (sign-extended)."""
    neg = coeffs_q0 > (src_q0 >> 1)
    mag = torch.where(neg, src_q0 - coeffs_q0, coeffs_q0)
    dst = dst_moduli[:, None]
    return torch.where(neg[None, :], dst - mag[None, :], mag[None, :])


def _to_qp_small(params: Parameters, small: torch.Tensor) -> QPPoly:
    """A small centered coefficient-domain poly [LQ, N] (consistent limbs)
    lifted to (Q, P), NTT + MForm on both parts."""
    rq, rp = params.ring_q, params.ring_p
    pq = rq.mform(rq.ntt(small))
    pp = None
    if rp is not None:
        pp = rp.mform(rp.ntt(extend_basis_small_norm(params.q[0], rp.moduli, small[0])))
    return QPPoly(q=pq, p=pp)


# ---------------------------------------------------------------------------
# Secret and public keys.
# ---------------------------------------------------------------------------

def sample_secret(gen: torch.Generator, params: Parameters) -> torch.Tensor:
    """The secret's coefficients [LQ, N], drawn from Xs."""
    return smp.sample(gen, params.ring_q, params.xs)


def secret_key_from_sample(params: Parameters, small: torch.Tensor) -> SecretKey:
    """keygenerator.go:61-73: extend to P, NTT + MForm."""
    return SecretKey(value=_to_qp_small(params, small))


def gen_secret_key(gen: torch.Generator, params: Parameters) -> SecretKey:
    return secret_key_from_sample(params, sample_secret(gen, params))


def sample_zero_qp(gen: torch.Generator, params: Parameters) -> ZeroSample:
    """a uniform over Q then P, then e from Xe."""
    rp = params.ring_p
    a_q = smp.uniform_poly(gen, params.ring_q)
    a_p = None if rp is None else smp.uniform_poly(gen, rp)
    return ZeroSample(a_q=a_q, a_p=a_p, e=smp.sample(gen, params.ring_q, params.xe))


def encrypt_zero_qp(params: Parameters, sk: SecretKey, s: ZeroSample
                    ) -> tuple[QPPoly, QPPoly]:
    """(b, a) = (-a s + e, a) over (Q, P), NTT + Montgomery
    (core/rlwe/encryptor.go:429-460 encryptZeroSkFromC1QP)."""
    rq, rp = params.ring_q, params.ring_p
    c0q = rq.sub(rq.mform(rq.ntt(s.e)), rq.mul_coeffs_montgomery(s.a_q, sk.value.q))
    c0p = None
    if rp is not None:
        ep = extend_basis_small_norm(params.q[0], rp.moduli, s.e[0])
        c0p = rp.sub(rp.mform(rp.ntt(ep)), rp.mul_coeffs_montgomery(s.a_p, sk.value.p))
    return QPPoly(q=c0q, p=c0p), QPPoly(q=s.a_q, p=s.a_p)


def public_key_from_sample(params: Parameters, sk: SecretKey, s: ZeroSample) -> PublicKey:
    return PublicKey(value=encrypt_zero_qp(params, sk, s))


def gen_public_key(gen: torch.Generator, params: Parameters, sk: SecretKey) -> PublicKey:
    return public_key_from_sample(params, sk, sample_zero_qp(gen, params))


# ---------------------------------------------------------------------------
# Evaluation keys (keygenerator.go:276-316).
# ---------------------------------------------------------------------------

def _key_basis(params: Parameters, evk_params: EvaluationKeyParameters | None
               ) -> tuple[Parameters, int]:
    """(the key's parameters view, its base-2^B width or 0)."""
    if evk_params is None:
        return params, 0
    lp = params.max_level_p if evk_params.level_p is None else evk_params.level_p
    b2 = evk_params.base_two_decomposition
    if b2 > 0 and lp > 0:
        raise ValueError("base-2^B decomposition requires level_p <= 0 "
                         "(core/rlwe/params.go:615-633)")
    return _key_params_view(params, lp), b2


def _num_rows(kp: Parameters, b2: int) -> int:
    if b2 > 0:
        return sum(base_two_counts(kp.q, b2))
    return -(-len(kp.q) // max(len(kp.p), 1))


def sample_evaluation_key(gen: torch.Generator, params: Parameters,
                          evk_params: EvaluationKeyParameters | None = None
                          ) -> list[ZeroSample]:
    """One zero-encryption sample a gadget row, over the key's basis."""
    kp, b2 = _key_basis(params, evk_params)
    return [sample_zero_qp(gen, kp) for _ in range(_num_rows(kp, b2))]


# One graph a parameter set: every relinearization, Galois and evaluation key
# of a parameter set has the same shapes, so the key's deterministic part is
# one replay.  Keyed as the JAX package's _EVK_JIT_CACHE
# (matrix_fhe_tpu/rlwe/keys.py:232-241), the distributions included; a
# bounded LRU whose evicted entries free their graphs.
_EVK_GRAPH_CACHE: collections.OrderedDict = collections.OrderedDict()
_EVK_GRAPH_CACHE_MAX = 32


def evaluation_key_from_samples(params: Parameters, sk_in_q: torch.Tensor,
                                sk_out: SecretKey, samples: list[ZeroSample],
                                evk_params: EvaluationKeyParameters | None = None
                                ) -> EvaluationKey:
    """genEvaluationKey: gadget rows are zero encryptions under sk_out plus
    P * skIn * the row's selector.  sk_in_q: [LQ, N] the input key mod Q,
    NTT + Montgomery form.  The default gadget runs through the graph cache;
    the base-two gadget and another P level run eagerly, as the JAX
    package's early return does (matrix_fhe_tpu/rlwe/keys.py:283-304)."""
    kp, b2 = _key_basis(params, evk_params)
    if len(samples) != _num_rows(kp, b2):
        raise ValueError(f"{len(samples)} samples for {_num_rows(kp, b2)} gadget rows")
    if kp is not params or b2 > 0:
        if kp is not params:
            lp = kp.max_level_p
            sk_out = SecretKey(value=QPPoly(
                q=sk_out.value.q, p=None if lp < 0 else sk_out.value.p[: lp + 1]))
        gq, gp = gadget_rows(kp, sk_in_q, sk_out, samples, b2)
        return EvaluationKey(gadget=GadgetCiphertext(q=gq, p=gp, base_two=b2))
    ck = (params.n, tuple(params.q), tuple(params.p or ()), params.ring_type, params.xe,
          params.xs)
    fn = graphs.cached(_EVK_GRAPH_CACHE, _EVK_GRAPH_CACHE_MAX, ck, "evaluation key",
                       lambda s_in, so_q, so_p, zs: gadget_rows(
                           params, s_in, SecretKey(value=QPPoly(q=so_q, p=so_p)),
                           [ZeroSample(a_q=a_q, a_p=a_p, e=e) for a_q, a_p, e in zs], 0),
                       params.device)
    gq, gp = fn(sk_in_q, sk_out.value.q, sk_out.value.p,
                [(s.a_q, s.a_p, s.e) for s in samples])
    return EvaluationKey(gadget=GadgetCiphertext(q=gq, p=gp))


def gadget_rows(kp: Parameters, sk_in_q: torch.Tensor, sk_out: SecretKey,
                samples: list[ZeroSample], b2: int) -> tuple:
    """The gadget's (q, p) arrays over the key's basis ``kp`` (p None
    without auxiliary primes): the body of the evaluation key's graph."""
    rq = kp.ring_q
    big_p = kp.big_p()
    LQ = len(kp.q)
    zeros = [encrypt_zero_qp(kp, sk_out, s) for s in samples]
    if b2 > 0:
        # row (i, j): MForm(P' 2^{jB}) on limb i only
        scalars = []
        for i, qi in enumerate(kp.q):
            for j in range(base_two_counts(kp.q, b2)[i]):
                sc = [0] * LQ
                sc[i] = (((big_p << (j * b2)) % qi) << 64) % qi
                scalars.append(sc)
        rows0 = [mm.cred(c0.q + rq.mul_scalar_montgomery(sk_in_q, sc), rq.moduli[:, None])
                 for (c0, _), sc in zip(zeros, scalars)]
    else:
        # AddPolyTimesGadgetVectorToGadgetCiphertext (gadgetciphertext.go:169):
        # P * skIn on the limbs of digit i, row i, component 0
        scaled = rq.mul_scalar_montgomery(sk_in_q, [(big_p << 64) % q for q in kp.q])
        alpha = max(len(kp.p), 1)
        rows0 = []
        for i, (c0, _) in enumerate(zeros):
            mask = torch.zeros((LQ, 1), dtype=torch.int64, device=rq.device)
            mask[i * alpha: min((i + 1) * alpha, LQ)] = 1
            rows0.append(mm.cred(c0.q + scaled * mask, rq.moduli[:, None]))
    gq = torch.stack([torch.stack([r0, c1.q]) for r0, (_, c1) in zip(rows0, zeros)])
    gp = None
    if kp.ring_p is not None:
        gp = torch.stack([torch.stack([c0.p, c1.p]) for c0, c1 in zeros])
    return gq, gp


def gen_evaluation_key(gen: torch.Generator, params: Parameters, sk_in_q: torch.Tensor,
                       sk_out: SecretKey,
                       evk_params: EvaluationKeyParameters | None = None) -> EvaluationKey:
    return evaluation_key_from_samples(
        params, sk_in_q, sk_out, sample_evaluation_key(gen, params, evk_params), evk_params)


def relinearization_key_from_samples(params: Parameters, sk: SecretKey,
                                     samples: list[ZeroSample],
                                     evk_params: EvaluationKeyParameters | None = None
                                     ) -> RelinearizationKey:
    """keygenerator.go:116-120: evk for s^2 -> s."""
    sk2 = params.ring_q.mul_coeffs_montgomery(sk.value.q, sk.value.q)  # MForm(s^2)
    evk = evaluation_key_from_samples(params, sk2, sk, samples, evk_params)
    return RelinearizationKey(gadget=evk.gadget)


def gen_relinearization_key(gen: torch.Generator, params: Parameters, sk: SecretKey,
                            evk_params: EvaluationKeyParameters | None = None
                            ) -> RelinearizationKey:
    return relinearization_key_from_samples(
        params, sk, sample_evaluation_key(gen, params, evk_params), evk_params)


def galois_key_from_samples(params: Parameters, sk: SecretKey, gal_el: int,
                            samples: list[ZeroSample],
                            evk_params: EvaluationKeyParameters | None = None
                            ) -> GaloisKey:
    """keygenerator.go:139-174: the gadget re-encrypts from sk to
    pi_{k^-1}(sk); the evaluator then applies pi_k to the result
    (evaluator_automorphism.go:45-52)."""
    idx = am.ntt_index(params.ring_type, params.n, params.nth_root,
                       params.mod_inv_galois_element(gal_el))
    iidx = torch.from_numpy(idx.astype("int64")).to(params.device)
    sk_out = SecretKey(value=QPPoly(
        q=sk.value.q[..., iidx],
        p=None if sk.value.p is None else sk.value.p[..., iidx]))
    evk = evaluation_key_from_samples(params, sk.value.q, sk_out, samples, evk_params)
    return GaloisKey(gadget=evk.gadget, gal_el=gal_el)


def gen_galois_key(gen: torch.Generator, params: Parameters, sk: SecretKey, gal_el: int,
                   evk_params: EvaluationKeyParameters | None = None) -> GaloisKey:
    return galois_key_from_samples(
        params, sk, gal_el, sample_evaluation_key(gen, params, evk_params), evk_params)


def gen_galois_keys(gen: torch.Generator, params: Parameters, sk: SecretKey,
                    gal_els) -> dict[int, GaloisKey]:
    return {g: gen_galois_key(gen, params, sk, g) for g in gal_els}

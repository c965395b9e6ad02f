"""Matrix-CKKS over the 3N ring.

Counterpart of ``matrix_fhe_tpu/schemes/matrix_ckks/scheme.py`` (the
reference's schemes/matrix_ckks):

  * Encoder (encoder.go:163-351): coefficient-domain fixed-point encoding,
    the real parts scaled and rounded into the N coefficients, no canonical
    embedding; decode is the INTT if needed, the centered CRT and / scale;
  * Evaluator (evaluator.go): add (:58), mul = NTT, the pointwise tensor up
    to degree 2, INTT (:114-192, with the Montgomery-form switch the
    reference omits), rescale by the last modulus (:208-243), mul_const
    (:322-378), drop_level (:259-311); and, beyond the reference, mul_relin
    and automorphism over the generic RLWE key switching, whose gadget
    machinery is ring-agnostic;
  * the example parameter sets (example_parameters.go:10-49).

Every NTT of a 3N ring with a factorized split runs kernel B5 on the card
(``ops/ntt3n_cuda.py``).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch import rlwe
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData, Plaintext
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered


@dataclasses.dataclass(frozen=True)
class MatrixCKKSParametersLiteral:
    order2: int
    order3: int
    logq: tuple[int, ...] | None = None
    logp: tuple[int, ...] | None = None
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    log_default_scale: int = 40
    xe: object = rlwe.params.DEFAULT_XE
    xs: object = rlwe.params.DEFAULT_XS


def new_parameters(lit: MatrixCKKSParametersLiteral, device="cuda") -> rlwe.Parameters:
    """The 3N ring's RLWE parameters of ``lit``, with ``log_default_scale``,
    the rings on ``device`` (the card unless told otherwise)."""
    p = rlwe.new_parameters_3n(rlwe.Parameters3NLiteral(
        order2=lit.order2, order3=lit.order3, q=lit.q, p=lit.p,
        logq=lit.logq, logp=lit.logp, xe=lit.xe, xs=lit.xs), device)
    p.log_default_scale = lit.log_default_scale
    return p


def example_parameters() -> list[MatrixCKKSParametersLiteral]:
    """schemes/matrix_ckks/example_parameters.go:10-49 (N = 24, 48, 96)."""
    return [
        MatrixCKKSParametersLiteral(order2=3, order3=1, logq=(30, 30), logp=(40,),
                                    log_default_scale=20,
                                    xe=smp.Ternary(h=1), xs=smp.Ternary(h=1)),
        MatrixCKKSParametersLiteral(order2=4, order3=1, logq=(50, 40, 40), logp=(60,),
                                    log_default_scale=40,
                                    xe=smp.Ternary(h=32), xs=smp.Ternary(h=32)),
        MatrixCKKSParametersLiteral(order2=5, order3=1, logq=(40, 30, 30, 30), logp=(40,),
                                    log_default_scale=10,
                                    xe=smp.Ternary(h=8), xs=smp.Ternary(h=8)),
    ]


class Encoder:
    def __init__(self, params: rlwe.Parameters):
        self.params = params

    def encode(self, values, level: int | None = None, scale=None) -> Plaintext:
        """The real parts of ``values`` (at most N) times ``scale`` (2^logScale
        by default), rounded, as a coefficient-domain plaintext."""
        params = self.params
        level = params.max_level if level is None else level
        scale = Fraction(1 << params.log_default_scale) if scale is None else Fraction(scale)
        vals = np.zeros(params.n, dtype=np.float64)
        arr = np.asarray(values)
        vals[: len(arr)] = np.real(arr).astype(np.float64)
        sf = float(scale)
        coeffs = [round(v * sf) for v in vals]
        limbs = np.array([[c % q for c in coeffs] for q in params.q[: level + 1]],
                         dtype=np.int64)
        return Plaintext(value=torch.from_numpy(limbs).to(params.device),
                         metadata=MetaData(scale=scale, is_ntt=False))

    def decode(self, pt: Plaintext) -> np.ndarray:
        params = self.params
        v = pt.value
        if pt.metadata.is_ntt:
            v = params.ring_q.at_level(pt.level).intt(v)
        coeffs = crt_reconstruct_centered(v.cpu().numpy(), params.q[: pt.level + 1])
        sf = float(pt.metadata.scale)
        return np.array([float(c) / sf for c in coeffs])


class Evaluator:
    def __init__(self, params: rlwe.Parameters):
        self.params = params

    def _ring(self, level):
        return self.params.ring_q.at_level(level)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        level = min(a.level, b.level)
        ring = self._ring(level)
        d = max(a.degree, b.degree)
        va = [v[..., : level + 1, :] for v in a.value] + [None] * (d - a.degree)
        vb = [v[..., : level + 1, :] for v in b.value] + [None] * (d - b.degree)
        out = tuple(x if y is None else (y if x is None else ring.add(x, y))
                    for x, y in zip(va, vb))
        return a.with_value(out)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        level = min(a.level, b.level)
        ring = self._ring(level)
        vb = tuple(ring.neg(v[..., : level + 1, :]) for v in b.value)
        return self.add(a, b.with_value(vb))

    def mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """The degree-(da + db) tensor product, in and out in a's domain
        (evaluator.go:114-192)."""
        level = min(a.level, b.level)
        ring = self._ring(level)
        if a.degree + b.degree > 2:
            raise ValueError("matrix_ckks mul supports total degree <= 2")

        def ntt(ct):
            vs = [v[..., : level + 1, :] for v in ct.value]
            return vs if ct.metadata.is_ntt else [ring.ntt(v) for v in vs]

        va, vb = [ring.mform(v) for v in ntt(a)], ntt(b)
        out = [None] * (a.degree + b.degree + 1)
        for i, x in enumerate(va):
            for j, y in enumerate(vb):
                p = ring.mul_coeffs_montgomery(x, y)
                out[i + j] = p if out[i + j] is None else ring.add(out[i + j], p)
        if not a.metadata.is_ntt:
            out = [ring.intt(v) for v in out]
        return Ciphertext(value=tuple(out), metadata=a.metadata).with_metadata(
            scale=a.scale * b.scale)

    def mul_const(self, a: Ciphertext, c: float) -> Ciphertext:
        """MulByConst, a per-limb scalar at the default scale
        (evaluator.go:322-378)."""
        scale = Fraction(1 << self.params.log_default_scale)
        ci = round(float(c) * float(scale))
        ring = self._ring(a.level)
        sc = [(ci % q) * (1 << 64) % q for q in ring.moduli_tuple]
        out = tuple(ring.mul_scalar_montgomery(v, sc) for v in a.value)
        return a.with_value(out).with_metadata(scale=a.scale * scale)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by the last modulus, rounded (DivRoundByLastModulusManyNTT
        or its coefficient-domain form, evaluator.go:208-243)."""
        ring = self._ring(a.level)
        div = rt.div_round_by_last_modulus_ntt if a.metadata.is_ntt else \
            rt.div_round_by_last_modulus
        return a.with_value(tuple(div(ring, v) for v in a.value)).with_metadata(
            scale=a.scale / Fraction(self.params.q[a.level]))

    def drop_level(self, a: Ciphertext, n: int = 1) -> Ciphertext:
        level = a.level - n
        return a.with_value(tuple(v[..., : level + 1, :] for v in a.value))

    def _to_ntt(self, a: Ciphertext) -> Ciphertext:
        if a.metadata.is_ntt:
            return a
        ring = self._ring(a.level)
        return a.with_value(tuple(ring.ntt(v) for v in a.value)).with_metadata(is_ntt=True)

    def _from_ntt(self, a: Ciphertext, want_ntt: bool) -> Ciphertext:
        if a.metadata.is_ntt == want_ntt:
            return a
        ring = self._ring(a.level)
        return a.with_value(tuple(ring.intt(v) for v in a.value)).with_metadata(is_ntt=False)

    def mul_relin(self, a: Ciphertext, b: Ciphertext, rlk) -> Ciphertext:
        """mul, then relinearization by the generic RLWE key switching."""
        ct = self._to_ntt(self.mul(a, b))
        out = rlwe_eval.relinearize(self.params, ct, rlk)
        return self._from_ntt(out, a.metadata.is_ntt)

    def automorphism(self, a: Ciphertext, gk) -> Ciphertext:
        """X -> X^galEl for galEl coprime to 3N: a permutation of the
        totative evaluation points in the NTT domain."""
        ct = self._to_ntt(a)
        out = rlwe_eval.automorphism(self.params, ct, gk)
        return self._from_ntt(out, a.metadata.is_ntt)

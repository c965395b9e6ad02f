"""t-out-of-N threshold secret sharing over R_QP (Shamir).

Counterpart of ``matrix_fhe_tpu/multiparty/threshold.py`` (the reference's
multiparty/threshold.go, eprint 2022/780):

  * ``Thresholdizer``: a secret Shamir polynomial with R_QP coefficients
    (its constant term the party's additive secret share), evaluated at each
    recipient's public point (:21-115); its random coefficients are drawn by
    ``sample_shamir_polynomial`` and assembled by
    ``shamir_polynomial_from_samples``;
  * ``Combiner``: Lagrange recombination into a t-out-of-t additive share,
    sk_add = share * prod_{j != i} x_j / (x_j - x_i) (:118-180).

Public points are nonzero integers; the scalar arithmetic is exact, in
Python integers a limb, on the host.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.params import Parameters


def _moduli(params: Parameters) -> list[int]:
    return list(params.q) + list(params.p)


def _limb_constants(params: Parameters, field: str) -> torch.Tensor:
    """[LQ + LP, 1] of a ring table field over (Q, P)."""
    parts = [getattr(params.ring_q, field)]
    if params.ring_p is not None:
        parts.append(getattr(params.ring_p, field))
    return torch.cat(parts)[:, None]


def _qp_concat(poly: K.QPPoly) -> torch.Tensor:
    return poly.q if poly.p is None else torch.cat([poly.q, poly.p], dim=-2)


def _qp_split(params: Parameters, arr: torch.Tensor) -> K.QPPoly:
    if not params.p:
        return K.QPPoly(q=arr, p=None)
    lq = len(params.q)
    return K.QPPoly(q=arr[..., :lq, :], p=arr[..., lq:, :])


class Thresholdizer:
    @staticmethod
    def sample_shamir_polynomial(gen: torch.Generator, params: Parameters, threshold: int
                                 ) -> list[K.QPPoly]:
        """The threshold - 1 uniform (Q, P) coefficients above the constant."""
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        return [K.QPPoly(q=smp.uniform_poly(gen, params.ring_q),
                         p=None if params.ring_p is None else smp.uniform_poly(gen, params.ring_p))
                for _ in range(threshold - 1)]

    @staticmethod
    def shamir_polynomial_from_samples(params: Parameters, secret: K.SecretKey,
                                       coeffs: list[K.QPPoly]) -> list[K.QPPoly]:
        """threshold.go:82-96: degree threshold - 1, constant term the secret."""
        return [secret.value] + [K.QPPoly(q=c.q.to(params.device),
                                          p=None if c.p is None else c.p.to(params.device))
                                 for c in coeffs]

    @staticmethod
    def gen_shamir_polynomial(gen: torch.Generator, params: Parameters, threshold: int,
                              secret: K.SecretKey) -> list[K.QPPoly]:
        return Thresholdizer.shamir_polynomial_from_samples(
            params, secret, Thresholdizer.sample_shamir_polynomial(gen, params, threshold))

    @staticmethod
    def gen_shamir_secret_share(params: Parameters, recipient: int,
                                shamir_poly: list[K.QPPoly]) -> K.QPPoly:
        """Horner evaluation at the public point (EvalPolyScalar)."""
        moduli = _moduli(params)
        xs = torch.tensor([recipient % q for q in moduli], dtype=torch.int64,
                          device=params.device)[:, None]
        q = _limb_constants(params, "moduli")
        bhi, blo = _limb_constants(params, "bhi"), _limb_constants(params, "blo")
        arrs = [_qp_concat(c) for c in shamir_poly]
        acc = arrs[-1]
        for c in reversed(arrs[:-1]):
            acc = mm.cred(mm.bred(acc, xs, q, bhi, blo) + c, q)
        return _qp_split(params, acc)

    @staticmethod
    def aggregate(params: Parameters, s1: K.QPPoly, s2: K.QPPoly) -> K.QPPoly:
        rq, rp = params.ring_q, params.ring_p
        return K.QPPoly(q=rq.add(s1.q, s2.q), p=None if s1.p is None else rp.add(s1.p, s2.p))


class Combiner:
    """threshold.go:118-180."""

    def __init__(self, params: Parameters, own: int, others: list[int], threshold: int):
        self.params = params
        self.threshold = threshold
        self.own = own
        self.moduli = _moduli(params)
        # lagrangeCoeff(own, that) = that / (that - own) a limb
        self._lagrange = {that: [that * pow((that - own) % q, q - 2, q) % q
                                 for q in self.moduli]
                          for that in others if that != own}

    def gen_additive_share(self, actives: list[int], own_share: K.QPPoly) -> K.SecretKey:
        if len(actives) < self.threshold:
            raise ValueError("not enough active players")
        prod = [1] * len(self.moduli)
        for active in actives[: self.threshold]:
            if active != self.own:
                lc = self._lagrange[active]
                prod = [p * c % q for p, c, q in zip(prod, lc, self.moduli)]
        # the (NTT + MForm) share times the scalar in MForm: a Montgomery
        # product keeps the domain
        params = self.params
        sc = torch.tensor([(p << 64) % q for p, q in zip(prod, self.moduli)],
                          dtype=torch.int64, device=params.device)[:, None]
        out = mm.mred(_qp_concat(own_share), sc, _limb_constants(params, "moduli"),
                      _limb_constants(params, "qinv"))
        return K.SecretKey(value=_qp_split(params, out))

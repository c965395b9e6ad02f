"""Homomorphic inverse: Goldschmidt division + interval normalization.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/inverse.py`` (the reference's
circuits/ckks/inverse/inverse.go):

  * ``goldschmidt_division`` (:200-300): 1/x over [min, 2-min] with
    precision doubling per iteration; iteration count auto-derived from the
    plaintext scale.
  * ``interval_normalization`` (:302-407, eprint 2022/280): iterative
    compression of [-max, max] onto [-1, 1] with an encrypted normalization
    factor y such that x*y is normalized and y recovers the original.
  * ``evaluate_positive/negative/full_domain`` (:45-199): the assembled 1/x
    for x in +-[2^log2min, 2^log2max], full domain via the minimax sign.
"""

from __future__ import annotations

import math

from matrix_fhe_tpu_torch.circuits.ckks import minimax
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext


class Evaluator:
    def __init__(self, minimax_eval: minimax.Evaluator):
        self.mm = minimax_eval
        self.ev = minimax_eval.ev
        self.enc = minimax_eval.enc

    # -- entry points ------------------------------------------------------
    def evaluate_positive_domain(self, ct: Ciphertext, log2min: float,
                                 log2max: float) -> Ciphertext:
        return self._evaluate(ct, log2min, log2max, False, None)

    def evaluate_negative_domain(self, ct: Ciphertext, log2min: float,
                                 log2max: float) -> Ciphertext:
        neg = self.ev.neg(ct)
        return self.ev.neg(self._evaluate(neg, log2min, log2max, False, None))

    def evaluate_full_domain(self, ct: Ciphertext, log2min: float,
                             log2max: float, sign_poly) -> Ciphertext:
        return self._evaluate(ct, log2min, log2max, True, sign_poly)

    # -- pipeline ----------------------------------------------------------
    def _evaluate(self, ct, log2min, log2max, fulldomain, sign_poly):
        ev = self.ev
        norm_fac = None
        if log2max > 0:
            cinv, norm_fac = self.interval_normalization(ct, log2max)
        else:
            cinv = ct

        sign = None
        if fulldomain:
            sign = self.mm.evaluate(cinv, sign_poly)
            sign = self._maybe_btp(sign, 1)
            cinv = self._maybe_btp(cinv, 1)
            cinv = ev.rescale(ev.mul_relin(cinv, sign))  # |x|

        cinv = self.goldschmidt_division(cinv, log2min)

        if norm_fac is not None:
            depth = 1 + (1 if fulldomain else 0)
            cinv = self._maybe_btp(cinv, depth)
            norm_fac = self._maybe_btp(norm_fac, depth)
            cinv = ev.rescale(ev.mul_relin(cinv, norm_fac))
        if fulldomain:
            cinv = ev.rescale(ev.mul_relin(cinv, sign))
        return cinv

    def _maybe_btp(self, ct, depth):
        if ct.level < depth and self.mm.btp is not None:
            return self.mm.btp.bootstrap(ct)
        return ct

    def goldschmidt_division(self, ct: Ciphertext, log2min: float) -> Ciphertext:
        """GoldschmidtDivisionNew (:200-300): a_{i+1} = a_i(1 + b_i),
        b_{i+1} = b_i^2 with a_0 = 2-x, b_0 = 1-x converges to 1/x."""
        ev = self.ev
        params = ev.params
        prec = (params.n / 2) / float(ct.scale)
        start = 1 - math.exp2(log2min)
        iters = 1
        while start >= prec:
            start *= start
            iters += 1
        iters = max(iters, 3)
        if self.mm.btp is None and iters > ct.level:
            raise ValueError(f"goldschmidt: need {iters} levels, have {ct.level}")

        a = ev.neg(ct)
        b = a
        a = ev.add_const(a, 2)
        b = ev.add_const(b, 1)
        for _ in range(1, iters):
            b = self._maybe_btp(b, 2)
            a = self._maybe_btp(a, 2)
            b = ev.rescale(ev.mul_relin(b, b))
            b = self._maybe_btp(b, 2)
            tmp = ev.rescale(ev.mul_relin(a, b))
            a = ev.set_scale(a, tmp.scale)
            a = ev.add(a, tmp)
        return a

    def interval_normalization(self, ct: Ciphertext, log2max: float):
        """IntervalNormalization (:302-407): returns (x_norm, y) with
        x_norm = x * y in [-1, 1]."""
        ev = self.ev
        norm = ct
        norm_fac = None
        L = 2.45
        n = math.ceil(log2max / math.log2(L))
        for i in range(n):
            norm = self._maybe_btp(norm, 4)
            if norm_fac is not None:
                norm_fac = self._maybe_btp(norm_fac, 2)
            c = 2.0 / math.sqrt(27 * L ** (2 * (n - 1 - i)))
            z = ev.rescale(ev.mul_const(norm, c))
            z = ev.rescale(ev.mul_relin(z, z))
            z = ev.neg(z)
            z = ev.add_const(z, 1)
            z = self._maybe_btp(z, 2)
            if norm_fac is None:
                norm_fac = z
            else:
                norm_fac = ev.rescale(ev.mul_relin(norm_fac, z))
            norm = ev.rescale(ev.mul_relin(norm, z))
        return norm, norm_fac

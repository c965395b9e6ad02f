"""Homomorphic comparisons: sign, step, min, max.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/comparison.py`` (the
reference's circuits/ckks/comparison/comparison.go): all
built on a minimax composite sign polynomial (sign in [-1,-2^-a] U [2^-a,1]):

  * sign(x) (:75)
  * step(x) = (sign(x)+1)/2 via a half-scaled last composite (:81-109)
  * max/min via the extremum gate step(d) * d + op1 (:111-206)
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction

from matrix_fhe_tpu_torch.circuits.ckks import minimax
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils import bignum as bn


class Evaluator:
    def __init__(self, minimax_eval: minimax.Evaluator,
                 sign_poly: list[bn.Polynomial]):
        self.mm = minimax_eval
        self.sign_poly = sign_poly

    def sign(self, ct: Ciphertext) -> Ciphertext:
        return self.mm.evaluate(ct, self.sign_poly)

    def step(self, ct: Ciphertext) -> Ciphertext:
        """(sign(x)+1)/2: halve the last composite and add 1/2 (:81-109)."""
        last = self.sign_poly[-1]
        half = bn.Polynomial(
            basis=last.basis,
            coeffs=[None if c is None else (c[0] / 2, c[1] / 2)
                    for c in last.coeffs],
            interval=last.interval, is_odd=False, is_even=False)
        c0 = half.coeffs[0] or (Decimal(0), Decimal(0))
        half.coeffs[0] = (c0[0] + Decimal("0.5"), c0[1])
        return self.mm.evaluate(ct, self.sign_poly[:-1] + [half])

    def max(self, op0: Ciphertext, op1: Ciphertext) -> Ciphertext:
        sd = self._stepdiff(op0, op1)
        return self.mm.ev.add(sd, op1)

    def min(self, op0: Ciphertext, op1: Ciphertext) -> Ciphertext:
        sd = self._stepdiff(op0, op1)
        return self.mm.ev.sub(op0, sd)

    def _stepdiff(self, op0: Ciphertext, op1: Ciphertext) -> Ciphertext:
        """step(op0-op1) * (op0-op1) (:149-206)."""
        ev = self.mm.ev
        params = ev.params
        diff = ev.sub(op0, op1)
        if diff.level < 2 and self.mm.btp is not None:
            diff = self.mm.btp.bootstrap(diff)
        step = self.step(diff)
        if step.level < 1 and self.mm.btp is not None:
            step = self.mm.btp.bootstrap(step)

        # Bring diff to scale ~q[level] (value unchanged) so the product
        # with step lands exactly on the default scale (:178-198).
        level = min(diff.level, step.level)
        diff = ev._drop_level(diff, level)
        ratio = Fraction(params.q[level]) / diff.scale
        diff = ev.rescale(ev.mul_const(diff, float(ratio)))
        diff = diff.with_metadata(scale=diff.scale * ratio)
        return ev.rescale(ev.mul_relin(diff, step))

"""Minimax composite polynomials: sign-function approximation machinery.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/minimax.py`` (the reference's
circuits/ckks/minimax/):

  * ``gen_minimax_composite_polynomial`` (minimax_composite_polynomial.go:126
    GenMinimaxCompositePolynomial): P = pk o ... o p0 approximating f over
    [-1, -2^-alpha] U [2^-alpha, 1], each pi a two-interval Remez minimax,
    successive intervals [1-minErr-e, 1+maxErr+e], interval-normalized.
  * ``Evaluator`` (minimax_composite_polynomial_evaluator.go:29): sequential
    P-S evaluation with imaginary-part cleanup by conjugation, optional
    bootstrapping between compositions.
  * ``COEFFS_SIGN_X2_CHEBY`` / ``COEFFS_SIGN_X4_CHEBY``: the precision
    doubling/quadrupling polynomials 1.5x - 0.5x^3 and (35x - 35x^3 + 21x^5
    - 5x^7)/16 in the Chebyshev basis (eprint 2019/1234).
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction

from matrix_fhe_tpu_torch.circuits import polynomial as poly_circ
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils import bignum as bn

# 1.5x - 0.5x^3 and 35/16 x - 35/16 x^3 + 21/16 x^5 - 5/16 x^7 in the
# Chebyshev basis (x = T1, x^3 = (T3 + 3 T1)/4, ...).
COEFFS_SIGN_X2_CHEBY = [0, 1.125, 0, -0.125]
COEFFS_SIGN_X4_CHEBY = [0, 1.1962890625, 0, -0.2392578125, 0, 0.0478515625,
                        0, -0.0048828125]


def sign_fn(x: Decimal) -> Decimal:
    return Decimal(1) if x > 0 else (Decimal(-1) if x < 0 else Decimal(0))


def composite_from_coeffs(coeff_lists) -> list[bn.Polynomial]:
    """NewPolynomial (minimax_composite_polynomial.go:18): Chebyshev-basis
    coefficients over [-1, 1]."""
    out = []
    for cs in coeff_lists:
        p = bn.Polynomial.from_values(bn.CHEBYSHEV, cs, bn.Interval(-1, 1))
        odd = all(float(c[0]) == 0 and float(c[1]) == 0
                  for i, c in enumerate(p.coeffs) if c is not None and i % 2 == 0)
        even = all(float(c[0]) == 0 and float(c[1]) == 0
                   for i, c in enumerate(p.coeffs) if c is not None and i % 2 == 1)
        p.is_odd, p.is_even = odd, even
        out.append(p)
    return out


def gen_minimax_composite_polynomial(log_alpha: int, log_err: int,
                                     degrees: list[int], f=sign_fn,
                                     digits: int = 40) -> list[bn.Polynomial]:
    """GenMinimaxCompositePolynomial (minimax_composite_polynomial.go:126)."""
    alpha = Decimal(2) ** -log_alpha
    e = Decimal(2) ** -log_err
    polys: list[bn.Polynomial] = []

    nodes0 = 1 + ((degrees[0] + 1) >> 1)
    intervals = [bn.Interval(Decimal(-1) - e, -alpha, nodes0),
                 bn.Interval(alpha, Decimal(1) + e, nodes0)]

    r = bn.Remez(bn.RemezParameters(function=f, basis=bn.CHEBYSHEV,
                                    intervals=intervals, digits=digits,
                                    scan_points=128,
                                    global_interval=(Decimal(-1), Decimal(1))))
    poly = r.approximate(max_iter=50, threshold=float(alpha))

    for i in range(1, len(degrees)):
        max_itv = 1 + r.max_err + e
        min_itv = 1 - r.min_err - e
        # normalize the previous polynomial so outputs land in [-1, 1]
        inv = Decimal(1) / max_itv
        poly.coeffs = [None if c is None else (c[0] * inv, c[1] * inv)
                       for c in poly.coeffs]
        polys.append(poly)

        min_n = min_itv / max_itv
        nodes = 1 + ((degrees[i] + 1) >> 1)
        intervals = [bn.Interval(Decimal(-1) - e, -min_n, nodes),
                     bn.Interval(min_n, Decimal(1) + e, nodes)]
        r = bn.Remez(bn.RemezParameters(function=f, basis=bn.CHEBYSHEV,
                                        intervals=intervals, digits=digits,
                                        scan_points=128,
                                        global_interval=(Decimal(-1), Decimal(1))))
        poly = r.approximate(max_iter=50, threshold=float(alpha))

    polys.append(poly)
    for p in polys:
        p.interval = bn.Interval(-1, 1)
        p.is_odd, p.is_even = True, False
        for j in range(0, len(p.coeffs), 2):
            p.coeffs[j] = None
    return polys


class Evaluator:
    """minimax_composite_polynomial_evaluator.go:14-100."""

    def __init__(self, ev, enc, bootstrapper=None):
        self.ev = ev
        self.enc = enc
        self.btp = bootstrapper

    def min_input_level(self) -> int:
        return 0

    def evaluate(self, ct: Ciphertext, mcp: list[bn.Polynomial]) -> Ciphertext:
        params = self.ev.params
        res = ct
        for poly in mcp:
            if res.level < poly.depth and self.btp is not None:
                res = self.btp.bootstrap(res)
            if params.ring_type == "standard":
                target = params.default_scale / 2
            else:
                target = params.default_scale
            res = poly_circ.evaluate(self.ev, self.enc, res, poly, target)
            if params.ring_type == "standard":
                # clean the imaginary part: res = (res + conj(res))
                res = res.with_metadata(scale=res.scale * 2)
                res = self.ev.add(res, self.ev.conjugate(res))
        return res.with_metadata(scale=ct.scale)

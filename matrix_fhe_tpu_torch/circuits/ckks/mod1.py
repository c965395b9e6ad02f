"""Homomorphic x mod 1: scaled sine/cosine approximation + double angle.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/mod1.py`` (the reference's
circuits/ckks/mod1/); host-side parameter generation on ``utils/bignum.py``,
evaluation through any evaluator with the CKKS interface:

  * Parameters (mod1_parameters.go:29-235): a Chebyshev approximation of
    (1/2pi) sin(2 pi x) (SinContinuous) or (1/2pi)^{1/2^r} cos(2 pi (x-1/4)
    / 2^r) (CosContinuous) over [-K/2^r, K/2^r], with parity masking and the
    (1/2pi)^{1/scFac} * qDiff scaling folded into the coefficients; optional
    arcsine correction polynomial Mod1InvPoly (:137-156).
  * Evaluator (mod1_evaluator.go:31-160): optional -0.25 offset, Chebyshev
    evaluation at a target scale budgeted for the double-angle iterations
    (each squaring consumes a level: cos(2x) = 2cos(x)^2 - 1), then the
    arcsine correction.

CosDiscrete (the Han-Ki utils/cosine special approximation) is expressed via
the generic multi-interval Remez over the union of windows around the
integers (same minimax semantics, bignum.Remez engine).
"""

from __future__ import annotations

import dataclasses
import math
from decimal import Decimal, localcontext
from fractions import Fraction

from matrix_fhe_tpu_torch.circuits import polynomial as poly_circ
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils import bignum as bn

SIN_CONTINUOUS = "sin_continuous"
COS_CONTINUOUS = "cos_continuous"
COS_DISCRETE = "cos_discrete"

_INV_2PI = 0.15915494309189535


@dataclasses.dataclass
class ParametersLiteral:
    """mod1_parameters.go:29-43."""
    level_q: int
    log_scale: int
    mod1_type: str = COS_CONTINUOUS
    scaling: float = 0.0
    log_message_ratio: int = 8
    k: int = 16
    mod1_degree: int = 30
    double_angle: int = 3
    mod1_inv_degree: int = 0

    def depth(self) -> int:
        """mod1_parameters.go:58-76."""
        if self.mod1_type == COS_DISCRETE:
            d = max(self.mod1_degree, 2 * self.k - 1).bit_length()
        else:
            d = self.mod1_degree.bit_length()
        if self.mod1_type != SIN_CONTINUOUS:
            d += self.double_angle
        d += self.mod1_inv_degree.bit_length()
        return d


@dataclasses.dataclass
class Parameters:
    level_q: int
    log_default_scale: int
    mod1_type: str
    log_message_ratio: int
    double_angle: int
    q_diff: float
    sqrt_2pi: float
    mod1_poly: bn.Polynomial
    mod1_inv_poly: bn.Polynomial | None
    k: float

    @property
    def interval_shrink_factor(self) -> float:
        return float(1 << self.double_angle)

    @property
    def scaling_factor(self) -> Fraction:
        return Fraction(1 << self.log_default_scale)

    @property
    def message_ratio(self) -> float:
        return float(1 << self.log_message_ratio)


def new_parameters_from_literal(params, lit: ParametersLiteral) -> Parameters:
    """NewParametersFromLiteral (mod1_parameters.go:115-235)."""
    double_angle = 0 if lit.mod1_type == SIN_CONTINUOUS else lit.double_angle
    sc_fac = float(1 << double_angle)
    K = lit.k / sc_fac

    q0 = params.q[0]
    q_diff = q0 / math.exp2(round(math.log2(q0)))
    scaling = lit.scaling or 1.0

    mod1_inv_poly = None
    if lit.mod1_inv_degree > 0:
        sqrt_2pi = 1.0
        coeffs = [0j] * (lit.mod1_inv_degree + 1)
        coeffs[1] = _INV_2PI * q_diff * scaling
        for i in range(3, lit.mod1_inv_degree + 1, 2):
            coeffs[i] = coeffs[i - 2] * (i * i - 4 * i + 4) / (i * i - i)
        mod1_inv_poly = bn.Polynomial.from_values(bn.MONOMIAL, coeffs)
        mod1_inv_poly.is_even = False
        for i in range(0, len(mod1_inv_poly.coeffs), 2):
            mod1_inv_poly.coeffs[i] = None
    else:
        sqrt_2pi = (_INV_2PI * q_diff * scaling) ** (1.0 / sc_fac)

    two_pi = 2 * bn.pi(bn.DEFAULT_DIGITS)

    if lit.mod1_type == SIN_CONTINUOUS:
        itv = bn.Interval(Decimal(-K), Decimal(K), lit.mod1_degree)
        poly = bn.chebyshev_approximation(
            lambda x: bn.sin(x * two_pi), itv)
        poly.is_even = False
        for i in range(0, len(poly.coeffs), 2):
            poly.coeffs[i] = None
    elif lit.mod1_type == COS_CONTINUOUS:
        itv = bn.Interval(Decimal(-K), Decimal(K), lit.mod1_degree)
        poly = bn.chebyshev_approximation(
            lambda x: bn.cos(x * two_pi), itv)
        poly.is_odd = False
        for i in range(1, len(poly.coeffs), 2):
            poly.coeffs[i] = None
    elif lit.mod1_type == COS_DISCRETE:
        # Minimax over the union of windows around the integers in [-K, K]
        # (cosine.ApproximateCos semantics, Han-Ki; via the generic Remez).
        poly = _approximate_cos_discrete(lit.k, lit.mod1_degree,
                                         float(1 << lit.log_message_ratio),
                                         double_angle)
        poly.is_odd = False
        for i in range(1, len(poly.coeffs), 2):
            poly.coeffs[i] = None
    else:
        raise ValueError(f"invalid mod1 type {lit.mod1_type!r}")

    s = Decimal(sqrt_2pi)
    for i, c in enumerate(poly.coeffs):
        if c is not None:
            poly.coeffs[i] = (c[0] * s, c[1] * s)

    return Parameters(level_q=lit.level_q, log_default_scale=lit.log_scale,
                      mod1_type=lit.mod1_type,
                      log_message_ratio=lit.log_message_ratio,
                      double_angle=double_angle, q_diff=q_diff,
                      sqrt_2pi=sqrt_2pi, mod1_poly=poly,
                      mod1_inv_poly=mod1_inv_poly, k=float(lit.k))


def _approximate_cos_discrete(k: int, degree: int, message_ratio: float,
                              double_angle: int) -> bn.Polynomial:
    """CosDiscrete (utils/cosine ApproximateCos, Han-Ki semantics): the same
    target function cos(2 pi t) as CosContinuous, but fit only over the
    windows where the (already offset-shifted) variable actually lives:
    t in [(i - 0.25 - eps), (i - 0.25 + eps)]/2^r for integers i in
    [-(k-1), k-1], eps = 1/message_ratio.  The Chebyshev basis interval is
    kept at the symmetric [-K', K'] so the evaluator's normalization is
    unchanged."""
    r = 1 << double_angle
    Kp = k / r
    eps = 1.0 / message_ratio
    two_pi = 2 * bn.pi(bn.DEFAULT_DIGITS)

    num_itv = 2 * k - 1
    intervals = []
    for i in range(-(k - 1), k):
        a = Decimal(i - 0.25 - eps) / r
        b = Decimal(i - 0.25 + eps) / r
        intervals.append(bn.Interval(a, b, 1))
    # distribute degree+1 nodes round-robin
    total = num_itv
    i = 0
    while total < degree + 1:
        intervals[i % num_itv].nodes += 1
        total += 1
        i += 1

    rp = bn.RemezParameters(
        function=lambda x: bn.cos(x * two_pi),
        basis=bn.CHEBYSHEV, intervals=intervals, scan_points=32,
        global_interval=(Decimal(-Kp), Decimal(Kp)))
    remez = bn.Remez(rp)
    return remez.approximate(max_iter=30, threshold=1e-3)


def galois_elements(params) -> list[int]:
    return []


class Evaluator:
    """mod1_evaluator.go:15-160."""

    def __init__(self, ev, enc, mod1_params: Parameters):
        self.ev = ev
        self.enc = enc
        self.p = mod1_params

    def evaluate(self, ct: Ciphertext) -> Ciphertext:
        return self.evaluate_and_scale(ct, 1.0)

    def evaluate_and_scale(self, ct: Ciphertext, scaling: complex) -> Ciphertext:
        """EvaluateAndScaleNew (mod1_evaluator.go:31-148)."""
        evm = self.p
        ev = self.ev
        if ct.level < evm.level_q:
            raise ValueError("ct.level < mod1 level_q")
        if ct.level > evm.level_q:
            ct = ct.with_value(tuple(v[..., :evm.level_q + 1, :] for v in ct.value))

        orig_scale = ct.scale
        res = ct.with_metadata(scale=evm.scaling_factor)

        # target scale before the double-angle iterations
        q = ev.params.q
        target = evm.scaling_factor
        depth = evm.mod1_poly.depth
        for i in range(evm.double_angle):
            target = _sqrt_fraction(
                target * Fraction(q[ct.level - depth - evm.double_angle + i + 1]))

        # -0.25 offset folded through the change of variable
        if evm.mod1_type in (COS_CONTINUOUS, COS_DISCRETE):
            a, b = evm.mod1_poly.interval.a, evm.mod1_poly.interval.b
            offset = -0.5 / (evm.interval_shrink_factor * float(b - a))
            res = ev.add_const(res, offset)

        sqrt2pi = complex(evm.sqrt_2pi, 0)
        if evm.mod1_inv_poly is None and scaling != 1:
            sc = complex(scaling) ** (1.0 / evm.interval_shrink_factor)
            poly = bn.Polynomial(
                basis=evm.mod1_poly.basis,
                coeffs=[None if c is None else
                        (c[0] * Decimal(sc.real) - c[1] * Decimal(sc.imag),
                         c[0] * Decimal(sc.imag) + c[1] * Decimal(sc.real))
                        for c in evm.mod1_poly.coeffs],
                interval=evm.mod1_poly.interval,
                is_odd=evm.mod1_poly.is_odd, is_even=evm.mod1_poly.is_even)
            sqrt2pi *= sc
        else:
            poly = evm.mod1_poly

        res = poly_circ.evaluate(ev, self.enc, res, poly, target)

        # double angle: cos(2x) = 2 cos(x)^2 - 1 (scaled by sqrt2pi each round)
        for _ in range(evm.double_angle):
            sqrt2pi *= sqrt2pi
            res = ev.mul_relin(res, res)
            res = ev.add(res, res)
            res = ev.add_const(res, -sqrt2pi)
            res = ev.rescale(res)

        if evm.mod1_inv_poly is not None:
            inv = evm.mod1_inv_poly
            if scaling != 1:
                sc = complex(scaling)
                inv = bn.Polynomial(
                    basis=inv.basis,
                    coeffs=[None if c is None else
                            (c[0] * Decimal(sc.real) - c[1] * Decimal(sc.imag),
                             c[0] * Decimal(sc.imag) + c[1] * Decimal(sc.real))
                            for c in inv.coeffs],
                    interval=inv.interval, is_odd=inv.is_odd, is_even=inv.is_even)
            res = poly_circ.evaluate(ev, self.enc, res, inv, res.scale)

        # multiply back by q: reinterpret at the input scale
        return res.with_metadata(scale=orig_scale)


def _sqrt_fraction(f: Fraction) -> Fraction:
    with localcontext() as ctx:
        ctx.prec = 60
        s = (Decimal(f.numerator) / Decimal(f.denominator)).sqrt()
    return Fraction(s)

"""Arbitrary-precision host tooling: big-float scalars, polynomials,
Chebyshev interpolation and multi-interval Remez minimax approximation.

A copy of ``matrix_fhe_tpu/utils/bignum.py`` (the reference's utils/bignum:
float.go, polynomial.go, chebyshev_approximation.go,
minimax_approximation.go), on Python's ``decimal`` module at ~50 digits
(~166 bits).  Pure Python: it runs on the host at parameter-generation time
(the encoder's arbitrary-precision embedding, the mod1 and polynomial
circuits) and touches no tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from decimal import Decimal, getcontext, localcontext

DEFAULT_DIGITS = 50


# ---------------------------------------------------------------------------
# Decimal transcendentals (argument-reduced Taylor series).
# ---------------------------------------------------------------------------

def _atan_inv(n: int, digits: int) -> Decimal:
    """arctan(1/n) by Taylor series at ``digits`` precision."""
    with localcontext() as ctx:
        ctx.prec = digits + 10
        one_over_n = Decimal(1) / n
        term = one_over_n
        acc = term
        n2 = one_over_n * one_over_n
        k = 1
        while abs(term) > Decimal(10) ** (-(digits + 5)):
            term *= -n2
            acc += term / (2 * k + 1)
            k += 1
    return +acc


@functools.lru_cache(maxsize=None)
def _machin(digits: int) -> Decimal:
    """pi at ``digits`` + 10 digits by Machin's formula, computed once per
    precision (``cos`` and ``sin`` call ``pi`` at every argument)."""
    with localcontext() as ctx:
        ctx.prec = digits + 10
        return 16 * _atan_inv(5, digits + 10) - 4 * _atan_inv(239, digits + 10)


def pi(digits: int = DEFAULT_DIGITS) -> Decimal:
    """Machin's formula: pi = 16 atan(1/5) - 4 atan(1/239), rounded to the
    caller's context."""
    return +_machin(digits)


def cos(x: Decimal, digits: int | None = None) -> Decimal:
    digits = digits or getcontext().prec
    with localcontext() as ctx:
        ctx.prec = digits + 10
        two_pi = 2 * pi(ctx.prec)
        x = Decimal(x) % two_pi
        if x > pi(ctx.prec):
            x -= two_pi
        # Taylor: sum (-1)^k x^{2k} / (2k)!
        x2 = x * x
        term = Decimal(1)
        acc = Decimal(1)
        k = 0
        while True:
            k += 1
            term *= -x2 / ((2 * k - 1) * (2 * k))
            acc += term
            if abs(term) < Decimal(10) ** (-(digits + 5)):
                break
    return +acc


def sin(x: Decimal, digits: int | None = None) -> Decimal:
    digits = digits or getcontext().prec
    with localcontext() as ctx:
        ctx.prec = digits + 10
        half_pi = pi(ctx.prec) / 2
        y = cos(Decimal(x) - half_pi, digits)
    return +y


def set_precision(digits: int) -> None:
    getcontext().prec = digits


# ---------------------------------------------------------------------------
# Intervals and polynomials (utils/bignum/polynomial.go).
# ---------------------------------------------------------------------------

MONOMIAL = "monomial"
CHEBYSHEV = "chebyshev"


@dataclasses.dataclass
class Interval:
    a: Decimal
    b: Decimal
    nodes: int = 0

    def __post_init__(self):
        self.a = Decimal(self.a)
        self.b = Decimal(self.b)


def optimal_split(log_degree: int) -> int:
    """OptimalSplit (polynomial.go:14-23): the BSGS split minimizing the
    number of ciphertext multiplications in Paterson-Stockmeyer."""
    log_split = log_degree >> 1
    a = (1 << log_split) + (1 << (log_degree - log_split)) + log_degree - log_split - 3
    b = (1 << (log_split + 1)) + (1 << (log_degree - log_split - 1)) + log_degree - log_split - 4
    if a > b:
        log_split += 1
    return log_split


@dataclasses.dataclass
class Polynomial:
    """polynomial.go:25-118: coefficients (complex, high precision) in a
    monomial or Chebyshev basis over an interval.  ``coeffs[i]`` may be None
    (structurally-zero entry created by factorization)."""
    basis: str
    coeffs: list  # list of (Decimal, Decimal) | None  (real, imag)
    interval: Interval | None = None
    is_odd: bool = True
    is_even: bool = True

    @staticmethod
    def from_values(basis: str, values, interval=None) -> "Polynomial":
        coeffs = []
        for c in values:
            if c is None:
                coeffs.append(None)
            elif isinstance(c, tuple):
                coeffs.append((Decimal(c[0]), Decimal(c[1])))
            elif isinstance(c, complex):
                coeffs.append((Decimal(c.real), Decimal(c.imag)))
            else:
                coeffs.append((Decimal(c), Decimal(0)))
        return Polynomial(basis=basis, coeffs=coeffs, interval=interval)

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    @property
    def depth(self) -> int:
        return max(0, math.ceil(math.log2(max(self.degree, 1))))

    def coeffs_complex(self) -> list:
        return [0j if c is None else complex(float(c[0]), float(c[1]))
                for c in self.coeffs]

    def change_of_basis(self) -> tuple[Decimal, Decimal]:
        """(scalar, constant) mapping x -> scalar*x + constant into [-1, 1]
        (polynomial.go:113-140)."""
        if self.basis == MONOMIAL:
            return Decimal(1), Decimal(0)
        a, b = self.interval.a, self.interval.b
        num = b - a
        return Decimal(2) / num, (-b - a) / num

    def evaluate(self, x) -> complex:
        """Horner (monomial) or Clenshaw-style recurrence (Chebyshev)
        (polynomial.go:173-250); accepts real or complex x, float64 output."""
        if isinstance(x, complex):
            xr, xi = Decimal(x.real), Decimal(x.imag)
        else:
            xr, xi = Decimal(x), Decimal(0)
        cs = [(Decimal(0), Decimal(0)) if c is None else c for c in self.coeffs]

        def cmul(ar, ai, br, bi):
            return ar * br - ai * bi, ar * bi + ai * br

        if self.basis == MONOMIAL:
            yr, yi = cs[-1]
            for cr, ci in reversed(cs[:-1]):
                yr, yi = cmul(yr, yi, xr, xi)
                yr, yi = yr + cr, yi + ci
            return complex(float(yr), float(yi))
        scalar, constant = self.change_of_basis()
        ur, ui = xr * scalar + constant, xi * scalar
        yr, yi = cs[0]
        tp_r, tp_i = Decimal(1), Decimal(0)
        t_r, t_i = ur, ui
        for i in range(1, len(cs)):
            cr, ci = cs[i]
            pr, pi = cmul(cr, ci, t_r, t_i)
            yr, yi = yr + pr, yi + pi
            nr, ni = cmul(2 * ur, 2 * ui, t_r, t_i)
            tp_r, tp_i, t_r, t_i = t_r, t_i, nr - tp_r, ni - tp_i
        return complex(float(yr), float(yi))

    def evaluate_decimal(self, x: Decimal) -> Decimal:
        """Real-part evaluation at full precision (for Remez error scans)."""
        cs = [Decimal(0) if c is None else c[0] for c in self.coeffs]
        if self.basis == MONOMIAL:
            y = cs[-1]
            for c in reversed(cs[:-1]):
                y = y * x + c
            return y
        scalar, constant = self.change_of_basis()
        u = x * scalar + constant
        y = cs[0]
        t_prev, t = Decimal(1), u
        for c in cs[1:]:
            y += c * t
            t_prev, t = t, 2 * u * t - t_prev
        return y

    def factorize(self, n: int):
        """p = X^n (or T_n) * pq + pr (polynomial.go:252-314)."""
        if n < self.degree >> 1:
            raise ValueError("cannot factorize: n < degree/2")
        deg = self.degree
        pr_coeffs = [None if self.coeffs[i] is None else self.coeffs[i]
                     for i in range(n)]
        pq_coeffs = [None] * (deg - n + 1)
        if self.coeffs[n] is not None:
            pq_coeffs[0] = self.coeffs[n]
        odd, even = self.is_odd, self.is_even

        def keep(i):
            return self.coeffs[i] is not None and (
                not (even or odd) or (i % 2 == 0 and even) or (i % 2 == 1 and odd))

        if self.basis == MONOMIAL:
            for i in range(n + 1, deg + 1):
                if keep(i):
                    pq_coeffs[i - n] = self.coeffs[i]
        else:
            # T_i = 2 T_n T_{i-n} - T_{2n-i}: the quotient coefficient is
            # doubled and T_{n-j} of the remainder gets -coeff.
            for i, j in zip(range(n + 1, deg + 1), range(1, deg - n + 1)):
                if keep(i):
                    cr, ci = self.coeffs[i]
                    pq_coeffs[i - n] = (2 * cr, 2 * ci)
                    prev = pr_coeffs[n - j]
                    if prev is not None:
                        pr_coeffs[n - j] = (prev[0] - cr, prev[1] - ci)
                    else:
                        pr_coeffs[n - j] = (-cr, -ci)

        mk = lambda cs: Polynomial(basis=self.basis, coeffs=cs,
                                   interval=self.interval, is_odd=odd,
                                   is_even=even)
        return mk(pq_coeffs), mk(pr_coeffs)


# ---------------------------------------------------------------------------
# Chebyshev interpolation (chebyshev_approximation.go).
# ---------------------------------------------------------------------------

def chebyshev_nodes(n: int, interval: Interval, digits: int = DEFAULT_DIGITS) -> list[Decimal]:
    """chebyshevNodes (:54-80): x + y*cos((k - 1/2) pi / n), ascending."""
    with localcontext() as ctx:
        ctx.prec = digits
        half = Decimal("0.5")
        x = (interval.a + interval.b) * half
        y = (interval.b - interval.a) * half
        pi_over_n = pi(digits) / n
        nodes = [None] * n
        for k in range(1, n + 1):
            u = cos((Decimal(k) - half) * pi_over_n, digits)
            nodes[n - k] = +(x + y * u)
    return nodes


def chebyshev_approximation(f, interval: Interval,
                            digits: int = DEFAULT_DIGITS) -> Polynomial:
    """ChebyshevApproximation (:16-52): interpolation at nodes+1 Chebyshev
    points.  ``f`` maps Decimal -> Decimal (real functions only, which is
    all the circuits use)."""
    with localcontext() as ctx:
        ctx.prec = digits
        n = interval.nodes + 1
        nodes = chebyshev_nodes(n, interval, digits)
        fi = [Decimal(f(x)) for x in nodes]

        minus_ab = -interval.a - interval.b
        b_minus_a = interval.b - interval.a
        coeffs = [Decimal(0)] * n
        for i in range(n):
            u = (2 * nodes[i] + minus_ab) / b_minus_a
            t_prev, t = Decimal(1), u
            for j in range(n):
                coeffs[j] += fi[i] * t_prev
                t_prev, t = t, 2 * u * t - t_prev
        coeffs[0] /= n
        for j in range(1, n):
            coeffs[j] /= Decimal(n) / 2
        out = [(+c, Decimal(0)) for c in coeffs]
    return Polynomial(basis=CHEBYSHEV, coeffs=out, interval=interval)


# ---------------------------------------------------------------------------
# Multi-interval Remez (minimax_approximation.go, Lee et al. eprint 2020/552).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RemezParameters:
    function: object            # Decimal -> Decimal
    basis: str
    intervals: list[Interval]   # per-interval node counts must sum to deg+1
    digits: int = DEFAULT_DIGITS
    scan_points: int = 256      # error-scan density per interval
    # Chebyshev basis interval for the returned polynomial; defaults to the
    # hull of ``intervals``.  Lets callers fit over a union of windows while
    # keeping a fixed symmetric change of variable (the CosDiscrete case).
    global_interval: "tuple | None" = None


class Remez:
    """Iterative minimax approximation over a union of intervals
    (minimax_approximation.go:69-155)."""

    def __init__(self, p: RemezParameters):
        self.p = p
        self.degree = sum(i.nodes for i in p.intervals) - 1
        self.coeffs: list[Decimal] = []
        self.max_err = self.min_err = Decimal(0)
        self._nodes: list[Decimal] = []

    # -- driver -----------------------------------------------------------
    def approximate(self, max_iter: int = 50, threshold: float = 1e-6) -> Polynomial:
        with localcontext() as ctx:
            ctx.prec = self.p.digits
            self._initialize()
            for _ in range(max_iter):
                self._solve()
                extrema = self._find_extreme_points()
                self._choose_new_nodes(extrema)
                if self.min_err > 0 and \
                        float(self.max_err / self.min_err) - 1 < threshold:
                    self._solve()
                    break
            a, b = self._basis_interval()
            out = [(+c, Decimal(0)) for c in self.coeffs]
        return Polynomial(basis=self.p.basis, coeffs=out,
                          interval=Interval(a, b))

    # -- steps ------------------------------------------------------------
    def _initialize(self):
        """Chebyshev nodes per interval, deg+2 total (initialize :171-216)."""
        nodes: list[Decimal] = []
        total = self.degree + 2
        counts = [i.nodes for i in self.p.intervals]
        # distribute the 2 extra points to the widest intervals
        order = sorted(range(len(counts)),
                       key=lambda k: self.p.intervals[k].b - self.p.intervals[k].a,
                       reverse=True)
        for j in range(total - sum(counts)):
            counts[order[j % len(order)]] += 1
        for itv, c in zip(self.p.intervals, counts):
            nodes.extend(chebyshev_nodes(max(c, 1), Interval(itv.a, itv.b),
                                         self.p.digits))
        self._nodes = sorted(nodes)[:total]

    def _cheb_row(self, x: Decimal, a: Decimal, b: Decimal) -> list[Decimal]:
        n = self.degree + 1
        if self.p.basis == MONOMIAL:
            row, acc = [], Decimal(1)
            for _ in range(n):
                row.append(acc)
                acc *= x
            return row
        u = (2 * x - a - b) / (b - a)
        row = [Decimal(1)]
        if n > 1:
            row.append(u)
        for _ in range(2, n):
            row.append(2 * u * row[-1] - row[-2])
        return row

    def _basis_interval(self):
        if self.p.global_interval is not None:
            return Decimal(self.p.global_interval[0]), Decimal(self.p.global_interval[1])
        return (min(i.a for i in self.p.intervals),
                max(i.b for i in self.p.intervals))

    def _solve(self):
        """Solve for coefficients + levelled error E with alternating signs
        at the deg+2 nodes (getCoefficients :218-273)."""
        f = self.p.function
        a, b = self._basis_interval()
        n = self.degree + 2
        mat = []
        vec = []
        for k, x in enumerate(self._nodes):
            row = self._cheb_row(x, a, b)
            row.append(Decimal((-1) ** k))
            mat.append(row)
            vec.append(Decimal(f(x)))
        sol = _solve_linear(mat, vec)
        self.coeffs = sol[:-1]
        self._global_interval = (a, b)

    def _err(self, x: Decimal) -> Decimal:
        a, b = self._global_interval
        poly = Polynomial(basis=self.p.basis,
                          coeffs=[(c, Decimal(0)) for c in self.coeffs],
                          interval=Interval(a, b))
        return Decimal(self.p.function(x)) - poly.evaluate_decimal(x)

    def _find_extreme_points(self):
        """Scan each interval for local extrema of the error (incl.
        endpoints), refine by ternary search (findExtremePoints :274-306)."""
        extrema = []
        for itv in self.p.intervals:
            xs = [itv.a + (itv.b - itv.a) * k / self.p.scan_points
                  for k in range(self.p.scan_points + 1)]
            es = [self._err(x) for x in xs]
            for k in range(len(xs)):
                is_end = k == 0 or k == len(xs) - 1
                if not is_end and not (
                        (es[k] >= es[k - 1] and es[k] >= es[k + 1]) or
                        (es[k] <= es[k - 1] and es[k] <= es[k + 1])):
                    continue
                if is_end:
                    extrema.append((xs[k], es[k]))
                    continue
                lo, hi = xs[k - 1], xs[k + 1]
                sign = 1 if es[k] >= 0 else -1
                x, e = _ternary_search(
                    lambda t: sign * self._err(t), lo, hi, iters=40)
                extrema.append((x, sign * e))
        extrema.sort(key=lambda p: p[0])
        return extrema

    def _choose_new_nodes(self, extrema):
        """Keep deg+2 alternating-sign extrema of maximal magnitude
        (chooseNewNodes :307-497)."""
        # collapse same-sign runs to their max-|e| representative
        pts = []
        for x, e in extrema:
            s = 1 if e >= 0 else -1
            if pts and (1 if pts[-1][1] >= 0 else -1) == s:
                if abs(e) > abs(pts[-1][1]):
                    pts[-1] = (x, e)
            else:
                pts.append((x, e))
        want = self.degree + 2
        # drop smallest-magnitude endpoints/pairs until the count fits
        while len(pts) > want:
            if len(pts) - want == 1:
                # drop the smaller of the two endpoints
                if abs(pts[0][1]) < abs(pts[-1][1]):
                    pts.pop(0)
                else:
                    pts.pop()
            else:
                # remove the adjacent pair with smallest max magnitude
                best, best_v = None, None
                for i in range(len(pts) - 1):
                    v = max(abs(pts[i][1]), abs(pts[i + 1][1]))
                    if best_v is None or v < best_v:
                        best, best_v = i, v
                del pts[best:best + 2]
        if len(pts) >= 2:
            self.max_err = max(abs(e) for _, e in pts)
            self.min_err = min(abs(e) for _, e in pts)
        if len(pts) == want:
            self._nodes = [x for x, _ in pts]
        # else: keep previous nodes (scan missed extrema; next solve reuses)


def _ternary_search(f, lo: Decimal, hi: Decimal, iters: int = 40):
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        if f(m1) < f(m2):
            lo = m1
        else:
            hi = m2
    x = (lo + hi) / 2
    return x, f(x)


def _solve_linear(mat, vec):
    """Gaussian elimination with partial pivoting over Decimal
    (solveLinearSystemInPlace :805-836)."""
    n = len(vec)
    m = [row[:] + [vec[i]] for i, row in enumerate(mat)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(m[r][col]))
        m[col], m[piv] = m[piv], m[col]
        d = m[col][col]
        m[col] = [v / d for v in m[col]]
        for r in range(n):
            if r != col and m[r][col] != 0:
                factor = m[r][col]
                m[r] = [v - factor * w for v, w in zip(m[r], m[col])]
    return [m[i][n] for i in range(n)]


# ---------------------------------------------------------------------------
# Lagrange interpolation (ring/interpolation.go): arbitrary-precision
# polynomial through (x_i, y_i) nodes, returned as monomial coefficients.
# Used by tests to cross-check polynomial evaluators.
# ---------------------------------------------------------------------------

def lagrange_interpolation(xs, ys, digits: int = 50):
    """Interpolator.Interpolate (ring/interpolation.go:40-188): returns the
    unique degree-(n-1) polynomial's monomial coefficients, low to high,
    as Decimals computed at ``digits`` precision."""
    n = len(xs)
    if len(ys) != n:
        raise ValueError("xs/ys length mismatch")
    with localcontext() as ctx:
        ctx.prec = digits + 10
        xs_d = [Decimal(str(x)) for x in xs]
        ys_d = [Decimal(str(y)) for y in ys]
        coeffs = [Decimal(0)] * n
        for i in range(n):
            # basis poly prod_{j!=i} (X - x_j) / (x_i - x_j), expanded
            basis = [Decimal(1)]
            denom = Decimal(1)
            for j in range(n):
                if j == i:
                    continue
                # multiply basis by (X - x_j)
                new = [Decimal(0)] * (len(basis) + 1)
                for k, c in enumerate(basis):
                    new[k + 1] += c
                    new[k] -= c * xs_d[j]
                basis = new
                denom *= xs_d[i] - xs_d[j]
            w = ys_d[i] / denom
            for k, c in enumerate(basis):
                coeffs[k] += w * c
        return coeffs

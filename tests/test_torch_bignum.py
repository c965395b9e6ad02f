"""PyTorch port, ``utils/bignum.py`` (a copy of the JAX package's: pure Python
on ``Decimal``): the ``lagrange_interpolation`` case of tests/test_scalar.py,
and every other function held equal, Decimal for Decimal, to the JAX
package's on the same arguments (the circuits' parameters come from these).
"""

from decimal import Decimal

import pytest

from matrix_fhe_tpu.utils import bignum as jbn
from matrix_fhe_tpu_torch.utils import bignum as tbn


def test_lagrange_interpolation():
    xs = [-2, -1, 0, 1, 2]
    poly = lambda x: 3 - 2 * x + x**3 - x**4  # noqa: E731
    c = tbn.lagrange_interpolation(xs, [poly(x) for x in xs])
    for got, want in zip(c, [3, -2, 0, 1, -1]):
        assert abs(got - Decimal(want)) < Decimal("1e-30"), (got, want)
    ys = [0.5, -1.25, 2.0, 0.125, 3.5, -0.75]
    assert c == jbn.lagrange_interpolation(xs, [poly(x) for x in xs])
    assert tbn.lagrange_interpolation(range(6), ys) == jbn.lagrange_interpolation(range(6), ys)


@pytest.mark.parametrize("x", ["0", "1.5", "-7.25", "31.4159", "1e-20"])
def test_transcendentals(x):
    for f in ("cos", "sin"):
        assert getattr(tbn, f)(Decimal(x)) == getattr(jbn, f)(Decimal(x))
    assert tbn.pi(80) == jbn.pi(80)


def test_optimal_split_and_nodes():
    assert [tbn.optimal_split(d) for d in range(1, 12)] == \
        [jbn.optimal_split(d) for d in range(1, 12)]
    a, b = Decimal("-1.5"), Decimal("2.25")
    assert tbn.chebyshev_nodes(17, tbn.Interval(a, b)) == \
        jbn.chebyshev_nodes(17, jbn.Interval(a, b))


def _polys(m):
    """A Chebyshev interpolant of sin(3x) and a monomial polynomial with a
    complex coefficient, their evaluation and factorization."""
    cheb = m.chebyshev_approximation(lambda x: m.sin(3 * x),
                                     m.Interval(Decimal(-2), Decimal(1), nodes=21))
    mono = m.Polynomial.from_values(m.MONOMIAL, [0.5, 1 - 2j, None, -0.25, 3.0, 0.125])
    mono.is_odd = mono.is_even = False
    out = [cheb.coeffs, cheb.change_of_basis(), cheb.depth,
           [cheb.evaluate(x) for x in (-1.75, 0.3, 0.9 + 0.2j)],
           [cheb.evaluate_decimal(Decimal(x)) for x in ("-1.5", "0.7")],
           [mono.evaluate(x) for x in (0.5, -1.25 + 0.5j)], mono.coeffs_complex()]
    for p, n in ((cheb, 12), (cheb, 16), (mono, 3)):
        q, r = p.factorize(n)
        out += [q.coeffs, r.coeffs]
    return out


def test_polynomial_chebyshev_factorize():
    assert _polys(tbn) == _polys(jbn)


def _remez(m):
    """A two-interval minimax fit of cos(2 pi x), as the mod1 circuit's
    CosDiscrete fit runs it, smaller."""
    two_pi = 2 * m.pi(m.DEFAULT_DIGITS)
    rp = m.RemezParameters(
        function=lambda x: m.cos(x * two_pi), basis=m.CHEBYSHEV,
        intervals=[m.Interval(Decimal("-0.3"), Decimal("-0.2"), 4),
                   m.Interval(Decimal("0.7"), Decimal("0.8"), 4)],
        scan_points=16, global_interval=(Decimal(-1), Decimal(1)))
    r = m.Remez(rp)
    p = r.approximate(max_iter=6, threshold=1e-3)
    return p.coeffs, (p.interval.a, p.interval.b), r.max_err, r.min_err


def test_remez():
    assert _remez(tbn) == _remez(jbn)

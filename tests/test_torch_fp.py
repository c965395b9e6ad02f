"""PyTorch port, the host-independent complex product (utils/fp.py).

``fma`` is held to the exact rational a b + c rounded to the nearest double
(ties to even), and ``cmul`` to the fused formula computed that way, on
random and near-cancelling inputs, with broadcasting as the special IFFT
uses it.  Neither depends on numpy's own complex multiply, which differs
between builds and hosts.
"""

from fractions import Fraction

import numpy as np

from matrix_fhe_tpu_torch.utils.fp import cmul, fma


def _exact_fma(a, b, c) -> float:
    return float(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 3000
    a, b = rng.standard_normal(n), rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    c = np.concatenate([rng.standard_normal(n // 3),                        # generic
                        -(a * b)[n // 3: 2 * n // 3],                       # cancelling
                        -(a * b)[2 * n // 3:] * (1 + 2.0 ** -52)])          # near it
    got = fma(a, b, c)
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)
    assert fma(0.1, 0.2, -0.02) == _exact_fma(0.1, 0.2, -0.02) != 0.1 * 0.2 - 0.02


def test_cmul_is_the_fused_product():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 64)) + 1j * rng.standard_normal((6, 64))
    w = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    got = cmul(a, w[None, :])
    assert got.shape == (6, 64) and got.dtype == np.complex128
    for x, y, z in zip(a.ravel(), np.broadcast_to(w, a.shape).ravel(), got.ravel()):
        assert z.real == _exact_fma(x.real, y.real, -(x.imag * y.imag))
        assert z.imag == _exact_fma(x.real, y.imag, x.imag * y.real)
    # times its conjugate: the imaginary part is the rounding error of ai ar
    got = cmul(a[0], np.conj(a[0])).imag
    want = [float(Fraction(x.imag * x.real) - Fraction(x.real) * Fraction(x.imag)) for x in a[0]]
    assert got.tolist() == want and any(want)

"""Decimal transcendentals for the encoder's arbitrary-precision embedding.

Copy of ``pi``, ``cos`` and ``sin`` from ``matrix_fhe_tpu/utils/bignum.py``
(the reference's utils/bignum, on Python's ``decimal``): argument-reduced
Taylor series at a requested number of digits.  The rest of that module
(Chebyshev and minimax approximation) belongs to the circuits (ROADMAP A6).
"""

from __future__ import annotations

from decimal import Decimal, getcontext, localcontext

DEFAULT_DIGITS = 50


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


def pi(digits: int = DEFAULT_DIGITS) -> Decimal:
    """Machin's formula: pi = 16 atan(1/5) - 4 atan(1/239)."""
    with localcontext() as ctx:
        ctx.prec = digits + 10
        p = 16 * _atan_inv(5, digits + 10) - 4 * _atan_inv(239, digits + 10)
    return +p


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

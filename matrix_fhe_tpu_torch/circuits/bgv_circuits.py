"""BGV circuit bindings: integer linear transforms and polynomial evaluation.

Counterpart of ``matrix_fhe_tpu/circuits/bgv_circuits.py`` (the reference's
circuits/bgv/lintrans/ and circuits/bgv/polynomial/): the integer embed
function (diagonals in Z_T, multiplicand form: no T^{-1} factor, so products
keep the ciphertext's) for the generic BSGS lintrans circuit
(``circuits/lintrans.py``), and Paterson-Stockmeyer evaluation of integer
polynomials through the generic power-basis machinery
(``circuits/polynomial.py``), with ``BGVSim`` tracking the scales mod T.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from matrix_fhe_tpu_torch.circuits import lintrans as lt
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext


def embed_fn(params, enc):
    """Integer-vector embed over (Q, P) in NTT + Montgomery multiplicand form
    (the bgv analogue of lintrans.go:205 Encode)."""

    def embed(values, level_q, level_p, scale):
        # gap-spread into degree N (encoder.go RingT2Q; gap 1 when T has
        # full order)
        spread = enc.spread(enc.encode_ring_t(values, int(scale) if scale else 1))[None, :]
        rq = params.ring_q.at_level(level_q)
        ptq = rq.mform(rq.ntt(spread % rq.moduli[:, None]))
        ptp = None
        if level_p is not None and level_p >= 0 and params.ring_p is not None:
            rp = params.ring_p.at_level(level_p)
            ptp = rp.mform(rp.ntt(spread % rp.moduli[:, None]))
        return ptq, ptp

    return embed


def new_linear_transformation(params, enc, diagonals: dict[int, np.ndarray],
                              ltp: lt.LinearTransformationParameters) -> lt.LinearTransformation:
    return lt.encode(embed_fn(params, enc), diagonals, ltp)


def evaluate(params, ct: Ciphertext, transform: lt.LinearTransformation, gks) -> Ciphertext:
    out = lt.evaluate(params, ct, transform, gks)
    # BGV scales live in Z_T: reduce the Fraction product mod t
    t = params.t
    s = out.scale
    return out.with_metadata(scale=Fraction(int(s) % t if s.denominator == 1
                                            else int(s.numerator * pow(s.denominator, -1, t)) % t))


class BGVSim:
    """Simulated BGV evaluator for the generic Paterson-Stockmeyer
    decomposition (circuits/bgv/polynomial/polynomial_evaluator_sim.go):
    scales are integers mod T (carried as integer Fractions); BFV
    (scale-invariant) mode consumes no levels and folds the -Q mod T
    tensor factor into the giant steps."""

    coeff_dtype = object            # exact python ints in slot vectors

    def __init__(self, params, invariant: bool = False):
        self.params = params
        self.t = params.t
        self.invariant = invariant

    def coeffs(self, poly) -> list:
        t = self.t
        return [0 if c is None else int(c) % t for c in poly.coeffs]

    def div_scale(self, a: Fraction, b: Fraction) -> Fraction:
        return Fraction(int(a) * pow(int(b), -1, self.t) % self.t)

    def polynomial_depth(self, degree: int) -> int:
        return 0 if self.invariant else degree.bit_length() - 1

    def rescale(self, op) -> None:
        if not self.invariant:
            op.scale = Fraction(int(op.scale) * pow(self.params.q[op.level], -1, self.t)
                                % self.t)
            op.level -= 1

    def mul(self, a, b):
        from matrix_fhe_tpu_torch.circuits.polynomial import SimOp
        level = min(a.level, b.level)
        s = int(a.scale) * int(b.scale) % self.t
        if self.invariant:
            q_mod_t = self.params.big_q(level) % self.t
            s = s * pow(self.t - q_mod_t, -1, self.t) % self.t
        return SimOp(level=level, scale=Fraction(s))

    def update_baby(self, lead: bool, t_level: int, t_scale: Fraction):
        if lead and not self.invariant:
            t_scale = Fraction(int(t_scale) * (self.params.q[t_level] % self.t) % self.t)
        return t_level, t_scale

    def update_giant(self, lead: bool, t_level: int, t_scale: Fraction,
                     xpow_scale: Fraction):
        s = int(t_scale) * pow(int(xpow_scale), -1, self.t) % self.t
        if self.invariant:
            q_mod_t = self.params.big_q(t_level) % self.t
            s = s * (self.t - q_mod_t) % self.t
            return t_level, Fraction(s)
        qi = self.params.q[t_level if lead else t_level + 1]
        return t_level + 1, Fraction(s * (qi % self.t) % self.t)


class _PSAdapter:
    """The evaluator surface circuits/polynomial.evaluate needs, over the
    BGV Evaluator (mirrors circuits/bgv/polynomial/polynomial_evaluator.go
    binding the common machinery to bgv semantics)."""

    def __init__(self, ev, enc):
        self._ev = ev
        self._enc = enc
        self.params = ev.params

    # pass-throughs
    def add(self, a, b):
        return self._ev.add(a, b)

    def sub(self, a, b):
        return self._ev.sub(a, b)

    def mul(self, a, b):
        return self._ev.mul(a, b)

    def mul_relin(self, a, b):
        return self._ev.mul_relin(a, b)

    def rescale(self, a):
        return self._ev.rescale(a)

    def relinearize(self, ct):
        from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
        return rlwe_eval.relinearize(self.params, ct, self._ev.rlk)

    def _drop_level(self, ct, level):
        return self._ev._drop(ct, level)

    def add_plain(self, a, pt):
        return self._ev.add(a, pt)

    def mul_plain(self, a, pt):
        return self._ev._mul_plain(a, pt)

    def add_const(self, a: Ciphertext, c) -> Ciphertext:
        t = self.params.t
        c = int(c) % t
        if c == 0:
            return a
        pt = self._enc.encode(np.full(self.params.n, c, dtype=object),
                              level=a.level, scale=int(a.scale))
        return self._ev.add(a, pt)

    def sub_const(self, a: Ciphertext, c) -> Ciphertext:
        return self.add_const(a, -int(c))

    def mul_const_then_add(self, xk: Ciphertext, c, res: Ciphertext) -> Ciphertext:
        """res += c * xk with the scalar pre-scaled by res.scale/xk.scale
        mod T (the reference's bgv MulThenAdd scalar semantics,
        schemes/bgv/evaluator.go MulThenAdd)."""
        t = self.params.t
        r = int(res.scale) * pow(int(xk.scale), -1, t) % t
        prod = self._ev._mul_int(self._ev._drop(xk, res.level), int(c) * r % t)
        return self._ev.add(res, prod.with_metadata(scale=res.scale))


class _PSEncoder:
    """Encoder shim: the generic machinery passes Fraction scales and
    numpy arrays; the BGV encoder wants int scales and int values."""

    def __init__(self, enc):
        self._enc = enc

    def encode(self, values, level=None, scale=None):
        vals = [int(v) for v in np.asarray(values).ravel()]
        return self._enc.encode(np.array(vals, dtype=object), level=level,
                                scale=int(scale) if scale else 1)


def evaluate_polynomial_ps(ev, enc, ct: Ciphertext, poly, target_scale: int | None = None,
                           slots: int | None = None) -> Ciphertext:
    """Paterson-Stockmeyer evaluation of an integer polynomial (or a
    slot-mapped PolynomialVector of them) on a BGV/BFV ciphertext:
    ceil(log2(deg+1)) levels instead of Horner's deg levels
    (circuits/bgv/polynomial/polynomial_evaluator.go:40-77 over the common
    machinery, with BGVSim supplying the mod-T scale tracking).

    ``poly``: list[int] coefficients (monomial basis), a bn.Polynomial, or
    a polynomial.PolynomialVector."""
    from matrix_fhe_tpu_torch.circuits import polynomial as pl
    from matrix_fhe_tpu_torch.utils import bignum as bn

    if isinstance(poly, (list, tuple)):
        cs = [int(c) for c in poly]
        poly = bn.Polynomial(basis=bn.MONOMIAL, coeffs=cs,
                             is_odd=all(c == 0 for c in cs[0::2]),
                             is_even=all(c == 0 for c in cs[1::2]))
    if target_scale is None:
        target_scale = int(ct.scale)
    sim = BGVSim(ev.params, invariant=ev.scale_invariant)
    return pl.evaluate(_PSAdapter(ev, enc), _PSEncoder(enc), ct, poly,
                       Fraction(int(target_scale)), slots=slots, sim=sim)


def evaluate_polynomial(ev, enc, ct: Ciphertext, coeffs: list[int]) -> Ciphertext:
    """Horner evaluation of an integer polynomial sum c_k x^k on a BGV
    ciphertext (Paterson-Stockmeyer, :func:`evaluate_polynomial_ps`, takes
    log depth instead; this form survives for short polynomials, where
    Horner's fewer key switches win)."""
    params = ev.params
    t = params.t
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("degree must be >= 1")

    def add_const(a, c):
        if c % t == 0:
            return a
        pt = enc.encode(np.full(params.n, c % t, dtype=np.int64), level=a.level,
                        scale=int(a.scale))
        return ev.add(a, pt)

    acc = add_const(ev._mul_int(ct, coeffs[deg] % t), coeffs[deg - 1])
    for k in range(deg - 2, -1, -1):
        acc = ev.rescale(ev.mul_relin(acc, ct))
        acc = add_const(acc, coeffs[k])
    return acc

"""Homomorphic polynomial evaluation: power basis + Paterson-Stockmeyer.

Counterpart of ``matrix_fhe_tpu/circuits/polynomial.py`` (the reference's
circuits/common/polynomial/ and circuits/ckks/polynomial/), over torch
ciphertexts: the only tensor this module makes is the zero ciphertext of a
baby step, on the operand's device and in its dtype (int32 limbs on the
fast path, int64 words on the u64 path).  Scales are exact ``Fraction``s.

  * ``PowerBasis`` with lazy power generation in monomial or Chebyshev basis
    (power_basis.go:57-183; C_{a+b} = 2 C_a C_b - C_{|a-b|}).
  * ``PatersonStockmeyerPolynomial``: recursive X^{2^k} factorization with a
    simulated evaluation (polynomial_evaluator_sim.go + the CKKS sim
    evaluator) that pre-computes the level and scale each sub-polynomial
    must be evaluated at so the baby-steps line up exactly.
  * ``evaluate``: baby-steps as <powers, coeffs> inner products, giant steps
    combining pairs with X^{2^k} (polynomial_evaluator.go:29-257).

The scheme evaluator must provide: add, sub, mul_relin, rescale, add_const,
mul_const_then_add, drop-level, plus an encoder for vector coefficients.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils import bignum as bn


def split_degree(n: int) -> tuple[int, int]:
    """SplitDegree (power_basis.go:33-52): a+b = n maximizing odd terms."""
    if n & (n - 1) == 0:
        return n // 2, n // 2
    k = (n - 1).bit_length() - 1
    return (1 << k) - 1, n + 1 - (1 << k)


class PowerBasis:
    """Powers X^n (monomial) or T_n(X) (Chebyshev) of a ciphertext
    (power_basis.go:17-183)."""

    def __init__(self, ct: Ciphertext, basis: str):
        self.basis = basis
        self.value: dict[int, Ciphertext] = {1: ct}
        self._pending: set[int] = set()

    def gen_power(self, n: int, ev) -> None:
        if n not in self.value:
            self._gen(n, ev)
        if n in self._pending:
            self.value[n] = ev.rescale(self.value[n])
            self._pending.discard(n)

    def _settle(self, m: int, ev) -> None:
        if m in self._pending:
            self.value[m] = ev.rescale(self.value[m])
            self._pending.discard(m)

    def _gen(self, n: int, ev) -> None:
        if n in self.value:
            return
        a, b = split_degree(n)
        self._gen(a, ev)
        self._gen(b, ev)
        self._settle(a, ev)
        self._settle(b, ev)
        v = ev.mul_relin(self.value[a], self.value[b])
        if self.basis == bn.CHEBYSHEV:
            v = ev.add(v, v)  # 2 C_a C_b
            c = abs(a - b)
            if c == 0:
                v = ev.sub_const(v, 1)
            else:
                self.gen_power(c, ev)
                v = ev.sub(v, self.value[c])
        self.value[n] = v
        self._pending.add(n)


# ---------------------------------------------------------------------------
# Paterson-Stockmeyer decomposition with simulated scale tracking.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PSPoly:
    """polynomial.go:17-57 Polynomial: a bignum polynomial + PS metadata."""
    poly: bn.Polynomial
    max_deg: int
    lead: bool
    level: int = 0
    scale: Fraction = Fraction(0)

    @property
    def degree(self) -> int:
        return self.poly.degree

    def factorize(self, n: int) -> tuple["PSPoly", "PSPoly"]:
        pq, pr = self.poly.factorize(n)
        q = PSPoly(poly=pq, max_deg=self.max_deg, lead=self.lead)
        if self.max_deg == self.degree:
            r_max = n - 1
        else:
            r_max = self.max_deg - (self.degree - n + 1)
        r = PSPoly(poly=pr, max_deg=r_max, lead=False)
        return q, r


@dataclasses.dataclass
class SimOp:
    level: int
    scale: Fraction


class CKKSSim:
    """circuits/ckks/polynomial/polynomial_evaluator_sim.go (PREC64 mode,
    one level per rescaling).

    A *sim* pre-computes the level/scale every sub-polynomial must hit so
    the baby-steps line up.  Scheme bindings supply their own sim (mod-T
    scales for BGV: circuits/bgv_circuits.BGVSim) plus the coefficient
    hooks below."""

    #: numpy dtype for slot-scattered coefficient vectors
    coeff_dtype = complex

    def __init__(self, params):
        self.params = params

    def coeffs(self, poly) -> list:
        """Per-degree coefficient list in the scheme's coefficient domain."""
        return poly.coeffs_complex()

    def div_scale(self, a: Fraction, b: Fraction) -> Fraction:
        """Scale ratio (mod-T inverse for BGV)."""
        return a / b

    def polynomial_depth(self, degree: int) -> int:
        return degree.bit_length() - 1

    def rescale(self, op: SimOp) -> None:
        op.scale = op.scale / Fraction(self.params.q[op.level])
        op.level -= 1

    def mul(self, a: SimOp, b: SimOp) -> SimOp:
        return SimOp(level=min(a.level, b.level), scale=a.scale * b.scale)

    def update_baby(self, lead: bool, t_level: int, t_scale: Fraction):
        if lead:
            t_scale = t_scale * Fraction(self.params.q[t_level])
        return t_level, t_scale

    def update_giant(self, lead: bool, t_level: int, t_scale: Fraction,
                     xpow_scale: Fraction):
        qi = Fraction(self.params.q[t_level] if lead else self.params.q[t_level + 1])
        return t_level + 1, t_scale * qi / xpow_scale


def _sim_gen_power(pb: dict[int, SimOp], n: int, sim) -> None:
    if n < 2 or n in pb:
        return
    a, b = split_degree(n)
    _sim_gen_power(pb, a, sim)
    _sim_gen_power(pb, b, sim)
    op = sim.mul(pb[a], pb[b])
    sim.rescale(op)
    pb[n] = op


@dataclasses.dataclass
class PolynomialVector:
    """polynomial.go:59-111 PolynomialVector: several polynomials evaluated
    simultaneously, each on its own set of slots.

    ``value[i]`` is evaluated on the slots listed in ``mapping[i]``; slots not
    covered by any entry decrypt to ~0.  All polynomials must share basis and
    interval (they are evaluated through one shared PowerBasis); they are
    padded to a common degree and factorized in lockstep so the
    Paterson-Stockmeyer splits align across the vector."""

    value: list
    mapping: dict

    def __post_init__(self):
        if not self.value:
            raise ValueError("empty polynomial vector")
        basis = self.value[0].basis
        interval = self.value[0].interval
        for p in self.value[1:]:
            if p.basis != basis:
                raise ValueError("polynomials must share a basis")
            if (interval is None) != (p.interval is None) or (
                    interval is not None and
                    (p.interval.a != interval.a or p.interval.b != interval.b)):
                raise ValueError("polynomials must share an interval")
        deg = max(p.degree for p in self.value)
        odd = all(p.is_odd for p in self.value)
        even = all(p.is_even for p in self.value)
        self.value = [
            bn.Polynomial(basis=basis,
                          coeffs=list(p.coeffs) + [None] * (deg - p.degree),
                          interval=p.interval, is_odd=odd, is_even=even)
            for p in self.value]
        seen = set()
        for i, idx in self.mapping.items():
            if not 0 <= i < len(self.value):
                raise ValueError(f"mapping key {i} out of range")
            dup = seen.intersection(idx)
            if dup:
                raise ValueError(f"slots {sorted(dup)[:4]} mapped twice")
            seen.update(idx)

    @property
    def basis(self) -> str:
        return self.value[0].basis

    @property
    def degree(self) -> int:
        return self.value[0].degree

    @property
    def is_odd(self) -> bool:
        return self.value[0].is_odd

    @property
    def is_even(self) -> bool:
        return self.value[0].is_even

    def change_of_basis(self):
        return self.value[0].change_of_basis()

    def evaluate(self, i: int, x) -> complex:
        return self.value[i].evaluate(x)


@dataclasses.dataclass
class PSDecomposition:
    degree: int
    base: int
    level: int
    scale: Fraction
    value: list[PSPoly]


def ps_decompose(poly: bn.Polynomial, input_level: int, input_scale: Fraction,
                 output_scale: Fraction, sim) -> PSDecomposition:
    """PatersonStockmeyerPolynomial (polynomial.go:73-106)."""
    log_degree = poly.degree.bit_length()
    log_split = bn.optimal_split(log_degree)

    pb = {1: SimOp(level=input_level, scale=Fraction(input_scale))}
    _sim_gen_power(pb, 1 << log_degree, sim)
    for i in range((1 << log_split) - 1, 2, -1):
        _sim_gen_power(pb, i, sim)

    root = PSPoly(poly=poly, max_deg=poly.degree, lead=True)
    target = input_level - sim.polynomial_depth(poly.degree)
    value, _ = _recurse_ps(log_split, target, root, pb, Fraction(output_scale), sim)
    return PSDecomposition(degree=poly.degree, base=1 << log_split,
                           level=input_level, scale=Fraction(output_scale),
                           value=value)


def _recurse_ps(log_split: int, target_level: int, p: PSPoly, pb, output_scale,
                sim):
    """recursePS (polynomial.go:108-152)."""
    if p.degree < (1 << log_split):
        if p.lead and log_split > 1 and \
                p.max_deg > (1 << p.max_deg.bit_length()) - (1 << (log_split - 1)):
            log_degree = p.degree.bit_length()
            return _recurse_ps(bn.optimal_split(log_degree), target_level, p,
                               pb, output_scale, sim)
        p.level, p.scale = sim.update_baby(p.lead, target_level, output_scale)
        return [p], SimOp(level=p.level, scale=p.scale)

    next_power = 1 << log_split
    while next_power < (p.degree >> 1) + 1:
        next_power <<= 1

    xpow = pb[next_power]
    q, r = p.factorize(next_power)
    t_level, t_scale = sim.update_giant(p.lead, target_level, output_scale,
                                        xpow.scale)
    bq, res = _recurse_ps(log_split, t_level, q, pb, t_scale, sim)
    sim.rescale(res)
    res = sim.mul(res, xpow)
    br, tmp = _recurse_ps(log_split, target_level, r, pb, res.scale, sim)
    return bq + br, res


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------

def evaluate(ev, enc, ct_or_pb, poly,
             target_scale: Fraction, slots: int | None = None,
             sim=None) -> Ciphertext:
    """Evaluate (polynomial_evaluator.go:29-96): generic P-S evaluation.

    ``ev``: scheme evaluator; ``enc``: scheme encoder; ``ct_or_pb``: input
    ciphertext or pre-computed PowerBasis.  ``poly`` is a single
    ``bn.Polynomial`` or a slot-mapped ``PolynomialVector``
    (polynomial_evaluator.go vectorized path).  For Chebyshev-basis
    polynomials the caller must first apply the change of basis
    ct' = scalar * ct + constant (poly.change_of_basis()).  ``sim`` is the
    scheme's simulated evaluator (default: CKKSSim; BGV bindings pass
    bgv_circuits.BGVSim for mod-T scale tracking)."""
    params = ev.params
    if isinstance(poly, PolynomialVector):
        polys, mapping = poly.value, poly.mapping
        slots = params.max_slots if slots is None else slots
    else:
        polys, mapping = [poly], None
    if isinstance(ct_or_pb, PowerBasis):
        pb = ct_or_pb
    else:
        pb = PowerBasis(ct_or_pb, poly.basis)

    log_degree = poly.degree.bit_length()
    log_split = bn.optimal_split(log_degree)
    odd, even = poly.is_odd, poly.is_even

    pb.gen_power(1 << (log_degree - 1), ev)
    for i in range((1 << log_split) - 1, 2, -1):
        if not (even or odd) or (i % 2 == 0 and even) or (i % 2 == 1 and odd):
            pb.gen_power(i, ev)

    if sim is None:
        sim = CKKSSim(params)
    ps_list = [ps_decompose(p, pb.value[1].level, pb.value[1].scale,
                            Fraction(target_scale), sim) for p in polys]
    return _evaluate_ps(ev, enc, ps_list, pb, mapping, slots, sim)


def _evaluate_ps(ev, enc, ps_list: list, pb: PowerBasis,
                 mapping, slots, sim) -> Ciphertext:
    """EvaluatePatersonStockmeyerPolynomialVector (:101-160).  ``ps_list``
    holds one (structurally identical) decomposition per vector entry."""
    split = len(ps_list[0].value)
    baby = []
    for i in range(split):
        sub = ps_list[0].value[i]
        baby.append([sub.degree if sub.degree > 0 else 0,
                     _evaluate_baby(ev, enc, [ps.value[i] for ps in ps_list],
                                    pb, mapping, slots, sim)])
    baby.reverse()  # ascending degree order

    while len(baby) > 1:
        # mark combinable pairs
        ops = [0] * len(baby)
        i = 0
        while i < len(baby):
            if i == len(baby) - 1:
                ops[i] = 2
            elif baby[i][0] == baby[i + 1][0]:
                ops[i] = 1
                i += 1
            i += 1
        i = 0
        while i < len(baby):
            if ops[i] == 2:
                baby[i][0] = baby[i - 1][0]
            elif ops[i] == 1:
                even_ct, odd_ct = baby[i][1], baby[i + 1][1]
                deg = 1 << baby[i][0].bit_length()
                odd_ct = _eval_monomial(ev, even_ct, odd_ct, pb.value[deg])
                baby[i + 1] = [2 * deg - 1, odd_ct]
                baby[i] = None
                i += 1
            i += 1
        baby = [b for b in baby if b is not None]

    out = baby[0][1]
    if out.degree == 2:
        out = ev.relinearize(out)
    return ev.rescale(out)


def _eval_monomial(ev, a: Ciphertext, b: Ciphertext, xpow: Ciphertext) -> Ciphertext:
    """a + b * X^{pow} (EvaluateMonomial :233-257)."""
    if b.degree == 2:
        b = ev.relinearize(b)
    b = ev.rescale(b)
    b = ev.mul(b, xpow)
    return ev.add(b, a)


def _evaluate_baby(ev, enc, subs: list, pb: PowerBasis,
                   mapping, slots, sim) -> Ciphertext:
    """EvaluatePolynomialVectorFromPowerBasis (:258-340): res = sum c_k X^k
    evaluated at (sub.level, sub.scale).  With a slot ``mapping``, c_k is a
    per-slot vector scattering each sub-polynomial's coefficient onto its
    assigned slots."""
    params = ev.params
    sub = subs[0]
    target_level, target_scale = sub.level, sub.scale
    css = [sim.coeffs(s.poly) for s in subs]
    x1 = pb.value[1]

    v1 = x1.value[0]
    zero = torch.zeros(v1.shape[:-2] + (target_level + 1, params.n),
                       dtype=v1.dtype, device=v1.device)
    res = Ciphertext(value=(zero, zero),
                     metadata=x1.metadata).with_metadata(scale=target_scale)

    def coeff(k):
        vals = [cs[k] if k < len(cs) else type(cs[0])(0) for cs in css]
        if all(c == 0 for c in vals):
            return None
        if mapping is None:
            return vals[0]
        v = np.zeros(slots, dtype=sim.coeff_dtype)
        for i, idx in mapping.items():
            v[np.asarray(idx, dtype=int)] = vals[i]
        return v

    c0 = coeff(0)
    if c0 is not None:
        if np.ndim(c0) == 0:
            res = ev.add_const(res, c0)
        else:
            pt = enc.encode(np.asarray(c0), level=target_level,
                            scale=target_scale)
            res = ev.add_plain(res, pt)

    for k in range(sub.degree, 0, -1):
        ck = coeff(k)
        if ck is None:
            continue
        xk = pb.value[k]
        if np.ndim(ck) == 0:
            res = ev.mul_const_then_add(xk, ck, res)
        else:
            pt_scale = sim.div_scale(target_scale, xk.scale)
            pt = enc.encode(np.asarray(ck), level=min(xk.level, target_level),
                            scale=pt_scale)
            prod = ev.mul_plain(ev._drop_level(xk, target_level), pt)
            res = ev.add(res, prod)
    return res

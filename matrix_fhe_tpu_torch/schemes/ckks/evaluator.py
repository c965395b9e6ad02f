"""CKKS evaluator on the u64 path.

Counterpart of ``matrix_fhe_tpu/schemes/ckks/evaluator.py`` (the reference's
schemes/ckks/evaluator.go):

  * add/sub with scale matching (:66-245 matchScaleThenEvaluateInPlace);
  * mul / mul_relin: the ciphertext tensor in the NTT domain (:764-918);
  * rescale: DivRoundByLastModulusNTT, scale /= q_l (:500-542);
  * rotate / conjugate via Galois automorphisms (:1195-1232);
  * plaintext and scalar ops, inner sum (:1284-1321);
  * diagonal-form linear transformations (``circuits/lintrans.py``).
"""

from __future__ import annotations

from fractions import Fraction
from math import ceil, floor

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from matrix_fhe_tpu_torch.rlwe.keys import GaloisKey, RelinearizationKey
from matrix_fhe_tpu_torch.schemes.ckks.params import CKKSParameters
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import constant


class Evaluator:
    """Stateless; holds the parameters and the key set (relinearization and
    galois keys)."""

    def __init__(self, params: CKKSParameters, rlk: RelinearizationKey | None = None,
                 galois_keys: dict[int, GaloisKey] | None = None):
        self.params = params
        self.rlk = rlk
        self.gks = galois_keys or {}

    # -- helpers -------------------------------------------------------------
    def _ring(self, level: int):
        return self.params.ring_q.at_level(level)

    def _match(self, a: Ciphertext, b: Ciphertext):
        """Level and scale alignment (evaluator.go:250-340): the lower-scale
        operand is multiplied by floor(ratio) (when >= 1) and both are taken
        at the higher scale, like the reference's ratioFlo.Int flooring."""
        level = min(a.level, b.level)
        a, b = self._drop_level(a, level), self._drop_level(b, level)
        if a.scale == b.scale:
            return a, b, a.scale
        lo, hi = (a, b) if a.scale < b.scale else (b, a)
        ratio = int(hi.scale / lo.scale)  # floor
        if ratio >= 1:
            lo = self._mul_integer(lo, ratio)
        lo = lo.with_metadata(scale=hi.scale)
        return (lo, hi, hi.scale) if a.scale < b.scale else (hi, lo, hi.scale)

    def _drop_level(self, ct: Ciphertext, level: int) -> Ciphertext:
        if ct.level == level:
            return ct
        return ct.with_value(tuple(v[..., : level + 1, :] for v in ct.value))

    def _integer_scalars(self, ring, c: int) -> list[int]:
        """The integer c as the per-limb scalars of mul_scalar_montgomery:
        MForm(c mod q_i) on this ring."""
        return [(c % q) * (1 << 64) % q for q in ring.moduli_tuple]

    def _mul_integer(self, ct: Ciphertext, c: int) -> Ciphertext:
        ring = self._ring(ct.level)
        sc = self._integer_scalars(ring, c)
        return ct.with_value(tuple(ring.mul_scalar_montgomery(v, sc) for v in ct.value))

    @staticmethod
    def _zip_add(ring, a: Ciphertext, b: Ciphertext, op) -> tuple:
        d = max(a.degree, b.degree)
        va = list(a.value) + [None] * (d - a.degree)
        vb = list(b.value) + [None] * (d - b.degree)
        return tuple(op(x, y) for x, y in zip(va, vb))

    # -- linear ops ------------------------------------------------------------
    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            return self.add_plain(a, b)
        a, b, scale = self._match(a, b)
        ring = self._ring(a.level)
        out = self._zip_add(ring, a, b, lambda x, y: x if y is None else (
            y if x is None else ring.add(x, y)))
        return a.with_value(out).with_metadata(scale=scale)

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            return self.add_plain(a, Plaintext(value=self._ring(b.level).neg(b.value),
                                               metadata=b.metadata))
        a, b, scale = self._match(a, b)
        ring = self._ring(a.level)
        out = self._zip_add(ring, a, b, lambda x, y: ring.neg(y) if x is None else (
            x if y is None else ring.sub(x, y)))
        return a.with_value(out).with_metadata(scale=scale)

    def neg(self, a: Ciphertext) -> Ciphertext:
        ring = self._ring(a.level)
        return a.with_value(tuple(ring.neg(v) for v in a.value))

    def add_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        level = min(a.level, pt.level)
        a = self._drop_level(a, level)
        ring = self._ring(level)
        ptv = pt.value[..., : level + 1, :]
        if pt.scale != a.scale:
            ratio = a.scale / pt.scale
            if ratio.denominator != 1:
                raise ValueError("plaintext scale incompatible")
            ptv = ring.mul_scalar_montgomery(ptv, self._integer_scalars(ring, int(ratio)))
        return a.with_value((ring.add(a.value[0], ptv),) + a.value[1:])

    # -- multiplication ---------------------------------------------------------
    def mul(self, a: Ciphertext, b) -> Ciphertext:
        """Tensor without relinearization -> degree-2 ct (evaluator.go:630)."""
        if isinstance(b, Plaintext):
            return self.mul_plain(a, b)
        return self._tensor(a, b, relin=False)

    def mul_relin(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            return self.mul_plain(a, b)
        return self._tensor(a, b, relin=True)

    def _tensor(self, a: Ciphertext, b: Ciphertext, relin: bool) -> Ciphertext:
        """mulRelin (evaluator.go:786-918): NTT-domain tensor product."""
        level = min(a.level, b.level)
        a, b = self._drop_level(a, level), self._drop_level(b, level)
        if a.degree != 1 or b.degree != 1:
            raise ValueError("tensor expects degree-1 inputs")
        ring = self._ring(level)
        a0, a1 = ring.mform(a.value[0]), ring.mform(a.value[1])
        c0 = ring.mul_coeffs_montgomery(a0, b.value[0])
        c1 = ring.add(ring.mul_coeffs_montgomery(a0, b.value[1]),
                      ring.mul_coeffs_montgomery(a1, b.value[0]))
        c2 = ring.mul_coeffs_montgomery(a1, b.value[1])
        ct = Ciphertext(value=(c0, c1, c2), metadata=a.metadata).with_metadata(
            scale=a.scale * b.scale)
        return self.relinearize(ct) if relin else ct

    # -- key-switching indirection ------------------------------------------
    # Circuits call these methods, so an evaluator over another numeric
    # backend (fast/feval.py, the int32 path) overrides only them.

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        if self.rlk is None:
            raise ValueError("no relinearization key")
        return rlwe_eval.relinearize(self.params, ct, self.rlk)

    def apply_evaluation_key(self, ct: Ciphertext, evk) -> Ciphertext:
        return rlwe_eval.apply_evaluation_key(self.params, ct, evk)

    def evaluate_lintrans(self, ct: Ciphertext, lt_obj, gks=None) -> Ciphertext:
        """One diagonal-form linear transformation (BSGS double-hoisted)."""
        from matrix_fhe_tpu_torch.circuits import lintrans as lt
        return lt.evaluate(self.params, ct, lt_obj, self.gks if gks is None else gks)

    def trace_log_n(self, ct: Ciphertext, log_n: int) -> Ciphertext:
        """rlwe trace with an explicit subring degree (inner_sum.go:36)."""
        return rlwe_eval.trace(self.params, ct, log_n, self.gks)

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Bootstrap ModUp raise (bootstrapping/evaluator.go:683-700): the
        level-0 coefficients lifted centered from q0 to the full chain Q,
        with a full Barrett reduction per destination limb."""
        params = self.params
        q0 = params.q[0]
        rq0 = params.ring_q.at_level(0)
        rq = params.ring_q
        qq = rq.moduli[:, None]

        def centered_lift(coeff):
            neg = coeff >= (q0 >> 1)
            mag = torch.where(neg, q0 - coeff, coeff)
            t = mm.bred_add(mag[None, :], qq, rq.bhi[:, None])
            return torch.where(neg[None, :], torch.where(t == 0, t, qq - t), t)

        return ct.with_value(tuple(rq.ntt(centered_lift(rq0.intt(v)[..., 0, :]))
                                   for v in ct.value))

    def mul_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        level = min(a.level, pt.level)
        a = self._drop_level(a, level)
        ring = self._ring(level)
        ptm = ring.mform(pt.value[..., : level + 1, :])
        out = tuple(ring.mul_coeffs_montgomery(v, ptm) for v in a.value)
        return a.with_value(out).with_metadata(scale=a.scale * pt.scale)

    def mul_const(self, a: Ciphertext, c) -> Ciphertext:
        """Multiply by a real scalar encoded at scale q[level], so that the
        next rescale cancels the scale exactly (evaluator.go:433)."""
        if isinstance(c, int):
            return self._mul_integer(a, c)
        scale = Fraction(self.params.q[a.level])
        out = self._mul_integer(a, round(float(c) * float(scale)))
        return out.with_metadata(scale=a.scale * scale)

    def scale_up(self, a: Ciphertext, factor: int) -> Ciphertext:
        """Multiply by an integer and track it in the scale
        (ScaleUp, evaluator.go:449-462)."""
        return self._mul_integer(a, factor).with_metadata(scale=a.scale * Fraction(factor))

    def drop_level(self, a: Ciphertext, n: int = 1) -> Ciphertext:
        return self._drop_level(a, a.level - n)

    def set_scale(self, a: Ciphertext, target) -> Ciphertext:
        """SetScale: consume one level to bring the ciphertext to exactly
        ``target``."""
        target = Fraction(target)
        out = self.rescale(self.mul_const(a, float(target / a.scale)))
        return out.with_metadata(scale=target)

    # -- scalar (double-RNS) operations ------------------------------------------
    # evaluateWithScalar (evaluator.go:433-447): in the NTT domain a complex
    # constant a+bi is [a + b*i_q]*N/2 || [a - b*i_q]*N/2, with
    # i_q = psi^{N/2} = g^{(q-1)/4} a principal 4th root of unity mod q.

    def _double_rns_scalar_ints(self, level: int, c: complex, scale
                                ) -> tuple[list[int], list[int]]:
        """Per-limb integer scalars of a complex constant (host Python)."""
        def round_half(x: float) -> int:
            # bigComplexToRNSScalar (scaling.go:10-44): add +-0.5, truncate
            return floor(x + 0.5) if x > 0 else (ceil(x - 0.5) if x < 0 else 0)

        sf = float(scale)
        a, b = round_half(c.real * sf), round_half(c.imag * sf)
        if self.params.ring_type == "conjugate_invariant":
            if b:
                raise ValueError("complex constant undefined on the CI ring")
            s = [a % q for q in self.params.q[: level + 1]]
            return s, s
        s0, s1 = [], []
        for q in self.params.q[: level + 1]:
            g, _ = pr.primitive_root(q)
            iq = pow(g, (q - 1) // 4, q)
            s0.append((a + b * iq) % q)
            s1.append((a - b * iq) % q)
        return s0, s1

    def _double_rns_scalars(self, level: int, c: complex, scale) -> tuple:
        s0, s1 = self._double_rns_scalar_ints(level, c, scale)
        dev = self.params.device
        return (constant(s0, torch.int64, dev)[:, None], constant(s1, torch.int64, dev)[:, None])

    def _apply_double_rns(self, ct: Ciphertext, s0, s1, op: str,
                          mul_scale=None) -> Ciphertext:
        ring = self._ring(ct.level)
        h = self.params.n // 2
        f = {"add": ring.add, "sub": ring.sub, "mul": ring.mul_coeffs_barrett}[op]

        def run(v):
            lo, hi = v[..., :h], v[..., h:]
            return torch.cat([f(lo, s0.expand_as(lo)), f(hi, s1.expand_as(hi))], dim=-1)

        if op in ("add", "sub"):
            return ct.with_value((run(ct.value[0]),) + ct.value[1:])
        return ct.with_value(tuple(run(v) for v in ct.value)).with_metadata(
            scale=ct.scale * mul_scale)

    def add_const(self, ct: Ciphertext, c) -> Ciphertext:
        """ct + constant (complex), encoded at ct.scale (evaluator.go:82-101)."""
        s0, s1 = self._double_rns_scalars(ct.level, complex(c), ct.scale)
        return self._apply_double_rns(ct, s0, s1, "add")

    def sub_const(self, ct: Ciphertext, c) -> Ciphertext:
        s0, s1 = self._double_rns_scalars(ct.level, complex(c), ct.scale)
        return self._apply_double_rns(ct, s0, s1, "sub")

    def mul_const_complex(self, ct: Ciphertext, c, scale=None) -> Ciphertext:
        """ct * constant (complex) encoded at ``scale`` (default q[level],
        cancelled exactly by the next rescale)."""
        scale = Fraction(self.params.q[ct.level] if scale is None else scale)
        s0, s1 = self._double_rns_scalars(ct.level, complex(c), scale)
        return self._apply_double_rns(ct, s0, s1, "mul", mul_scale=scale)

    def mul_const_then_add(self, x: Ciphertext, c, res: Ciphertext) -> Ciphertext:
        """res += x * const, the const encoded at res.scale/x.scale
        (MulThenAdd scalar path, evaluator.go:918-1010)."""
        prod = self.mul_const_complex(self._drop_level(x, res.level), c, res.scale / x.scale)
        return self.add(res, prod)

    def _add_raw(self, res: Ciphertext, prod: Ciphertext) -> Ciphertext:
        """Limb-wise accumulation of ``prod`` into ``res`` at res's scale."""
        ring = self._ring(res.level)
        return res.with_value(self._zip_add(ring, res, prod, lambda x, y: x if y is None else (
            y if x is None else ring.add(x, y))))

    def mul_then_add(self, a: Ciphertext, b, res: Ciphertext) -> Ciphertext:
        """res += a * b without relinearization (MulThenAdd,
        evaluator.go:918-1046)."""
        return self._mul_then_add(a, b, res, relin=False)

    def mul_relin_then_add(self, a: Ciphertext, b, res: Ciphertext) -> Ciphertext:
        """res += relin(a * b) (MulRelinThenAdd, evaluator.go:1065-1094)."""
        return self._mul_then_add(a, b, res, relin=True)

    def _mul_then_add(self, a: Ciphertext, b, res: Ciphertext, relin: bool) -> Ciphertext:
        level = min(a.level, b.level, res.level)
        if isinstance(b, Plaintext):
            prod = self.mul_plain(self._drop_level(a, level), b)
        else:
            prod = self._tensor(self._drop_level(a, level), self._drop_level(b, level),
                                relin=False)
            if relin:
                prod = self.relinearize(prod)
        res = self._drop_level(res, level)
        if res.scale < prod.scale:
            ratio = prod.scale / res.scale
            # scale up only when int(ratio) >= 2, truncated like the
            # reference's ratio.Value.Int (evaluator.go:1104-1110)
            if int(ratio) >= 2:
                res = self._mul_integer(res, int(ratio)).with_metadata(scale=prod.scale)
        elif res.scale > prod.scale:
            raise ValueError("mul_then_add: res.scale > a.scale * b.scale is "
                             "unsupported (evaluator.go:1103)")
        return self._add_raw(res, prod)

    # -- rescaling ---------------------------------------------------------------
    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by the last modulus (evaluator.go:500-542)."""
        level = a.level
        if level == 0:
            raise ValueError("cannot rescale: level 0")
        ring = self._ring(level)
        div = (rt.div_round_by_last_modulus_ntt if a.metadata.is_ntt
               else rt.div_round_by_last_modulus)
        out = tuple(div(ring, v) for v in a.value)
        return a.with_value(out).with_metadata(scale=a.scale / Fraction(self.params.q[level]))

    def rescale_to_default(self, a: Ciphertext) -> Ciphertext:
        """Rescale while scale >= (default/2) * q_l (evaluator.go:543-612)."""
        min_scale = self.params.default_scale / 2
        ct = a
        while ct.level > 0 and ct.scale / Fraction(self.params.q[ct.level]) >= min_scale:
            ct = self.rescale(ct)
        return ct

    # -- rotations ------------------------------------------------------------------
    def rotate(self, a: Ciphertext, k: int) -> Ciphertext:
        """Rotate slots left by k (evaluator.go:1202)."""
        return self._automorphism(a, self.params.galois_element(k))

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        if self.params.ring_type == "conjugate_invariant":
            raise ValueError("undefined on the conjugate-invariant ring")
        return self._automorphism(a, self.params.galois_element_inverse())

    def _automorphism(self, a: Ciphertext, gal_el: int) -> Ciphertext:
        if gal_el == 1:
            return a
        gk = self.gks.get(gal_el)
        if gk is None:
            raise ValueError(f"missing Galois key for element {gal_el}")
        return rlwe_eval.automorphism(self.params, a, gk)

    def rotate_hoisted(self, a: Ciphertext, ks: list[int]) -> dict[int, Ciphertext]:
        """RotateHoisted (evaluator.go:1245): one decomposition, many rotations."""
        digits = rlwe_eval.decompose_ntt(self.params, a.level, a.value[1])
        out = {}
        for k in ks:
            gal_el = self.params.galois_element(k)
            if gal_el == 1:
                out[k] = a
                continue
            gk = self.gks.get(gal_el)
            if gk is None:
                raise ValueError(f"missing Galois key for rotation {k}")
            out[k] = rlwe_eval.automorphism_hoisted(self.params, a, digits, gk)
        return out

    def inner_function(self, a: Ciphertext, batch: int, n: int, fn) -> Ciphertext:
        """InnerFunction (core/rlwe/inner_sum.go:316): log-step folding of
        the slots (i + batch*j), j < n, with an associative binary op."""
        if n < 1:
            raise ValueError("n must be >= 1")
        result = None
        m = 0
        for bit in reversed(range(n.bit_length())):
            if result is not None:
                result = fn(result, self.rotate(result, batch * m))
                m *= 2
            if (n >> bit) & 1:
                result = a if result is None else fn(a, self.rotate(result, batch))
                m += 1
        return result

    def inner_sum(self, a: Ciphertext, batch: int, n: int) -> Ciphertext:
        """InnerSum (inner_sum.go:361): slot i = sum_{j<n} slot (i + batch*j)."""
        return self.inner_function(a, batch, n, self.add)

    def replicate(self, a: Ciphertext, batch: int, n: int) -> Ciphertext:
        """Replicate (core/rlwe/inner_sum.go:477)."""
        return self.inner_sum(a, -batch, n)

    def trace(self, a: Ciphertext, log_slots: int) -> Ciphertext:
        """Project onto 2^log_slots slots (inner_sum.go:36)."""
        return self.trace_log_n(a, log_slots + 1)

    def galois_elements_for_inner_sum(self, batch: int, n: int) -> list[int]:
        els = set()
        result_m = 0
        for bit in reversed(range(n.bit_length())):
            if result_m:
                els.add(self.params.galois_element(batch * result_m))
                result_m *= 2
            if (n >> bit) & 1:
                if result_m:
                    els.add(self.params.galois_element(batch))
                result_m += 1
        els.discard(1)
        return sorted(els)

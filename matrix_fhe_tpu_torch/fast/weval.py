"""WideEvaluator: the CKKS evaluator API on the wide (41-61-bit) path.

Counterpart of ``matrix_fhe_tpu/fast/weval.py``.  A subclass of
``schemes.ckks.Evaluator`` over a :class:`fast.wckks.WideCKKSContext`
whose ciphertexts hold canonical 64-bit words [L, N] in the plain domain
(the JAX package's hold centered int32 pairs; ``wide.unpack_pair`` of those
are these words).  Every circuit (polynomial evaluation, mod1, the
homomorphic DFT, bootstrapping, the minimax comparisons and the inverse)
programs against the evaluator interface, so all of it runs on this path.
The scale and level bookkeeping and the linear ops are inherited
(``WideRing`` has the ``Ring`` surface, with the identity ``mform``); the
integer scalars (plain domain), rescale, relinearization, evaluation keys,
automorphisms, hoisted rotations, the linear transformations and the trace
are overridden, as in the JAX evaluator.  ``mod_raise`` is inherited: on
words the u64 evaluator's centered lift is the wide one (the JAX evaluator
overrides it for its pairs).  Each op equals the u64 evaluator's output bit
for bit on the same moduli and keys.

A ciphertext of the u64 path and of this one hold the same words, so
``ct_to_wide``/``ct_to_u64`` are copies.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from matrix_fhe_tpu_torch.fast import wckks, wlintrans, wrns
from matrix_fhe_tpu_torch.fast.wckks import WideCKKSContext
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from matrix_fhe_tpu_torch.schemes import ckks


def ct_to_wide(ct: Ciphertext, params=None) -> Ciphertext:
    """A u64-path ciphertext as a wide one: the same words, copied."""
    return ct.with_value(tuple(v.clone() for v in ct.value))


def ct_to_u64(ct: Ciphertext, params=None) -> Ciphertext:
    """A wide ciphertext as a u64-path one: the same words, copied."""
    return ct.with_value(tuple(v.clone() for v in ct.value))


class WideEncoder:
    """Encoder adapter: the host-side embedding is the u64 encoder's; a
    plaintext's words are the wide path's as they are."""

    def __init__(self, params):
        self.params = params
        self._u64 = ckks.Encoder(params)

    def encode(self, values, level=None, scale=None, is_ntt=True) -> Plaintext:
        return self._u64.encode(values, level=level, scale=scale, is_ntt=is_ntt)

    def decode(self, pt: Plaintext) -> np.ndarray:
        return self._u64.decode(pt)

    def embed_qp(self, values, level_q, level_p=None, scale=None):
        """u64 QP embedding for DFT-matrix generation (the diagonals stay in
        u64 LinearTransformation form, converted once by
        ``WideEvaluator.wide_lintrans``)."""
        return self._u64.embed_qp(values, level_q, level_p, scale)


class WideEvaluator(ckks.Evaluator):
    """ckks.Evaluator over wide word ciphertexts and a wide context built at
    the parameters' top level; one level view of the context is kept a
    level."""

    def __init__(self, params, ctx: WideCKKSContext):
        super().__init__(params, rlk=None, galois_keys=None)
        if ctx.level != params.max_level:
            raise ValueError("wide context must be built at the top level")
        self._ctx_cache: dict[int, WideCKKSContext] = {ctx.level: ctx}
        # id(u64 object) -> (it, its conversion); the object is kept so that
        # its id is not reused
        self._wlt_cache: dict[int, tuple] = {}
        self._evk_cache: dict[int, tuple] = {}

    # -- context ladder --------------------------------------------------------
    def _ctx(self, level: int) -> WideCKKSContext:
        c = self._ctx_cache.get(level)
        if c is None:
            c = self._ctx_cache[max(self._ctx_cache)].at_level(level)
            self._ctx_cache[level] = c
        return c

    def _ring(self, level: int):
        return self._ctx(level).ring_q

    # -- scalars: plain domain -------------------------------------------------
    def _integer_scalars(self, ring, c: int) -> list[int]:
        return [c % q for q in ring.moduli_tuple]

    # -- rescale -----------------------------------------------------------------
    def rescale(self, a: Ciphertext) -> Ciphertext:
        level = a.level
        if level == 0:
            raise ValueError("cannot rescale: level 0")
        ring = self._ring(level)
        if a.metadata.is_ntt:
            out = tuple(wrns.div_round_by_last_modulus_many_ntt(ring, v, 1) for v in a.value)
        else:
            out = tuple(wrns.div_round_by_last_modulus(ring, v) for v in a.value)
        return a.with_value(out).with_metadata(scale=a.scale / Fraction(self.params.q[level]))

    # -- key switching -----------------------------------------------------------
    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        if ct.degree != 2:
            raise ValueError("relinearize expects a degree-2 ciphertext")
        ctx = self._ctx(ct.level)
        r0, r1 = wckks.gadget_product(ctx, ct.value[2])
        rq = ctx.ring_q
        return ct.with_value((rq.add(ct.value[0], r0), rq.add(ct.value[1], r1)))

    def _evk_wide(self, evk, level: int):
        """A u64 EvaluationKey's gadget in the plain domain (converted once,
        kept by the key's identity), sliced to ``level``."""
        hit = self._evk_cache.get(id(evk))
        if hit is None:
            hit = (evk, wckks.convert_gadget(self.params, evk.gadget))
            self._evk_cache[id(evk)] = hit
        kq, kp = hit[1]
        D = self._ctx(level).dec.num_digits
        return kq[:D, :, : level + 1, :], kp[:D]

    def apply_evaluation_key(self, ct: Ciphertext, evk) -> Ciphertext:
        ctx = self._ctx(ct.level)
        kq, kp = self._evk_wide(evk, ct.level)
        d0, d1 = wckks.gadget_product_core(ctx, kq, kp, ct.value[1])
        return ct.with_value((ctx.ring_q.add(d0, ct.value[0]), d1))

    # -- automorphisms -----------------------------------------------------------
    def _automorphism(self, a: Ciphertext, gal_el: int) -> Ciphertext:
        if gal_el == 1:
            return a
        d0, d1 = wckks.automorphism(self._ctx(a.level), a.value[0], a.value[1], gal_el)
        return a.with_value((d0, d1))

    def rotate_hoisted(self, a: Ciphertext, ks: list[int]) -> dict[int, Ciphertext]:
        ctx = self._ctx(a.level)
        gal = {k: self.params.galois_element(k) for k in ks}
        els = sorted({g for g in gal.values() if g != 1})
        res = wckks.rotations_hoisted(ctx, a.value[0], a.value[1], els) if els else {}
        return {k: (a if g == 1 else a.with_value(res[g])) for k, g in gal.items()}

    # -- composites --------------------------------------------------------------
    def evaluate_lintrans(self, ct: Ciphertext, lt_obj, gks=None) -> Ciphertext:
        """BSGS (or naive, n1 == 0) diagonal-matrix multiply on the wide path
        (``fast/wlintrans.py``); ``gks`` is unused: the galois keys are the
        context's."""
        wlt = self.wide_lintrans(lt_obj)
        level = min(ct.level, lt_obj.level_q)
        ct = self._drop_level(ct, level)
        matvec = wlintrans.matvec_naive if lt_obj.n1 == 0 else wlintrans.matvec_bsgs
        out0, out1 = matvec(self._ctx(level), wlt, ct.value[0], ct.value[1],
                            self.params.galois_element)
        return ct.with_value((out0, out1)).with_metadata(scale=ct.scale * lt_obj.scale)

    def wide_lintrans(self, lt_obj) -> wlintrans.WideLinearTransformation:
        """The plain-domain conversion of a u64 ``LinearTransformation``, made once."""
        hit = self._wlt_cache.get(id(lt_obj))
        if hit is None:
            hit = (lt_obj, wlintrans.convert_lintrans(self.params, lt_obj))
            self._wlt_cache[id(lt_obj)] = hit
        return hit[1]

    def trace_log_n(self, ct: Ciphertext, log_n: int) -> Ciphertext:
        """The wide mirror of rlwe trace (core/rlwe/inner_sum.go:36-124),
        NTT domain only."""
        if ct.degree != 1:
            raise ValueError("trace expects a degree-1 ciphertext")
        if not ct.metadata.is_ntt:
            raise ValueError("wide trace expects an NTT-domain ciphertext")
        params = self.params
        ring = self._ring(ct.level)
        gap = 1 << (params.log_n - log_n - 1)
        if log_n == 0:
            gap <<= 1
        if gap <= 1:
            return ct
        sc = [pow(gap, -1, q) for q in ring.moduli_tuple]
        out = ct.with_value(tuple(ring.mul_scalar_montgomery(v, sc) for v in ct.value))
        els = [params.galois_element(1 << i) for i in range(log_n, params.log_n - 1)]
        if log_n == 0 and params.ring_type == "standard":
            els.append(params.nth_root - 1)
        for g in els:
            rot = self._automorphism(out, g)
            out = out.with_value((ring.add(out.value[0], rot.value[0]),
                                  ring.add(out.value[1], rot.value[1])))
        return out


def make_wide_evaluator(params, rlk, gks, rescale_limbs: int = 1) -> WideEvaluator:
    """A WideEvaluator from u64-path keys (converted once)."""
    return WideEvaluator(params, wckks.make_context(params, rlk, gks,
                                                    rescale_limbs=rescale_limbs))

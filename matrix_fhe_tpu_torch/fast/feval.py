"""FastEvaluator: the CKKS evaluator API on the int32 fast path.

Counterpart of ``matrix_fhe_tpu/fast/feval.py``.  A subclass of
``schemes.ckks.Evaluator`` whose ciphertexts hold int32 [L, N] limbs
(canonical in [0, q), q < 2^23) instead of 64-bit words, over a
:class:`fast.fckks.FastCKKSContext`: every NTT it runs is a
``FastRing.ntt``/``intt``, so CUDA tensors go through kernel B1
(``ops/ntt_cuda.py``).  The scale and level bookkeeping and the linear ops
are inherited (``FastRing`` has the ``Ring`` surface it needs); the
integer and double-RNS scalars (plain domain instead of Montgomery),
rescale, relinearization, automorphisms, trace and mod-raise are
overridden.  Each override equals the u64 evaluator's output bit for bit on
the same moduli and keys.

``evaluate_lintrans`` runs ``fast/flintrans.py`` on the int32 limbs, and
never the u64 method, which would run 64-bit word arithmetic on them.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.fast import fckks, flintrans, frns
from matrix_fhe_tpu_torch.fast.fckks import FastCKKSContext
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from matrix_fhe_tpu_torch.schemes import ckks
from matrix_fhe_tpu_torch.utils.device import constant


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """u64-path canonical limbs (< 2^23) -> int32 fast-path limbs."""
    return v.to(torch.int32)


def to_uint64(v: torch.Tensor) -> torch.Tensor:
    """int32 fast-path canonical limbs -> u64-path words (int64)."""
    return v.to(torch.int64)


def ct_to_fast(ct: Ciphertext) -> Ciphertext:
    return ct.with_value(tuple(to_int32(v) for v in ct.value))


def ct_to_u64(ct: Ciphertext) -> Ciphertext:
    return ct.with_value(tuple(to_uint64(v) for v in ct.value))


class FastEncoder:
    """Encoder adapter: the host-side embedding is the u64 encoder's
    (``schemes/ckks/encoder.py``); plaintext limbs are cast to int32."""

    def __init__(self, params):
        self.params = params
        self._u64 = ckks.Encoder(params)

    def encode(self, values, level=None, scale=None, is_ntt=True) -> Plaintext:
        pt = self._u64.encode(values, level=level, scale=scale, is_ntt=is_ntt)
        return Plaintext(value=to_int32(pt.value), metadata=pt.metadata)

    def decode(self, pt: Plaintext) -> np.ndarray:
        return self._u64.decode(Plaintext(value=to_uint64(pt.value), metadata=pt.metadata))


class FastEvaluator(ckks.Evaluator):
    """ckks.Evaluator over int32 ciphertexts and a fast context built at the
    parameters' top level; one level view of the context is kept a level."""

    def __init__(self, params, ctx: FastCKKSContext):
        super().__init__(params, rlk=None, galois_keys=None)
        if ctx.level != params.max_level:
            raise ValueError("fast context must be built at the top level")
        self._ctx_cache: dict[int, FastCKKSContext] = {ctx.level: ctx}
        self._evk_cache: dict[int, tuple] = {}
        # id(u64 LinearTransformation) -> (it, its int32 conversion); the
        # object is kept so that its id is not reused
        self._flt_cache: dict[int, tuple] = {}

    def _ctx(self, level: int) -> FastCKKSContext:
        c = self._ctx_cache.get(level)
        if c is None:
            c = self._ctx_cache[max(self._ctx_cache)].at_level(level)
            self._ctx_cache[level] = c
        return c

    def _ring(self, level: int):
        return self._ctx(level).ring_q

    # -- scalars: plain domain ------------------------------------------------
    def _integer_scalars(self, ring, c: int) -> list[int]:
        return [c % q for q in ring.moduli_tuple]

    def _double_rns_scalars(self, level: int, c: complex, scale) -> tuple:
        s0, s1 = self._double_rns_scalar_ints(level, c, scale)
        dev = self.params.device
        return (constant(s0, torch.int32, dev)[:, None], constant(s1, torch.int32, dev)[:, None])

    # -- rescale -------------------------------------------------------------
    def rescale(self, a: Ciphertext) -> Ciphertext:
        level = a.level
        if level == 0:
            raise ValueError("cannot rescale: level 0")
        ring = self._ring(level)
        if a.metadata.is_ntt:
            out = tuple(frns.div_round_by_last_modulus_many_ntt(ring, v, 1) for v in a.value)
        else:
            out = tuple(frns.div_round_by_last_modulus(ring, v) for v in a.value)
        return a.with_value(out).with_metadata(scale=a.scale / Fraction(self.params.q[level]))

    # -- key switching -------------------------------------------------------
    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        if ct.degree != 2:
            raise ValueError("relinearize expects a degree-2 ciphertext")
        ctx = self._ctx(ct.level)
        r0, r1 = fckks.gadget_product(ctx, ct.value[2])
        rq = ctx.ring_q
        return ct.with_value((rq.add(ct.value[0], r0), rq.add(ct.value[1], r1)))

    def _evk32(self, evk, level: int):
        """A u64 EvaluationKey's gadget as int32 stacks (converted once, kept
        by the key's identity), sliced to ``level``."""
        kq, kp = self._evk_cache.get(id(evk), (None, None))
        if kq is None:
            kq, kp = fckks._convert_gadget(self.params, evk.gadget)
            self._evk_cache[id(evk)] = (kq, kp)
        D = self._ctx(level).dec.num_digits
        return kq[:D, :, : level + 1, :], kp[:D]

    def apply_evaluation_key(self, ct: Ciphertext, evk) -> Ciphertext:
        ctx = self._ctx(ct.level)
        kq, kp = self._evk32(evk, ct.level)
        d0, d1 = fckks.gadget_product_core(ctx, kq, kp, ct.value[1])
        return ct.with_value((ctx.ring_q.add(d0, ct.value[0]), d1))

    # -- automorphisms -------------------------------------------------------
    def _automorphism(self, a: Ciphertext, gal_el: int) -> Ciphertext:
        if gal_el == 1:
            return a
        d0, d1 = fckks.automorphism(self._ctx(a.level), a.value[0], a.value[1], gal_el)
        return a.with_value((d0, d1))

    def rotate_hoisted(self, a: Ciphertext, ks: list[int]) -> dict[int, Ciphertext]:
        ctx = self._ctx(a.level)
        gal = {k: self.params.galois_element(k) for k in ks}
        els = sorted({g for g in gal.values() if g != 1})
        res = fckks.rotations_hoisted(ctx, a.value[0], a.value[1], els) if els else {}
        return {k: (a if g == 1 else a.with_value(res[g])) for k, g in gal.items()}

    # -- composites ----------------------------------------------------------
    def evaluate_lintrans(self, ct: Ciphertext, lt_obj, gks=None) -> Ciphertext:
        """BSGS (or naive, n1 == 0) diagonal-matrix multiply on the int32
        path (``fast/flintrans.py``).  The u64 ``lt_obj``'s plaintexts are
        converted to plain-domain int32 once and cached by the object's
        identity; ``gks`` is unused: the galois keys are the context's."""
        flt = self.fast_lintrans(lt_obj)
        level = min(ct.level, lt_obj.level_q)
        ct = self._drop_level(ct, level)
        matvec = flintrans.matvec_naive if lt_obj.n1 == 0 else flintrans.matvec_bsgs
        out0, out1 = matvec(self._ctx(level), flt, ct.value[0], ct.value[1],
                            self.params.galois_element)
        return ct.with_value((out0, out1)).with_metadata(scale=ct.scale * lt_obj.scale)

    def fast_lintrans(self, lt_obj) -> flintrans.FastLinearTransformation:
        """The int32 conversion of a u64 ``LinearTransformation``, made once."""
        hit = self._flt_cache.get(id(lt_obj))
        if hit is None:
            hit = (lt_obj, flintrans.convert_lintrans(self.params, lt_obj))
            self._flt_cache[id(lt_obj)] = hit
        return hit[1]

    def trace_log_n(self, ct: Ciphertext, log_n: int) -> Ciphertext:
        """The fast mirror of rlwe trace (core/rlwe/inner_sum.go:36-124), NTT
        domain only (the fast path never leaves it)."""
        if ct.degree != 1:
            raise ValueError("trace expects a degree-1 ciphertext")
        if not ct.metadata.is_ntt:
            raise ValueError("fast trace expects an NTT-domain ciphertext")
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
        if log_n == 0:
            els.append(params.nth_root - 1)
        for g in els:
            rot = self._automorphism(out, g)
            out = out.with_value((ring.add(out.value[0], rot.value[0]),
                                  ring.add(out.value[1], rot.value[1])))
        return out

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Centered lift q0 -> Q (bootstrap ModUp) in int32: q0 is one fast
        prime, so the lift is an exact sign-extended reduction a limb."""
        q0 = self.params.q[0]
        rq0 = self._ring(0)
        rq = self._ring(self.params.max_level)
        qq = rq.moduli[:, None]

        def centered_lift(coeff):
            neg = coeff >= (q0 >> 1)
            t = torch.remainder(torch.where(neg, q0 - coeff, coeff)[None, :], qq)
            return torch.where(neg[None, :], torch.where(t == 0, t, qq - t), t)

        return ct.with_value(tuple(rq.ntt(centered_lift(rq0.intt(v)[..., 0, :]))
                                   for v in ct.value))


def make_fast_evaluator(params, rlk, gks, rescale_limbs: int = 1) -> FastEvaluator:
    """A FastEvaluator from u64-path keys (converted once)."""
    return FastEvaluator(params, fckks.make_context(params, rlk, gks,
                                                    rescale_limbs=rescale_limbs))

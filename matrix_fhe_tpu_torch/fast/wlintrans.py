"""Wide-path double-hoisted BSGS diagonal-matrix multiplication.

Counterpart of ``matrix_fhe_tpu/fast/wlintrans.py``, the wide mirror of
``circuits/lintrans.py:_multiply_by_diag_matrix_bsgs`` (the reference's
lintrans_evaluator.go:256-430), and the same algorithm as
``fast/flintrans.py`` on 64-bit words: the ciphertext is decomposed once,
the baby-step rotations stay P-scaled in the (Q, P) basis, the plaintext
diagonals multiply-accumulate in QP, and each giant step costs one ModDown
and one key switch.  The core operator of CoeffsToSlots / SlotsToCoeffs on
the wide path; every NTT goes through kernel B4 on a CUDA ciphertext.

Products are plain a*b mod q, canonical at every op boundary, so each
output equals ``wide.unpack_pair`` of the JAX package's and the u64
evaluator's bit for bit on the same moduli and keys.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.circuits import lintrans as lt_mod
from matrix_fhe_tpu_torch.fast import wrns
from matrix_fhe_tpu_torch.fast.wckks import WideCKKSContext, decompose_ks, ks_mac


@dataclasses.dataclass(frozen=True)
class WideLinearTransformation:
    """Plain-domain word mirror of ``circuits/lintrans.LinearTransformation``."""
    n1: int
    log_dimensions: tuple[int, int]
    vec: dict[int, tuple[torch.Tensor, torch.Tensor]]  # int64 words (ptq, ptp)

    def bsgs_index(self):
        cols = 1 << self.log_dimensions[1]
        return lt_mod.bsgs_index(list(self.vec.keys()), cols, self.n1)


def convert_lintrans(params, lt: lt_mod.LinearTransformation) -> WideLinearTransformation:
    """u64 (Montgomery, NTT) encoded diagonals -> plain-domain words (the
    JAX package's conversion, without its packing), on the parameters'
    device."""
    uq, up = params.ring_q, params.ring_p
    vec = {k: (uq.at_level(ptq.shape[-2] - 1).imform(ptq), up.imform(ptp))
           for k, (ptq, ptp) in lt.vec.items()}
    return WideLinearTransformation(n1=lt.n1, log_dimensions=lt.log_dimensions, vec=vec)


def _p_mod_q(ctx: WideCKKSContext) -> list[int]:
    """(P mod q_i) per Q limb: the P-scaling of c0 and c1 in the lazy
    hoisted paths."""
    big_p = 1
    for p in ctx.ring_p.moduli_tuple:
        big_p *= p
    return [big_p % q for q in ctx.ring_q.moduli_tuple]


def _mul_acc(ring, pt, x, acc):
    """acc += pt * x mod q, canonical."""
    prod = ring.mul_coeffs_montgomery(pt, x)
    return prod if acc is None else ring.add(acc, prod)


def rotations_hoisted_lazy(ctx: WideCKKSContext, c0, c1, gal_els):
    """phi_g of the P-scaled key-switched ciphertext, in (Q, P), over one
    shared decomposition (AutomorphismHoistedLazy,
    core/rlwe/evaluator_automorphism.go:107-160).
    Returns {gal_el: ((r0q, r0p), (r1q, r1p))}."""
    rq = ctx.ring_q
    yq, yp = decompose_ks(ctx, c1)
    c0_p = rq.mul_scalar_montgomery(c0, _p_mod_q(ctx))
    out = {}
    for g in gal_els:
        gk_q, gk_p = ctx.galois_key(g)
        d_q, d_p = ks_mac(ctx, gk_q, gk_p, yq, yp)
        r0q = rq.add(d_q[0], c0_p)
        idx = ctx.galois_index(g)
        out[g] = ((r0q[..., idx], d_p[0][..., idx]), (d_q[1][..., idx], d_p[1][..., idx]))
    return out


def matvec_bsgs(ctx: WideCKKSContext, wlt: WideLinearTransformation, c0, c1, galois_element):
    """Double-hoisted BSGS diagonal-matrix multiply of an NTT-domain
    degree-1 ciphertext.  ``galois_element(k)`` maps a rotation amount to
    its galois element.  Returns (out0, out1) int64 words [LQ, N] at the input
    level (the caller rescales)."""
    rq, rp = ctx.ring_q, ctx.ring_p
    index, _, rot_n2 = wlt.bsgs_index()

    # hoisted P-scaled baby-step rotations (one decomposition)
    inner = [i for i in rot_n2 if i != 0]
    pre = rotations_hoisted_lazy(ctx, c0, c1, [galois_element(i) for i in inner])
    pre = {i: pre[galois_element(i)] for i in inner}

    p_sc = _p_mod_q(ctx)
    c0_p = rq.mul_scalar_montgomery(c0, p_sc)
    c1_p = rq.mul_scalar_montgomery(c1, p_sc)

    out = [None, None, None, None]  # out0q, out1q, out0p, out1p
    lq = rq.num_limbs
    for j in sorted(index.keys()):
        t0q = t1q = t0p = t1p = None
        for i in index[j]:
            ptq, ptp = wlt.vec[j + i]
            ptq = ptq[..., :lq, :]  # encoded at the top level, sliced to the live limbs
            if i == 0:
                t0q = _mul_acc(rq, ptq, c0_p, t0q)
                t1q = _mul_acc(rq, ptq, c1_p, t1q)
            else:
                (r0q, r0p), (r1q, r1p) = pre[i]
                t0q = _mul_acc(rq, ptq, r0q, t0q)
                t0p = _mul_acc(rp, ptp, r0p, t0p)
                t1q = _mul_acc(rq, ptq, r1q, t1q)
                t1p = _mul_acc(rp, ptp, r1p, t1p)
        if t0p is None:
            t0p = torch.zeros(c0.shape[:-2] + (rp.num_limbs, rq.n), dtype=torch.int64,
                              device=c0.device)
        if t1p is None:
            t1p = torch.zeros_like(t0p)

        if j != 0:
            t1 = wrns.mod_down(t1q, t1p, ctx.mdc, rq, rp, ntt=True)
            g = galois_element(j)
            gk_q, gk_p = ctx.galois_key(g)
            d_q, d_p = ks_mac(ctx, gk_q, gk_p, *decompose_ks(ctx, t1))
            idx = ctx.galois_index(g)
            d0q = rq.add(d_q[0], t0q)[..., idx]
            d0p = rp.add(d_p[0], t0p)[..., idx]
            d1q, d1p = d_q[1][..., idx], d_p[1][..., idx]
        else:
            d0q, d1q, d0p, d1p = t0q, t1q, t0p, t1p

        out[0] = d0q if out[0] is None else rq.add(out[0], d0q)
        out[1] = d1q if out[1] is None else rq.add(out[1], d1q)
        out[2] = d0p if out[2] is None else rp.add(out[2], d0p)
        out[3] = d1p if out[3] is None else rp.add(out[3], d1p)

    out0 = wrns.mod_down(out[0], out[2], ctx.mdc, rq, rp, ntt=True)
    out1 = wrns.mod_down(out[1], out[3], ctx.mdc, rq, rp, ntt=True)
    return out0, out1


def matvec_naive(ctx: WideCKKSContext, wlt: WideLinearTransformation, c0, c1, galois_element):
    """Naive single-hoisted diagonal loop (lintrans_evaluator.go:131-255, the
    n1 == 0 form): one shared decomposition, one lazy key-switched rotation
    a nonzero diagonal, one final ModDown."""
    rq, rp = ctx.ring_q, ctx.ring_p
    slots = 1 << wlt.log_dimensions[1]
    keys = sorted(wlt.vec.keys())
    state = bool(keys) and keys[0] == 0
    if state:
        keys = keys[1:]
    keys = [k & (slots - 1) for k in keys]
    gal = {k: galois_element(k) for k in keys}
    pre = rotations_hoisted_lazy(ctx, c0, c1, [gal[k] for k in keys]) if keys else {}

    acc = [None, None, None, None]  # out0q, out1q, out0p, out1p
    lq = rq.num_limbs
    for k in keys:
        (r0q, r0p), (r1q, r1p) = pre[gal[k]]
        ptq, ptp = wlt.vec[k]
        ptq = ptq[..., :lq, :]
        acc[0] = _mul_acc(rq, ptq, r0q, acc[0])
        acc[2] = _mul_acc(rp, ptp, r0p, acc[2])
        acc[1] = _mul_acc(rq, ptq, r1q, acc[1])
        acc[3] = _mul_acc(rp, ptp, r1p, acc[3])

    if acc[0] is None:
        out0, out1 = torch.zeros_like(c0), torch.zeros_like(c1)
    else:
        out0 = wrns.mod_down(acc[0], acc[2], ctx.mdc, rq, rp, ntt=True)
        out1 = wrns.mod_down(acc[1], acc[3], ctx.mdc, rq, rp, ntt=True)

    if state:
        ptq = wlt.vec[0][0][..., :lq, :]
        out0 = _mul_acc(rq, ptq, c0, out0)
        out1 = _mul_acc(rq, ptq, c1, out1)
    return out0, out1

"""Diagonal-form homomorphic linear transformations with BSGS double hoisting.

Counterpart of ``matrix_fhe_tpu/circuits/lintrans.py`` (the reference's
circuits/common/lintrans/) on the port's u64 path (64-bit words in int64):

  * ``Diagonals``: a matrix given by its non-zero diagonals (lintrans.go:84).
  * ``find_best_bsgs_ratio`` / ``bsgs_index``: the N1*N2 split optimizer
    (lintrans.go:321-380).
  * ``encode``: rotated-diagonal plaintexts over (Q, P) in NTT + Montgomery
    form (lintrans.go:205-300); the giant-step group j encodes diagonal j+i
    rotated right by j so the plaintext multiplies the *pre-rotated*
    ciphertext.
  * ``multiply_by_diag_matrix`` (naive single-hoisted loop,
    lintrans_evaluator.go:131-255) and ``multiply_by_diag_matrix_bsgs``
    (double-hoisted baby-step giant-step, lintrans_evaluator.go:256-430).

All functions are pure; scheme bindings supply an ``embed`` callable
(values, level_q, level_p, scale) -> (pt_q, pt_p) in NTT + Montgomery form.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.keys import GaloisKey
from matrix_fhe_tpu_torch.rlwe.params import Parameters


@dataclasses.dataclass
class LinearTransformationParameters:
    """lintrans.go:52-82 Parameters."""
    diagonals_index_list: list[int]
    level_q: int
    level_p: int
    scale: Fraction
    log_dimensions: tuple[int, int]
    log_bsgs_ratio: int = 0  # < 0 disables BSGS (naive O(n) rotations)


@dataclasses.dataclass
class LinearTransformation:
    """lintrans.go:125-137: encoded diagonal plaintexts + BSGS split."""
    scale: Fraction
    log_dimensions: tuple[int, int]
    n1: int  # 0 => naive evaluation
    level_q: int
    level_p: int
    vec: dict[int, tuple[torch.Tensor, torch.Tensor | None]]

    @property
    def cols(self) -> int:
        return 1 << self.log_dimensions[1]

    def bsgs_index(self):
        return bsgs_index(list(self.vec.keys()), self.cols, self.n1)


def find_best_bsgs_ratio(non_zero_diags, max_n: int, log_max_ratio: int) -> int:
    """FindBestBSGSRatio (lintrans.go:321-343)."""
    max_ratio = float(1 << log_max_ratio)
    n1 = 1
    while n1 < max_n:
        _, rot_n1, rot_n2 = bsgs_index(non_zero_diags, max_n, n1)
        nb_n1, nb_n2 = len(rot_n1) - 1, len(rot_n2) - 1
        if nb_n1 and nb_n2 / nb_n1 == max_ratio:
            return n1
        if nb_n1 and nb_n2 / nb_n1 > max_ratio:
            return n1 // 2
        n1 <<= 1
    return 1


def bsgs_index(non_zero_diags, slots: int, n1: int):
    """BSGSIndex (lintrans.go:344-380): diag rot -> (giant j, baby i)."""
    index: dict[int, list[int]] = {}
    rot_n1, rot_n2 = set(), set()
    for rot in non_zero_diags:
        rot &= slots - 1
        idx_n1 = ((rot // n1) * n1) & (slots - 1)
        idx_n2 = rot & (n1 - 1)
        index.setdefault(idx_n1, []).append(idx_n2)
        rot_n1.add(idx_n1)
        rot_n2.add(idx_n2)
    for k in index:
        index[k] = sorted(set(index[k]))
    return index, sorted(rot_n1), sorted(rot_n2)


def galois_elements(params: Parameters, diags, slots: int,
                    log_bsgs_ratio: int) -> list[int]:
    """GaloisElements (lintrans.go:302-320)."""
    if log_bsgs_ratio < 0:
        els = {params.galois_element(k & (slots - 1)) for k in diags}
    else:
        n1 = find_best_bsgs_ratio(diags, slots, log_bsgs_ratio)
        _, rot_n1, rot_n2 = bsgs_index(diags, slots, n1)
        els = {params.galois_element(k) for k in rot_n1 + rot_n2}
    els.discard(1)
    return sorted(els)


def encode(embed, diagonals: dict[int, np.ndarray],
           ltp: LinearTransformationParameters) -> LinearTransformation:
    """Encode (lintrans.go:205-282): rotated diagonals -> (Q, P) plaintexts.

    ``diagonals[i]`` is the length-``cols`` i-th diagonal (negative indices
    allowed, interpreted mod cols).  For the giant step j, diagonal j+i is
    encoded rotated left by ``-j mod cols`` (i.e. right by j) so it aligns
    with the ciphertext pre-rotated by the baby step i.
    """
    rows = 1 << ltp.log_dimensions[0]
    cols = 1 << ltp.log_dimensions[1]

    def diag_at(i):
        for cand in (i, i - cols, i + cols):
            if cand in diagonals:
                return np.asarray(diagonals[cand])
        raise KeyError(f"diagonal {i} does not exist")

    def rot_right(v, j):
        """Rotate each row of the [rows, cols] slot matrix right by j
        (rotateAndEncodeDiagonal, lintrans.go:283-300)."""
        if j == 0 or len(v) == cols:
            return np.roll(v, j)
        return np.roll(v.reshape(rows, cols), j, axis=1).reshape(-1)

    vec: dict[int, tuple] = {}
    if ltp.log_bsgs_ratio < 0:
        n1 = 0
        for i in ltp.diagonals_index_list:
            idx = i & (cols - 1)
            vec[idx] = embed(diag_at(i), ltp.level_q, ltp.level_p, ltp.scale)
    else:
        n1 = find_best_bsgs_ratio(ltp.diagonals_index_list, cols, ltp.log_bsgs_ratio)
        index, _, _ = bsgs_index(ltp.diagonals_index_list, cols, n1)
        for j in index:
            for i in index[j]:
                v = rot_right(diag_at(j + i), j)
                vec[j + i] = embed(v, ltp.level_q, ltp.level_p, ltp.scale)
    return LinearTransformation(scale=ltp.scale, log_dimensions=ltp.log_dimensions,
                                n1=n1, level_q=ltp.level_q, level_p=ltp.level_p,
                                vec=vec)


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------

def _slice_pt(pt, lq):
    ptq, ptp = pt
    return ptq[..., :lq + 1, :], ptp


def _at_level(ct: Ciphertext, level: int) -> Ciphertext:
    if ct.level == level:
        return ct
    return ct.with_value(tuple(v[..., :level + 1, :] for v in ct.value))


def evaluate(params: Parameters, ct: Ciphertext, lt: LinearTransformation,
             gks: dict[int, GaloisKey]) -> Ciphertext:
    ct = _at_level(ct, min(ct.level, lt.level_q))
    digits = rlwe_eval.decompose_ntt(params, ct.level, ct.value[1])
    return _evaluate_with_digits(params, ct, lt, gks, digits, {})


def evaluate_many(params: Parameters, ct: Ciphertext,
                  lts: list[LinearTransformation],
                  gks: dict[int, GaloisKey]) -> list[Ciphertext]:
    """EvaluateMany (lintrans_evaluator.go:18-69): one decomposition and one
    set of pre-rotations shared by all transforms."""
    level = min([ct.level] + [lt.level_q for lt in lts])
    ct = _at_level(ct, level)
    digits = rlwe_eval.decompose_ntt(params, level, ct.value[1])
    pre_rot_cache: dict[int, tuple] = {}
    return [_evaluate_with_digits(params, ct, lt, gks, digits, pre_rot_cache)
            for lt in lts]


def _evaluate_with_digits(params: Parameters, ct: Ciphertext,
                          lt: LinearTransformation, gks, digits,
                          pre_rot_cache) -> Ciphertext:
    ct = _at_level(ct, min(ct.level, lt.level_q))
    if lt.n1 == 0:
        out = _multiply_by_diag_matrix(params, ct, lt, gks, digits)
    else:
        out = _multiply_by_diag_matrix_bsgs(params, ct, lt, gks, digits,
                                            pre_rot_cache)
    return out.with_metadata(scale=ct.scale * lt.scale)


def _qp_mul_acc(rq, rp, pt, xq, xp, accq, accp):
    """acc += pt * (xq, xp) in Montgomery form."""
    pq = rq.mul_coeffs_montgomery(pt[0][..., :xq.shape[-2], :], xq)
    accq = pq if accq is None else rq.add(accq, pq)
    if rp is not None and xp is not None:
        pp = rp.mul_coeffs_montgomery(pt[1], xp)
        accp = pp if accp is None else rp.add(accp, pp)
    return accq, accp


def _multiply_by_diag_matrix(params: Parameters, ct: Ciphertext,
                             lt: LinearTransformation, gks, digits) -> Ciphertext:
    """Naive single-hoisted loop (lintrans_evaluator.go:131-255)."""
    level = min(ct.level, lt.level_q)
    rq = params.ring_q.at_level(level)
    rp = params.ring_p
    slots = lt.cols

    c0 = ct.value[0][..., :level + 1, :]
    c1 = ct.value[1][..., :level + 1, :]
    if rp is not None:
        c0_p = rq.mul_scalar_montgomery(c0, rlwe_eval.p_scalar_mform(params, level))
    else:
        c0_p = c0

    keys = sorted(lt.vec.keys())
    state = keys and keys[0] == 0
    if state:
        keys = keys[1:]

    acc = [None, None, None, None]  # out0q, out1q, out0p, out1p
    for k in keys:
        k &= slots - 1
        gal_el = params.galois_element(k)
        gk = gks[gal_el]
        d0q, d1q, d0p, d1p = rlwe_eval.gadget_product_hoisted_lazy(
            params, level, digits, gk.gadget)
        d0q = rq.add(d0q, c0_p)
        d0q = am.automorphism_ntt(rq, d0q, gal_el)
        d1q = am.automorphism_ntt(rq, d1q, gal_el)
        if rp is not None:
            d0p = am.automorphism_ntt(rp, d0p, gal_el)
            d1p = am.automorphism_ntt(rp, d1p, gal_el)
        pt = lt.vec[k]
        acc[0], acc[2] = _qp_mul_acc(rq, rp, pt, d0q, d0p, acc[0], acc[2])
        acc[1], acc[3] = _qp_mul_acc(rq, rp, pt, d1q, d1p, acc[1], acc[3])

    if acc[0] is None:
        out0 = torch.zeros_like(c0)
        out1 = torch.zeros_like(c1)
    else:
        out0 = rlwe_eval.mod_down_qp(params, level, acc[0], acc[2])
        out1 = rlwe_eval.mod_down_qp(params, level, acc[1], acc[3])

    if state:
        pt0 = lt.vec[0][0][..., :level + 1, :]
        out0 = rq.add(out0, rq.mul_coeffs_montgomery(pt0, c0))
        out1 = rq.add(out1, rq.mul_coeffs_montgomery(pt0, c1))
    return ct.with_value((out0, out1))


def _multiply_by_diag_matrix_bsgs(params: Parameters, ct: Ciphertext,
                                  lt: LinearTransformation, gks, digits,
                                  pre_rot_cache) -> Ciphertext:
    """Double-hoisted BSGS (lintrans_evaluator.go:256-430)."""
    level = min(ct.level, lt.level_q)
    rq = params.ring_q.at_level(level)
    rp = params.ring_p

    index, _, rot_n2 = lt.bsgs_index()

    # Pre-rotations (PreRotatedCiphertextForDiagonalMatrixMultiplication):
    # phi_i of the P-scaled key-switched ciphertext, in (Q, P).
    for i in rot_n2:
        if i != 0 and (i, level) not in pre_rot_cache:
            gk = gks[params.galois_element(i)]
            pre_rot_cache[(i, level)] = rlwe_eval.automorphism_hoisted_lazy(
                params, ct, digits, gk)

    c0 = ct.value[0][..., :level + 1, :]
    c1 = ct.value[1][..., :level + 1, :]
    if rp is not None:
        p_sc = rlwe_eval.p_scalar_mform(params, level)
        c0_p = rq.mul_scalar_montgomery(c0, p_sc)
        c1_p = rq.mul_scalar_montgomery(c1, p_sc)
    else:
        c0_p, c1_p = c0, c1

    out = [None, None, None, None]  # out0q, out1q, out0p, out1p
    for j in sorted(index.keys()):
        t0q = t1q = t0p = t1p = None
        for i in index[j]:
            pt = lt.vec[j + i]
            if i == 0:
                t0q, t0p = _qp_mul_acc(rq, None, pt, c0_p, None, t0q, t0p)
                t1q, t1p = _qp_mul_acc(rq, None, pt, c1_p, None, t1q, t1p)
            else:
                (r0q, r0p), (r1q, r1p) = pre_rot_cache[(i, level)]
                t0q, t0p = _qp_mul_acc(rq, rp, pt, r0q, r0p, t0q, t0p)
                t1q, t1p = _qp_mul_acc(rq, rp, pt, r1q, r1p, t1q, t1p)
        if rp is not None and t0p is None:
            t0p = torch.zeros(c0.shape[:-2] + (len(params.p), params.n),
                              dtype=torch.int64, device=c0.device)
        if rp is not None and t1p is None:
            t1p = torch.zeros_like(t0p)

        if j != 0:
            # ModDown the c1 accumulator, key-switch by the giant step.
            t1 = rlwe_eval.mod_down_qp(params, level, t1q, t1p)
            gal_el = params.galois_element(j)
            gk = gks[gal_el]
            d = rlwe_eval.gadget_product_hoisted_lazy(
                params, level, rlwe_eval.decompose_ntt(params, level, t1),
                gk.gadget)
            d0q = rq.add(d[0], t0q)
            d0p = d[2] if rp is None else rp.add(d[2], t0p)
            d1q, d1p = d[1], d[3]
            d0q = am.automorphism_ntt(rq, d0q, gal_el)
            d1q = am.automorphism_ntt(rq, d1q, gal_el)
            if rp is not None:
                d0p = am.automorphism_ntt(rp, d0p, gal_el)
                d1p = am.automorphism_ntt(rp, d1p, gal_el)
        else:
            d0q, d1q, d0p, d1p = t0q, t1q, t0p, t1p

        out[0] = d0q if out[0] is None else rq.add(out[0], d0q)
        out[1] = d1q if out[1] is None else rq.add(out[1], d1q)
        if rp is not None:
            out[2] = d0p if out[2] is None else rp.add(out[2], d0p)
            out[3] = d1p if out[3] is None else rp.add(out[3], d1p)

    out0 = rlwe_eval.mod_down_qp(params, level, out[0], out[2])
    out1 = rlwe_eval.mod_down_qp(params, level, out[1], out[3])
    return ct.with_value((out0, out1))

"""Fast-path RNS meta-operations: rescale, basis extension, decomposition.

Counterpart of ``matrix_fhe_tpu/fast/frns.py`` (which mirrors the
reference's ring/scaling.go and ring/basis_extension.go).  Outputs are
canonical and equal the JAX package's bit for bit.  Sums of products run in
int64 (below 2^52 for <= 40 limbs); the float64 ``v``-correction of the
approximate base extension keeps the reference's order of accumulation and
divides by each q_i (basis_extension.go:550-594).

All polynomials are int32 [..., L, N], canonical in [0, q).  The ``gen_*``
constructors put their constants on the card unless asked for another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.fast.fring import FastRing, mulmod
from matrix_fhe_tpu_torch.utils.device import constant, resolve_device


def _i32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.int64).astype(np.int32),
                           device=device)


# ---------------------------------------------------------------------------
# Rescaling (ring/scaling.go).
# ---------------------------------------------------------------------------

def _red_to(v: torch.Tensor, ring: FastRing) -> torch.Tensor:
    """Non-negative values into [0, q) per limb of ``ring``."""
    return torch.remainder(v, ring.moduli[:, None])


def div_round_by_last_modulus(ring: FastRing, p: torch.Tensor) -> torch.Tensor:
    """Rounded coeff-domain rescale [.., L, N] -> [.., L-1, N]
    (scaling.go:111-126): out_i = (x_i + h - t) * q_l^-1 mod q_i."""
    lvl = p.shape[-2] - 1
    ql = ring.moduli_tuple[lvl]
    h = (ql - 1) >> 1
    t = p[..., lvl:lvl + 1, :] + h
    t = torch.where(t >= ql, t - ql, t)  # (x_l + h) mod q_l

    sub = ring.at_level(lvl - 1)
    q = sub.moduli[:, None]
    t_red = _red_to(t, sub)
    h_mod = constant([h % m for m in ring.moduli_tuple[:lvl]], torch.int32, ring.device)[:, None]
    qlinv = [pow(ql, -1, m) for m in ring.moduli_tuple[:lvl]]
    acc = p[..., :lvl, :] + h_mod + (2 * q - t_red)  # [0, 4q)
    return sub.mul_scalar_montgomery(torch.remainder(acc, q), qlinv)


def div_round_by_last_modulus_many_ntt(ring: FastRing, p: torch.Tensor,
                                       nb: int) -> torch.Tensor:
    """NTT-domain rounded rescale dropping ``nb`` limbs
    (DivRoundByLastModulusManyNTT, scaling.go:130-162)."""
    if nb == 0:
        return p
    L = p.shape[-2]
    x = ring.at_level(L - 1).intt(p)
    for k in range(nb):
        x = div_round_by_last_modulus(ring.at_level(L - 1 - k), x)
    return ring.at_level(L - 1 - nb).ntt(x)


# ---------------------------------------------------------------------------
# Basis extension (basis_extension.go).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FastModUpConstants:
    qoverqi_inv_qi: torch.Tensor  # int32 [LQ]     (Q/qi)^-1 mod qi
    qoverqi_mod_p: torch.Tensor   # int64 [LP, LQ] Q/qi mod pj
    negq_mod_p: torch.Tensor      # int64 [LP]     (-Q) mod pj
    qhalf_mod_qi: torch.Tensor    # int32 [LQ]     (Q>>1) mod qi
    qhalf_mod_p: torch.Tensor     # int32 [LP]     (Q>>1) mod pj
    src_q_f64: torch.Tensor       # f64 [LQ]       qi, the divisors of v


def gen_fast_modup_constants(Q: list[int], P: list[int], device="cuda"
                             ) -> FastModUpConstants:
    device = resolve_device(device)
    big_q = 1
    for q in Q:
        big_q *= q
    qhalf = big_q >> 1
    inv = [pow(big_q // qi % qi, qi - 2, qi) for qi in Q]
    mod_p = [[big_q // qi % pj for qi in Q] for pj in P]
    return FastModUpConstants(
        qoverqi_inv_qi=_i32(inv, device),
        qoverqi_mod_p=torch.tensor(mod_p, dtype=torch.int64, device=device),
        negq_mod_p=torch.tensor([(p - big_q % p) % p for p in P],
                                dtype=torch.int64, device=device),
        qhalf_mod_qi=_i32([qhalf % q for q in Q], device),
        qhalf_mod_p=_i32([qhalf % p for p in P], device),
        src_q_f64=torch.tensor(Q, dtype=torch.float64, device=device),
    )


def mod_up(x: torch.Tensor, muc: FastModUpConstants, src: FastRing,
           dst: FastRing, centered: bool = True) -> torch.Tensor:
    """ModUpExact (basis_extension.go:282-308): x [.., LQ, N] -> [.., LP, N]."""
    LQ = x.shape[-2]
    sq = src.moduli[:, None]
    if centered:
        t = x + muc.qhalf_mod_qi[:, None]
        x = torch.where(t >= sq, t - sq, t)
    y = mulmod(x, muc.qoverqi_inv_qi[:, None], sq)

    # v = floor(sum_i y_i / q_i): float64, accumulated in the reference's
    # order.  Each divisor is a tensor on y's device, so the division is a
    # true IEEE division (a CPU scalar divisor lets CUDA multiply by its
    # reciprocal instead, which may differ in the last bit).
    vf = torch.zeros(y.shape[:-2] + y.shape[-1:], dtype=torch.float64,
                     device=y.device)
    for i in range(LQ):
        vf = vf + y[..., i, :].to(torch.float64) / muc.src_q_f64[i]
    v = vf.to(torch.int64)  # truncation toward zero; v >= 0

    dq = dst.moduli[:, None].to(torch.int64)
    # sum_i y_i * (Q/q_i mod p_j): LQ products < 2^46, exact in int64
    acc = (y.to(torch.int64)[..., None, :, :]
           * muc.qoverqi_mod_p[:, :, None]).sum(dim=-2, dtype=torch.int64)
    out = torch.remainder(acc + v[..., None, :] * muc.negq_mod_p[:, None], dq)
    out = out.to(torch.int32)
    if centered:
        out = out - muc.qhalf_mod_p[:, None]
        out = torch.where(out < 0, out + dst.moduli[:, None], out)
    return out


@dataclasses.dataclass(frozen=True)
class FastModDownConstants:
    modup_p_to_q: FastModUpConstants
    pinv_mod_q: torch.Tensor  # int32 [LQ]  P^-1 mod qi


def gen_fast_moddown_constants(Q: list[int], P: list[int], device="cuda"
                               ) -> FastModDownConstants:
    device = resolve_device(device)
    const = []
    for qi in Q:
        acc = 1
        for pj in P:
            acc = acc * pow(pj, qi - 2, qi) % qi
        const.append(acc)
    return FastModDownConstants(
        modup_p_to_q=gen_fast_modup_constants(P, Q, device),
        pinv_mod_q=_i32(const, device),
    )


def mod_down(xq: torch.Tensor, xp: torch.Tensor, mdc: FastModDownConstants,
             ring_q: FastRing, ring_p: FastRing, ntt: bool = False
             ) -> torch.Tensor:
    """ModDownQPtoQ[NTT] (basis_extension.go:219-258):
    out = (xq - ModUp_{P->Q}(xp)) * P^-1 mod q_i."""
    if ntt:
        xp = ring_p.intt(xp)
    lift = mod_up(xp, mdc.modup_p_to_q, ring_p, ring_q, centered=True)
    if ntt:
        lift = ring_q.ntt(lift)
    diff = ring_q.sub(xq, lift)
    return ring_q.mul_scalar_montgomery(diff, mdc.pinv_mod_q)


# ---------------------------------------------------------------------------
# Hybrid key-switching digit decomposer (basis_extension.go:310-502).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FastDecomposer:
    mucs: tuple[FastModUpConstants | None, ...]
    alpha: int
    num_digits: int
    lq: int
    lp: int


def gen_fast_decomposer(Q: list[int], P: list[int], device="cuda"
                        ) -> FastDecomposer:
    device = resolve_device(device)
    alpha = len(P)
    nd = -(-len(Q) // alpha)
    mucs = []
    for i in range(nd):
        qd = Q[i * alpha: min((i + 1) * alpha, len(Q))]
        mucs.append(None if len(qd) == 1
                    else gen_fast_modup_constants(qd, list(Q) + list(P), device))
    return FastDecomposer(mucs=tuple(mucs), alpha=alpha, num_digits=nd,
                          lq=len(Q), lp=len(P))


def _lift_digit_coeff(dec: FastDecomposer, digit: int, x_inv_ntt: torch.Tensor,
                      ring_q: FastRing, ring_p: FastRing
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coefficient-domain lift of hybrid digit ``digit`` to bases Q and P
    (the per-digit body of DecomposeSingleNTT,
    core/rlwe/evaluator_gadget_product.go:455-480): a single-limb digit is
    centered and sign-extended directly, a multi-limb digit goes through the
    approximate ModUp."""
    lq = x_inv_ntt.shape[-2]
    start = digit * dec.alpha
    end = min(start + dec.alpha, lq)
    muc = dec.mucs[digit]

    if muc is None or end - start == 1:
        c = x_inv_ntt[..., start:end, :]
        q_src = ring_q.moduli_tuple[start]
        neg = c >= (q_src >> 1)
        mag = torch.where(neg, q_src - c, c)
        qq = ring_q.moduli[:, None]
        tq = _red_to(mag, ring_q)
        yq = torch.where(neg & (tq != 0), qq - tq, tq)
        pp = ring_p.moduli[:, None]
        tp = _red_to(mag, ring_p)
        yp = torch.where(neg & (tp != 0), pp - tp, tp)
    else:
        both = mod_up(x_inv_ntt[..., start:end, :], muc,
                      ring_q.limbs(start, end), _concat_rings(ring_q, ring_p),
                      centered=True)
        yq, yp = both[..., :lq, :], both[..., lq:, :]
    return yq, yp


def decompose_single_ntt(dec: FastDecomposer, digit: int, x_ntt: torch.Tensor,
                         x_inv_ntt: torch.Tensor, ring_q: FastRing,
                         ring_p: FastRing) -> tuple[torch.Tensor, torch.Tensor]:
    """DecomposeSingleNTT (core/rlwe/evaluator_gadget_product.go:455-480)."""
    lq = x_ntt.shape[-2]
    start = digit * dec.alpha
    end = min(start + dec.alpha, lq)
    yq, yp = _lift_digit_coeff(dec, digit, x_inv_ntt, ring_q, ring_p)
    yq = ring_q.ntt(yq)
    yq = torch.cat(
        [yq[..., :start, :], x_ntt[..., start:end, :], yq[..., end:, :]], dim=-2)
    return yq, ring_p.ntt(yp)


def decompose_all_coeff(dec: FastDecomposer, x_inv_ntt: torch.Tensor,
                        ring_q: FastRing, ring_p: FastRing
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """All hybrid digits, coefficient domain, stacked for one batched NTT:
    (yq [D, LQ, N], yp [D, LP, N]).  The same per-digit math as
    ``decompose_single_ntt`` without the NTT and the splice, which the caller
    does once for all digits."""
    lifts = [_lift_digit_coeff(dec, d, x_inv_ntt, ring_q, ring_p)
             for d in range(dec.num_digits)]
    return (torch.stack([yq for yq, _ in lifts], dim=-3),
            torch.stack([yp for _, yp in lifts], dim=-3))


def _concat_rings(rq: FastRing, rp: FastRing) -> FastRing:
    """Moduli-only concatenation (no NTT tables; a mod_up destination)."""
    return FastRing(n=rq.n, moduli_tuple=rq.moduli_tuple + rp.moduli_tuple,
                    moduli=torch.cat([rq.moduli, rp.moduli]), tables=None)

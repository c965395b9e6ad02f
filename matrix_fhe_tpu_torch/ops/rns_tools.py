"""RNS meta-operations on the u64 path: rescaling, basis extension, digits.

Counterpart of ``matrix_fhe_tpu/ops/rns_tools.py`` (the reference's
ring/scaling.go and ring/basis_extension.go), with the same value
semantics at fully-reduced op boundaries:

  * div_floor_by_last_modulus:  out_i = q_l^{-1} (x_i - x_l)  mod q_i
  * div_round_by_last_modulus:  out_i = q_l^{-1} (x_i + h - t) mod q_i,
                                h = (q_l-1)/2, t = (x_l + h) mod q_l
  * mod_up (Q->P):              y_i = x_i (Q/q_i)^{-1} mod q_i,
                                v   = floor(sum_i y_i / q_i)   [float64],
                                out_j = sum_i y_i (Q/q_i) - v Q  mod p_j
  * mod_down (QP->Q):           out = (xQ - mod_up_{P->Q}(xP)) P^{-1} mod q_i
  * decompose digit j:          centered ModUp of Q-limb block j to all
                                other limbs of (Q, P)

The v correction is the reference's ordered float64 sum of y_i / q_i
(basis_extension.go:504-594), truncated: the sum runs in that order, one
term at a time, never as one reassociated ``sum()``, and each divisor is a
tensor on the operand's device so the division is a true IEEE division (a
CPU scalar divisor lets CUDA multiply by its reciprocal instead).

Constants are int64 tensors of residues; ``gen_*`` put them on the card
unless told otherwise.  The moduli are below 2^61 on the u64 path and below
2^61 + 2^55 on the wide one (``fast/wrns.py``); every lazy value formed
here is a sum of at most four words below 2^61 + 2^55, so below 2^64, and
goes only into a Montgomery product by a canonical constant (any 64-bit x
times y < q stays below q 2^64: the output is in [0, 2q)) or a Barrett
reduction, both of which read it unsigned.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops.rings import Ring
from matrix_fhe_tpu_torch.utils.device import constant, resolve_device


def _t(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Rescaling (ring/scaling.go).
# ---------------------------------------------------------------------------

def _rescale_row(ring: Ring, level: int) -> torch.Tensor:
    """MForm(-q_level^{-1} mod q_i) for i < level (ring/ring.go:363)."""
    return ring.rescale[level - 1, :level]


def div_floor_by_last_modulus(ring: Ring, p: torch.Tensor) -> torch.Tensor:
    """Coefficient domain; [.., L, N] -> [.., L-1, N]."""
    lvl = p.shape[-2] - 1
    c = _rescale_row(ring, lvl)[:, None]
    q, qinv = ring.moduli[:lvl, None], ring.qinv[:lvl, None]
    # (x_l - x_i) * MForm(-ql^{-1}) = (x_i - x_l) ql^{-1} mod q_i; the sum
    # < ql + 2 q_i < 2^64
    return mm.mred(p[..., lvl:lvl + 1, :] + 2 * q - p[..., :lvl, :], c, q, qinv)


def _half_mod(ring: Ring, lvl: int, p_half: int) -> torch.Tensor:
    return constant([p_half % m for m in ring.moduli_tuple[:lvl]], torch.int64,
                    ring.device)[:, None]


def div_round_by_last_modulus(ring: Ring, p: torch.Tensor) -> torch.Tensor:
    """Coefficient-domain rounded rescale; [.., L, N] -> [.., L-1, N]."""
    lvl = p.shape[-2] - 1
    ql = ring.moduli_tuple[lvl]
    p_half = (ql - 1) >> 1
    t = mm.cred(p[..., lvl:lvl + 1, :] + p_half, ql)
    q, qinv = ring.moduli[:lvl, None], ring.qinv[:lvl, None]
    c = _rescale_row(ring, lvl)[:, None]
    # out = -(t - h - x_i) * ql^{-1} = (x_i + h - t) ql^{-1} mod q_i;
    # acc < ql + 3 q_i < 2^64
    acc = t + (q - _half_mod(ring, lvl, p_half)) + (2 * q - p[..., :lvl, :])
    return mm.mred(acc, c, q, qinv)


def div_round_by_last_modulus_ntt(ring: Ring, p: torch.Tensor) -> torch.Tensor:
    """NTT-domain rounded rescale (scaling.go:91-109): INTT the last limb,
    lift it to the other limbs, NTT back, combine."""
    lvl = p.shape[-2] - 1
    coeff = ring.limbs(lvl, lvl + 1).intt(p[..., lvl:lvl + 1, :])
    ql = ring.moduli_tuple[lvl]
    p_half = (ql - 1) >> 1
    t = mm.cred(coeff + p_half, ql)  # [.., 1, N]
    sub = ring.at_level(lvl - 1)
    q = sub.moduli[:, None]
    lifted = mm.bred_add(t + (q - _half_mod(ring, lvl, p_half)), q, sub.bhi[:, None])
    lifted = sub.ntt(lifted)
    c = _rescale_row(ring, lvl)[:, None]
    return mm.mred(lifted + (2 * q - p[..., :lvl, :]), c, q, sub.qinv[:, None])


def div_by_last_modulus_many(ring: Ring, p: torch.Tensor, nb: int,
                             rounded: bool = True, ntt: bool = False) -> torch.Tensor:
    """DivFloor/DivRoundByLastModulusMany[NTT] (scaling.go:30-192)."""
    if nb == 0:
        return p
    L = p.shape[-2]
    div = div_round_by_last_modulus if rounded else div_floor_by_last_modulus
    if ntt:
        if nb == 1 and rounded:
            return div_round_by_last_modulus_ntt(ring, p)
        x = ring.at_level(L - 1).intt(p)
        for k in range(nb):
            x = div(ring.at_level(L - 1 - k), x)
        return ring.at_level(L - 1 - nb).ntt(x)
    x = p
    for k in range(nb):
        x = div(ring.at_level(L - 1 - k), x)
    return x


# ---------------------------------------------------------------------------
# Basis extension (ring/basis_extension.go).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModUpConstants:
    """GenModUpConstants (basis_extension.go:92-164), Montgomery form."""
    qoverqi_inv_qi: torch.Tensor   # [LQ]      MForm((Q/qi)^-1 mod qi)
    qoverqi_mod_p: torch.Tensor    # [LP, LQ]  MForm(Q/qi mod pj)
    vtimesq_mod_p: torch.Tensor    # [LP, LQ+1] (-v*Q) mod pj
    qhalf_mod_qi: torch.Tensor     # [LQ]      (Q>>1) mod qi  (centering)
    qhalf_mod_p: torch.Tensor      # [LP]      (Q>>1) mod pj
    src_q_f64: torch.Tensor        # f64 [LQ]  qi, the divisors of v


def gen_modup_constants(Q: list[int], P: list[int], device="cuda") -> ModUpConstants:
    device = resolve_device(device)
    LQ = len(Q)
    big_q = 1
    for q in Q:
        big_q *= q
    qhalf = big_q >> 1
    inv = [(pow(big_q // qi % qi, qi - 2, qi) << 64) % qi for qi in Q]
    mod_p = [[((big_q // qi % pj) << 64) % pj for qi in Q] for pj in P]
    vq = []
    for pj in P:
        v = (pj - big_q % pj) % pj
        row = [0]
        for _ in range(LQ):
            row.append((row[-1] + v) % pj)
        vq.append(row)
    return ModUpConstants(
        qoverqi_inv_qi=_t(inv, device), qoverqi_mod_p=_t(mod_p, device),
        vtimesq_mod_p=_t(vq, device),
        qhalf_mod_qi=_t([qhalf % q for q in Q], device),
        qhalf_mod_p=_t([qhalf % p for p in P], device),
        src_q_f64=torch.tensor(Q, dtype=torch.float64, device=device))


def _mod_up_core(x: torch.Tensor, muc: ModUpConstants, src_q, src_qinv,
                 dst_q, dst_qinv, dst_bhi, centered: bool) -> torch.Tensor:
    """ModUpExact (basis_extension.go:282-308): x [.., LQ, N] -> [.., LP, N]."""
    LQ = x.shape[-2]
    if centered:
        x = mm.cred(x + muc.qhalf_mod_qi[:, None], src_q[:, None])
    y = mm.mred(x, muc.qoverqi_inv_qi[:, None], src_q[:, None], src_qinv[:, None])

    # v = floor(sum_i y_i / q_i): ordered float64 accumulation
    # (basis_extension.go:550-594)
    vf = torch.zeros(y.shape[:-2] + y.shape[-1:], dtype=torch.float64, device=y.device)
    for i in range(LQ):
        vf = vf + y[..., i, :].to(torch.float64) / muc.src_q_f64[i]
    v = vf.to(torch.int64)  # truncation toward zero, as Go's uint64(float64)

    # out_j = MRed(sum_i y_i * MForm(Q/qi mod pj)) + (-vQ mod pj): a 128-bit
    # sum, then one Montgomery reduction (basis_extension.go:597-673 multSum).
    # Its high word is below LQ max(qi) pj / 2^64, under pj while
    # LQ max(qi) < 2^64 (8 source limbs below 2^61, 7 up to 2^61 + 2^55);
    # beyond, `out` only passes [0, 3p) below, and bred_add takes any 64-bit
    # word
    lp = muc.qoverqi_mod_p.shape[0]
    hi = y.new_zeros(y.shape[:-2] + (lp, y.shape[-1]))
    lo = torch.zeros_like(hi)
    for i in range(LQ):
        phi, plo = mm.mul64_hi_lo(y[..., i:i + 1, :], muc.qoverqi_mod_p[:, i][:, None])
        lo, carry = mm.add64_carry(lo, plo)
        hi = hi + phi + carry
    dq = dst_q[:, None]
    red = mm.mul64_hi(lo * dst_qinv[:, None], dq)
    out = hi - red + dq  # [0, 2p)
    out = out + torch.movedim(muc.vtimesq_mod_p[:, v], 0, -2)  # [0, 3p)
    out = mm.bred_add(out, dq, dst_bhi[:, None])
    if centered:
        out = mm.cred(out + (dq - muc.qhalf_mod_p[:, None]), dq)
    return out


def mod_up(x: torch.Tensor, muc: ModUpConstants, src: Ring, dst: Ring,
           centered: bool = True) -> torch.Tensor:
    """ModUpQtoP with the reference's centering wrapper
    (basis_extension.go:185-217): exact signed-lift basis extension."""
    return _mod_up_core(x, muc, src.moduli, src.qinv, dst.moduli, dst.qinv,
                        dst.bhi, centered)


@dataclasses.dataclass(frozen=True)
class ModDownConstants:
    modup_p_to_q: ModUpConstants
    moddown_const: torch.Tensor  # [LQ] MForm(P^{-1} mod qi) (basis_extension.go:25-49)


def gen_moddown_constants(Q: list[int], P: list[int], device="cuda") -> ModDownConstants:
    device = resolve_device(device)
    const = []
    for qi in Q:
        acc = 1
        for pj in P:
            acc = acc * pow(pj, qi - 2, qi) % qi
        const.append((acc << 64) % qi)
    return ModDownConstants(modup_p_to_q=gen_modup_constants(P, Q, device),
                            moddown_const=_t(const, device))


def mod_down(xq: torch.Tensor, xp: torch.Tensor, mdc: ModDownConstants,
             ring_q: Ring, ring_p: Ring, ntt: bool = False) -> torch.Tensor:
    """ModDownQPtoQ[NTT] (basis_extension.go:219-258):
    out = (xq - ModUp_{P->Q}(xp)) * P^{-1} mod q_i (rounded division by P)."""
    if ntt:
        xp = ring_p.intt(xp)
    lift = mod_up(xp, mdc.modup_p_to_q, ring_p, ring_q, centered=True)
    if ntt:
        lift = ring_q.ntt(lift)
    q, qinv = ring_q.moduli[:, None], ring_q.qinv[:, None]
    return mm.mred(xq + 2 * q - lift, mdc.moddown_const[:, None], q, qinv)


# ---------------------------------------------------------------------------
# Hybrid key-switching digit decomposer (basis_extension.go:310-502).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decomposer:
    """Per-digit ModUp constants of the RNS digit decomposition of hybrid
    key switching: digit i = centered lift of Q-limb block
    [i*alpha, (i+1)*alpha) to the full (Q, P) basis."""
    mucs: tuple[ModUpConstants | None, ...]  # None: single-limb signed lift
    alpha: int
    num_digits: int
    lq: int
    lp: int


def gen_decomposer(Q: list[int], P: list[int], device="cuda") -> Decomposer:
    device = resolve_device(device)
    # P-less parameter sets (levelP = -1): one single-limb digit per Q prime
    # (BaseRNSDecompositionVectorSize, core/rlwe/params.go:635-642)
    alpha = max(len(P), 1)
    nd = -(-len(Q) // alpha)
    mucs = []
    for i in range(nd):
        qd = Q[i * alpha: min((i + 1) * alpha, len(Q))]
        mucs.append(None if len(qd) == 1
                    else gen_modup_constants(qd, list(Q) + list(P), device))
    return Decomposer(mucs=tuple(mucs), alpha=alpha, num_digits=nd,
                      lq=len(Q), lp=len(P))


def decompose_single_ntt(dec: Decomposer, digit: int, x_ntt: torch.Tensor,
                         x_inv_ntt: torch.Tensor, ring_q: Ring,
                         ring_p: Ring | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """DecomposeSingleNTT (core/rlwe/evaluator_gadget_product.go:455-480):
    digit ``digit`` of x in the NTT domain over (Q, P).  ``x_ntt`` and
    ``x_inv_ntt`` are the same [LQ, N] polynomial in and out of the NTT
    domain; the digit's own limbs are copied from ``x_ntt``."""
    lq = x_ntt.shape[-2]
    start = digit * dec.alpha
    end = min(start + dec.alpha, lq)
    muc = dec.mucs[digit]

    if muc is None or end - start == 1:
        # single-limb digit: exact signed lift, coeff >= q_src >> 1 negative
        # (basis_extension.go:402-436)
        c = x_inv_ntt[..., start:end, :]
        q_src = ring_q.moduli_tuple[start]
        neg = c >= (q_src >> 1)
        mag = torch.where(neg, q_src - c, c)
        qq = ring_q.moduli[:, None]
        tq = mm.bred_add(mag, qq, ring_q.bhi[:, None])
        yq = torch.where(neg, mm.cred(qq - tq, qq), tq)
        if ring_p is None:  # P-less key switch (levelP = -1)
            yq = ring_q.ntt(yq)
            return torch.cat([yq[..., :start, :], x_ntt[..., start:end, :],
                              yq[..., end:, :]], dim=-2), None
        pp = ring_p.moduli[:, None]
        tp = mm.bred_add(mag, pp, ring_p.bhi[:, None])
        yp = torch.where(neg, mm.cred(pp - tp, pp), tp)
    else:
        both = _mod_up_core(
            x_inv_ntt[..., start:end, :], muc, ring_q.moduli[start:end],
            ring_q.qinv[start:end], torch.cat([ring_q.moduli, ring_p.moduli]),
            torch.cat([ring_q.qinv, ring_p.qinv]),
            torch.cat([ring_q.bhi, ring_p.bhi]), centered=True)
        yq, yp = both[..., :lq, :], both[..., lq:lq + ring_p.num_limbs, :]

    yq = ring_q.ntt(yq)
    # the digit's own limbs: the NTT-domain original (no INTT/NTT round trip)
    yq = torch.cat([yq[..., :start, :], x_ntt[..., start:end, :], yq[..., end:, :]],
                   dim=-2)
    return yq, ring_p.ntt(yp)

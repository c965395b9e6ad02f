"""Limb-sharded ct-mult + relin + rescale with explicit collectives.

Counterpart of ``matrix_fhe_tpu/parallel/fast_sharded.py``: the int32
fast-path step (``fast/fckks.py:mul_relin_rescale``) partitioned over the
RNS limb axis of a mesh (SURVEY.md section 2.8), every cross-limb exchange
an explicit, counted collective of ``parallel/api.py``.  Each rank holds
L/k limbs; the schedule, per rank:

  1. the tensor product (limb-local);
  2. INTT of the degree-2 part on the local limbs, then ONE ``all_gather``
     of those rows: every digit's source band reaches every rank;
  3. the per-digit lifts, local: the exact centered spread for a width-1
     band, ``frns.mod_up`` to (this rank's Q rows, all P rows) for a band of
     alpha > 1 limbs (the destination-row constants sliced to this rank);
  4. the NTTs, the in-band substitution of the NTT-domain source limbs, the
     MACs against the key rows of this rank, and ModDown with the P lift
     replicated on every rank (its destination Q rows local);
  5. the rescale: INTT, then for each dropped limb ONE ``psum`` over the
     two stacked polys broadcasts its centered value from the owner rank;
     NTT.

So a call costs 1 all-gather + ``rescale_limbs`` psums, for any num_p.  The
output keeps the full [.., L/k, N] block of each rank with the dropped
limbs zeroed; gathered over the ranks its live rows equal the unsharded
step bit for bit.  A batch is a leading dim, which every op broadcasts
over.  Each ring NTT of the local limbs and of the P ring runs on kernel B1
on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.fast import fckks, frns
from matrix_fhe_tpu_torch.fast.fring import mulmod
from matrix_fhe_tpu_torch.parallel import api


def _rows(muc: frns.FastModUpConstants, rows: list[int]) -> frns.FastModUpConstants:
    """The constants of a ModUp to the destination rows ``rows`` alone."""
    idx = torch.tensor(rows, dtype=torch.int64, device=muc.negq_mod_p.device)
    return dataclasses.replace(muc, qoverqi_mod_p=muc.qoverqi_mod_p[idx],
                               negq_mod_p=muc.negq_mod_p[idx],
                               qhalf_mod_p=muc.qhalf_mod_p[idx])


def build_sharded_step(ctx: fckks.FastCKKSContext, mesh: api.Mesh, axis: str = "limb"):
    """The limb-sharded step over ``mesh`` for this rank: ``fn(c0, c1, d0,
    d1) -> (o0, o1)`` on this rank's blocks [L/k, N] or [B, L/k, N] (rows
    idx * L/k .. of the whole operands), NTT domain.  ``ctx`` is the whole
    context on this rank's device; the rank keeps its rows of it."""
    k = mesh.shape[axis]
    idx = mesh.index(axis)
    rq, rp = ctx.ring_q, ctx.ring_p
    L, LP = rq.num_limbs, rp.num_limbs
    if L % k:
        raise ValueError(f"L={L} not divisible by mesh axis {k}")
    lloc = L // k
    lo, hi = idx * lloc, (idx + 1) * lloc
    dev = rq.device
    dec = ctx.dec
    alpha, D, nb = dec.alpha, dec.num_digits, ctx.rescale_limbs
    Q = list(rq.moduli_tuple)
    widths = [min((d + 1) * alpha, L) - d * alpha for d in range(D)]

    # this rank's rows of everything that has a Q-limb axis
    ring_l = rq.limbs(lo, hi)
    ctx_l = dataclasses.replace(ctx, ring_q=ring_l, rlk_q=ctx.rlk_q[:, :, lo:hi].contiguous())
    dst_rows = list(range(lo, hi)) + list(range(L, L + LP))
    mucs = [None if w == 1 else _rows(dec.mucs[d], dst_rows) for d, w in enumerate(widths)]
    srcs = [dataclasses.replace(rq.limbs(d * alpha, d * alpha + w), tables=None)
            for d, w in enumerate(widths)]
    dst_cat = frns._concat_rings(ring_l, rp)
    mdc_l = frns.FastModDownConstants(
        modup_p_to_q=_rows(ctx.mdc.modup_p_to_q, list(range(lo, hi))),
        pinv_mod_q=ctx.mdc.pinv_mod_q[lo:hi])
    gidx = torch.arange(lo, hi, device=dev)
    dig = torch.arange(D, device=dev)[:, None]
    band_lo = dig * alpha
    band_hi = band_lo + torch.tensor(widths, device=dev)[:, None]
    in_band = ((gidx[None, :] >= band_lo) & (gidx[None, :] < band_hi))[:, :, None]

    # host-side rescale constants (numpy), this rank's rows: per dropped
    # limb l = L-1-kk, h = (q_l - 1) / 2 mod q_i and q_l^-1 mod q_i (i < l)
    half = [(Q[L - 1 - kk] - 1) >> 1 for kk in range(nb)]
    qlinv = np.zeros((nb, L), dtype=np.int32)
    hmod = np.zeros((nb, L), dtype=np.int32)
    for kk in range(nb):
        ql = Q[L - 1 - kk]
        for i in range(L):
            hmod[kk, i] = half[kk] % Q[i]
            if i < L - 1 - kk:
                qlinv[kk, i] = pow(ql, -1, Q[i])
    qlinv_l = torch.from_numpy(qlinv[:, lo:hi].copy()).to(dev)[:, :, None]
    hmod_l = torch.from_numpy(hmod[:, lo:hi].copy()).to(dev)[:, :, None]
    q_l = ring_l.moduli[:, None]

    def lift(x_inv: torch.Tensor):
        """The digits' coefficient-domain lifts to this rank's Q rows and
        all P rows: (yq [.., D, lloc, N], yp [.., D, LP, N])."""
        yq, yp = [], []
        for d, w in enumerate(widths):
            s = d * alpha
            if w == 1:
                c = x_inv[..., s:s + 1, :]
                q_src = Q[s]
                neg = c >= (q_src >> 1)
                mag = torch.where(neg, q_src - c, c)
                outs = []
                for ring in (ring_l, rp):
                    qq = ring.moduli[:, None]
                    t = torch.remainder(mag, qq)
                    outs.append(torch.where(neg & (t != 0), qq - t, t))
                yq_d, yp_d = outs
            else:
                both = frns.mod_up(x_inv[..., s:s + w, :], mucs[d], srcs[d], dst_cat,
                                   centered=True)
                yq_d, yp_d = both[..., :lloc, :], both[..., lloc:, :]
            yq.append(yq_d)
            yp.append(yp_d)
        return torch.stack(yq, dim=-3), torch.stack(yp, dim=-3)

    def fn(c0, c1, d0, d1):
        t0, t1, t2 = fckks.tensor(ctx_l, c0, c1, d0, d1)

        # decompose: INTT local, ONE all_gather, per-digit lifts local
        x_inv = api.all_gather(ring_l.intt(t2), mesh, axis, dim=-2)
        yq, yp = lift(x_inv)
        yq = torch.where(in_band, t2[..., None, :, :], ring_l.ntt(yq))
        yp = rp.ntt(yp)

        # MACs (local), ModDown (P lift replicated, Q rows local)
        d_q, d_p = fckks.ks_mac(ctx_l, ctx_l.rlk_q, ctx.rlk_p, yq, yp)
        r = frns.mod_down(d_q, d_p, mdc_l, ring_l, rp, ntt=True)
        x = ring_l.intt(torch.stack([ring_l.add(t0, r[..., 0, :, :]),
                                     ring_l.add(t1, r[..., 1, :, :])], dim=-3))

        # rescale: one psum a dropped limb, over the two stacked polys
        live = torch.ones((lloc, 1), dtype=torch.bool, device=dev)
        for kk in range(nb):
            l_drop = L - 1 - kk
            ql = Q[l_drop]
            t = x + half[kk]
            t = torch.where(t >= ql, t - ql, t)             # (x_l + h) mod q_l
            own = (gidx == l_drop)[:, None]
            t_b = api.psum(torch.where(own, t, 0).sum(dim=-2, dtype=torch.int32), mesh, axis)
            t_red = torch.remainder(t_b[..., None, :], q_l)
            acc = torch.remainder(x + hmod_l[kk] + (2 * q_l - t_red), q_l)
            x = torch.where(gidx[:, None] < l_drop, mulmod(acc, qlinv_l[kk], q_l), 0)
            live = live & (gidx[:, None] < l_drop)
        o = ring_l.ntt(x) * live
        return o[..., 0, :, :], o[..., 1, :, :]

    return fn

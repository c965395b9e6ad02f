"""Wide-path RNS meta-operations: rescale, basis extension, decomposition.

Counterpart of ``matrix_fhe_tpu/fast/wrns.py`` (the reference's
ring/scaling.go and ring/basis_extension.go) on 64-bit words.  The math is
``ops/rns_tools.py``'s, which is reused here: its constants are Montgomery
forms, but every one of them enters a Montgomery product whose other operand
is a plain word, so its outputs are plain-domain words, the wide path's
domain, and canonical.  Where the JAX package rebuilds a specific
representative from its centered pairs (the canonical digits of the ModUp
float64 v-correction, the canonical lift of the last limb in the rescale,
the single-limb digit's centered lift), the port's canonical word already
is that representative.  Outputs equal ``wide.unpack_pair`` of the JAX
package's, limb for limb.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.fast.wring import WideRing
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rns_tools as rt

# The JAX module's names over the u64 tools, which compute the same words.
WideModUpConstants = rt.ModUpConstants
WideModDownConstants = rt.ModDownConstants
WideDecomposer = rt.Decomposer
gen_wide_modup_constants = rt.gen_modup_constants
gen_wide_moddown_constants = rt.gen_moddown_constants
gen_wide_decomposer = rt.gen_decomposer
# ModUpExact (basis_extension.go:282-308), ModDownQPtoQ[NTT] (:219-258)
mod_up = rt.mod_up
mod_down = rt.mod_down
# out_i = (x_i + h - t) * q_l^{-1} mod q_i, t = (x_l + h) mod q_l,
# h = (q_l - 1)/2: the coefficient-domain rounded rescale (scaling.go:111-126)
div_round_by_last_modulus = rt.div_round_by_last_modulus


def div_round_by_last_modulus_many_ntt(ring: WideRing, p: torch.Tensor,
                                       nb: int) -> torch.Tensor:
    """NTT-domain rounded rescale dropping ``nb`` limbs (scaling.go:130-162):
    one INTT, ``nb`` coefficient-domain rescales, one NTT."""
    if nb == 0:
        return p
    L = p.shape[-2]
    x = ring.at_level(L - 1).intt(p)
    for k in range(nb):
        x = div_round_by_last_modulus(ring.at_level(L - 1 - k), x)
    return ring.at_level(L - 1 - nb).ntt(x)


# ---------------------------------------------------------------------------
# Hybrid key-switching digit decomposer (basis_extension.go:310-502).
# ---------------------------------------------------------------------------

def _lift_digit_coeff(dec: WideDecomposer, digit: int, x_inv: torch.Tensor,
                      ring_q: WideRing, ring_p: WideRing):
    """Coefficient-domain lift of hybrid digit ``digit`` to bases Q and P
    (DecomposeSingleNTT's body, evaluator_gadget_product.go:455-480):
    a single-limb digit is lifted centered (c >= q >> 1 negative) into every
    modulus; a multi-limb digit goes through the centered ModUp."""
    lq = x_inv.shape[-2]
    start = digit * dec.alpha
    end = min(start + dec.alpha, lq)
    muc = dec.mucs[digit]
    if muc is None or end - start == 1:
        c = x_inv[..., start:end, :]
        q_src = ring_q.moduli_tuple[start]
        neg = c >= (q_src >> 1)
        mag = torch.where(neg, q_src - c, c)

        def lift(ring):
            qq = ring.moduli[:, None]
            t = mm.bred_add(mag, qq, ring.bhi[:, None])
            return torch.where(neg, mm.cred(qq - t, qq), t)

        return lift(ring_q), lift(ring_p)
    both = rt._mod_up_core(
        x_inv[..., start:end, :], muc, ring_q.moduli[start:end], ring_q.qinv[start:end],
        torch.cat([ring_q.moduli, ring_p.moduli]), torch.cat([ring_q.qinv, ring_p.qinv]),
        torch.cat([ring_q.bhi, ring_p.bhi]), centered=True)
    return both[..., :lq, :], both[..., lq:, :]


def decompose_all_coeff(dec: WideDecomposer, x_inv: torch.Tensor, ring_q: WideRing,
                        ring_p: WideRing) -> tuple[torch.Tensor, torch.Tensor]:
    """All hybrid digits, coefficient domain, stacked for one batched NTT:
    (yq [.., D, LQ, N], yp [.., D, LP, N])."""
    lifts = [_lift_digit_coeff(dec, d, x_inv, ring_q, ring_p) for d in range(dec.num_digits)]
    return (torch.stack([yq for yq, _ in lifts], dim=-3),
            torch.stack([yp for _, yp in lifts], dim=-3))

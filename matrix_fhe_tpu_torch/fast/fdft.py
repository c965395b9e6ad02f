"""Fast-path homomorphic DFT: the CoeffsToSlots / SlotsToCoeffs matrix chain.

Counterpart of ``matrix_fhe_tpu/fast/fdft.py``, the int32 mirror of
``circuits/ckks/dft.py:_dft`` (dft.go:345-363) with one factor a level:
each factorized DFT level is one double-hoisted BSGS matvec
(``fast/flintrans.py``) followed by a one-prime rounded rescale, the fast
context re-sliced to the descending level.
"""

from __future__ import annotations

from matrix_fhe_tpu_torch.fast import flintrans, frns
from matrix_fhe_tpu_torch.fast.fckks import FastCKKSContext


def convert_matrices(params, matrices) -> list[flintrans.FastLinearTransformation]:
    """u64 ``dft.Matrix.matrices`` -> int32 fast transforms, one a level."""
    return [flintrans.convert_lintrans(params, m) for m in matrices]


def dft(ctx: FastCKKSContext, fmats, c0, c1, galois_element, level: int):
    """Apply the factorized DFT chain to an NTT-domain degree-1 ciphertext
    at ``level``: matvec + rescale (one prime) a factor.  Returns
    (out0, out1, final_level)."""
    for fm in fmats:
        sub = ctx.at_level(level)
        c0, c1 = flintrans.matvec_bsgs(sub, fm, c0, c1, galois_element)
        rq = sub.ring_q
        c0 = frns.div_round_by_last_modulus_many_ntt(rq, c0, 1)
        c1 = frns.div_round_by_last_modulus_many_ntt(rq, c1, 1)
        level -= 1
    return c0, c1, level

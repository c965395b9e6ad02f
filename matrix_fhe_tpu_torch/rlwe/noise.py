"""Noise and norm debug utilities.

Counterpart of ``matrix_fhe_tpu/rlwe/noise.py`` (the reference's
core/rlwe/utils.go): given the secret key, measure the log2 standard
deviation of the noise carried by public keys, evaluation keys (gadget
ciphertexts) and ciphertexts.  The ring arithmetic runs on the key's
device; the statistics run on the host over exact Python big ints after a
centered CRT reconstruction, with the JAX package's float arithmetic in the
same order, so both packages report the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.rlwe import decryptor
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.keys import (GadgetCiphertext, GaloisKey, PublicKey, QPPoly,
                                            RelinearizationKey, SecretKey)
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


def _centered_bigints(arr, moduli: list[int]) -> list[int]:
    """CRT-reconstruct [L, N] residues to centered big ints
    (ring.PolyToBigintCentered, ring/ring.go:503)."""
    return crt_reconstruct_centered(_host(arr).astype(np.int64), list(moduli))


def norm_stats(vec: list[int]) -> tuple[float, float, float]:
    """(log2 std, log2 min |.|, log2 max |.|) of integer coefficients
    (rlwe.NormStats, core/rlwe/utils.go:135)."""
    n = len(vec)
    mean = sum(vec) / n
    var = sum((float(v) - mean) ** 2 for v in vec) / n
    mn = min(abs(v) for v in vec)
    mx = max(abs(v) for v in vec)

    def log2(x: float) -> float:
        return math.log2(x) if x > 0 else float("-inf")

    return log2(math.sqrt(var)), log2(mn), log2(mx)


def log2_std(params: Parameters, arr, moduli: list[int] | None = None) -> float:
    """log2 standard deviation of the centered coefficients of a coeff-domain
    RNS poly [L, N] (ring.Log2OfStandardDeviation, ring/ring.go:645)."""
    arr = _host(arr)
    moduli = list(moduli if moduli is not None else params.q[:arr.shape[-2]])
    std, _, _ = norm_stats(_centered_bigints(arr, moduli))
    return std


def _qp_log2_std(params: Parameters, pol: QPPoly) -> float:
    """log2 std of a coeff-domain QP poly (joint CRT over Q then P limbs)."""
    if pol.p is None:
        return log2_std(params, pol.q)
    arr = torch.cat([pol.q, pol.p], dim=0)
    return log2_std(params, arr, list(params.q) + list(params.p))


def noise_public_key(params: Parameters, pk: PublicKey, sk: SecretKey) -> float:
    """log2 std of pk noise: INTT(IMForm(b + a*s)) (utils.go:13-26)."""
    rq, rp = params.ring_q, params.ring_p
    b, a = pk.value
    eq = rq.imform(rq.intt(rq.add(b.q, rq.mul_coeffs_montgomery(a.q, sk.value.q))))
    ep = None
    if rp is not None:
        ep = rp.imform(rp.intt(rp.add(b.p, rp.mul_coeffs_montgomery(a.p, sk.value.p))))
    return _qp_log2_std(params, QPPoly(q=eq, p=ep))


def _gadget_row_plaintext(params: Parameters, pt_q: torch.Tensor, row: int) -> torch.Tensor:
    """P * pt on the limbs of RNS digit ``row``, zero elsewhere: component 0
    of the gadget plaintext of that row (gadgetciphertext.go:169)."""
    rq = params.ring_q
    big_p = params.big_p()
    scaled = rq.mul_scalar_montgomery(pt_q, [(big_p << 64) % q for q in params.q])
    alpha = len(params.p) if params.p else 1
    mask = torch.zeros((len(params.q), 1), dtype=torch.int64, device=pt_q.device)
    mask[row * alpha: min((row + 1) * alpha, len(params.q))] = 1
    return scaled * mask


def noise_gadget_ciphertext(params: Parameters, gct: GadgetCiphertext,
                            pt_q: torch.Tensor, sk: SecretKey) -> float:
    """log2 std of the worst digit row of a gadget ciphertext encrypting
    ``pt_q`` ([LQ, N], NTT + Montgomery form) (utils.go:51-103).

    Row i decrypts to P * pt * w_i + e_i with w_i the RNS digit selector
    (1 mod the digit's moduli, 0 elsewhere); the exact gadget plaintext is
    subtracted and the noisiest row reported."""
    rq, rp = params.ring_q, params.ring_p
    worst = float("-inf")
    for i in range(gct.num_digits):
        bq, aq = gct.q[i, 0], gct.q[i, 1]
        eq = rq.add(bq, rq.mul_coeffs_montgomery(aq, sk.value.q))
        eq = rq.imform(rq.intt(rq.sub(eq, _gadget_row_plaintext(params, pt_q, i))))
        ep = None
        if gct.p is not None and rp is not None:
            bp, ap = gct.p[i, 0], gct.p[i, 1]
            ep = rp.imform(rp.intt(rp.add(bp, rp.mul_coeffs_montgomery(ap, sk.value.p))))
        worst = max(worst, _qp_log2_std(params, QPPoly(q=eq, p=ep)))
    return worst


def noise_evaluation_key(params: Parameters, gct: GadgetCiphertext,
                         sk_in_q: torch.Tensor, sk_out: SecretKey) -> float:
    """log2 std of an evaluation key skIn -> skOut (utils.go:105-109).
    sk_in_q: [LQ, N] NTT + Montgomery; the rows are encrypted under sk_out
    and their gadget plaintext is sk_in."""
    return noise_gadget_ciphertext(params, gct, sk_in_q, sk_out)


def noise_relinearization_key(params: Parameters, rlk: RelinearizationKey,
                              sk: SecretKey) -> float:
    """log2 std of rlk noise (utils.go:28-33): the gadget plaintext is s^2."""
    rq = params.ring_q
    sk2 = rq.mul_coeffs_montgomery(sk.value.q, sk.value.q)
    return noise_evaluation_key(params, rlk.gadget, sk2, sk)


def noise_galois_key(params: Parameters, gk: GaloisKey, sk: SecretKey) -> float:
    """log2 std of a galois key (utils.go:35-48): re-encryption from sk to
    pi_{k^-1}(sk)."""
    gal_inv = params.mod_inv_galois_element(gk.gal_el)
    idx = am.ntt_index(params.ring_type, params.n, params.nth_root, gal_inv)
    iidx = torch.from_numpy(idx.astype("int64")).to(sk.value.q.device)
    sk_out = SecretKey(value=QPPoly(
        q=sk.value.q[..., iidx], p=None if sk.value.p is None else sk.value.p[..., iidx]))
    return noise_evaluation_key(params, gk.gadget, sk.value.q, sk_out)


def norm(params: Parameters, sk: SecretKey, ct: Ciphertext) -> tuple[float, float, float]:
    """(log2 std, log2 min, log2 max) absolute norm of the decryption of
    ``ct`` before decoding, error included (rlwe.Norm, utils.go:111-133)."""
    pt = decryptor.decrypt(params, sk, ct)
    vals = pt.value
    if pt.metadata.is_ntt:
        vals = params.ring_q.at_level(ct.level).intt(vals)
    return norm_stats(_centered_bigints(vals, list(params.q[:ct.level + 1])))


def noise_ciphertext(params: Parameters, sk: SecretKey, ct: Ciphertext, pt_want) -> float:
    """log2 std of Dec(ct) - pt_want, pt_want a coeff-domain [L, N] RNS poly
    at ct's level: the per-op noise oracle the tests use."""
    dec = decryptor.decrypt(params, sk, ct)
    rq = params.ring_q.at_level(ct.level)
    vals = dec.value
    if dec.metadata.is_ntt:
        vals = rq.intt(vals)
    want = torch.as_tensor(_host(pt_want).astype(np.int64), device=vals.device)
    return log2_std(params, rq.sub(vals, want))

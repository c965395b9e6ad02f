"""Decryption: Horner evaluation of the ciphertext at the secret key.

Counterpart of ``matrix_fhe_tpu/rlwe/decryptor.py``
(core/rlwe/decryptor.go:51-91): acc = ((c_d s + c_{d-1}) s + ...) + c_0 in
the NTT domain, s in Montgomery form, so each step is one
mul_coeffs_montgomery.
"""

from __future__ import annotations

from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from matrix_fhe_tpu_torch.rlwe.keys import SecretKey
from matrix_fhe_tpu_torch.rlwe.params import Parameters


def decrypt(params: Parameters, sk: SecretKey, ct: Ciphertext) -> Plaintext:
    level = ct.level
    rq = params.ring_q.at_level(level)
    sk_q = sk.value.q[..., :level + 1, :]
    vals = ct.value
    if not ct.metadata.is_ntt:
        vals = tuple(rq.ntt(v) for v in vals)
    acc = vals[-1]
    for i in range(len(vals) - 2, -1, -1):
        acc = rq.add(rq.mul_coeffs_montgomery(acc, sk_q), vals[i])
    if not ct.metadata.is_ntt:
        acc = rq.intt(acc)
    return Plaintext(value=acc, metadata=ct.metadata)

"""Encryption, split into sampling and a deterministic part.

Counterpart of ``matrix_fhe_tpu/rlwe/encryptor.py`` (the reference's
core/rlwe/encryptor.go).  ``sample_*`` draws the random arrays from a
``torch.Generator``; ``encrypt_zero_*_from_sample`` computes the ciphertext
from them (see ``rlwe/keys.py`` for why the two are apart).  NTT-domain
elements are produced directly; a coefficient-domain ciphertext is the INTT
of one.
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData, Plaintext
from matrix_fhe_tpu_torch.rlwe.keys import PublicKey, SecretKey, extend_basis_small_norm
from matrix_fhe_tpu_torch.rlwe.params import Parameters


@dataclasses.dataclass(frozen=True)
class SkSample:
    """Random part of a secret-key zero encryption at one level."""
    c1: torch.Tensor  # [L, N] uniform, NTT domain
    e: torch.Tensor   # [L, N] error, coefficient domain


@dataclasses.dataclass(frozen=True)
class PkSample:
    """Random part of a public-key zero encryption at one level."""
    u: torch.Tensor   # [L, N] ternary, coefficient domain
    e0: torch.Tensor  # [L, N] errors, coefficient domain
    e1: torch.Tensor


def _level(params: Parameters, level: int | None) -> int:
    return params.max_level if level is None else level


def sample_sk(gen: torch.Generator, params: Parameters, level: int | None = None) -> SkSample:
    rq = params.ring_q.at_level(_level(params, level))
    c1 = smp.uniform_poly(gen, rq)
    return SkSample(c1=c1, e=smp.sample(gen, rq, params.xe))


def encrypt_zero_sk_from_sample(params: Parameters, sk: SecretKey, s: SkSample,
                                metadata: MetaData = MetaData()) -> Ciphertext:
    """Secret-key encryption of zero (encryptor.go:355-423): c1 uniform in
    the NTT domain, c0 = -c1 s + NTT(e)."""
    level = s.c1.shape[-2] - 1
    rq = params.ring_q.at_level(level)
    c1 = s.c1
    c0 = rq.sub(rq.ntt(s.e), rq.mul_coeffs_montgomery(c1, sk.value.q[..., :level + 1, :]))
    if not metadata.is_ntt:
        c0, c1 = rq.intt(c0), rq.intt(c1)
    return Ciphertext(value=(c0, c1), metadata=metadata)


def encrypt_zero_sk(gen: torch.Generator, params: Parameters, sk: SecretKey,
                    level: int | None = None, metadata: MetaData = MetaData()) -> Ciphertext:
    return encrypt_zero_sk_from_sample(params, sk, sample_sk(gen, params, level), metadata)


def sample_pk(gen: torch.Generator, params: Parameters, level: int | None = None) -> PkSample:
    rq = params.ring_q.at_level(_level(params, level))
    xs = params.xs if isinstance(params.xs, smp.Ternary) else smp.Ternary(p=2 / 3.0)
    u = smp.ternary_poly(gen, rq, xs)
    return PkSample(u=u, e0=smp.sample(gen, rq, params.xe), e1=smp.sample(gen, rq, params.xe))


def encrypt_zero_pk_from_sample(params: Parameters, pk: PublicKey, s: PkSample,
                                metadata: MetaData = MetaData()) -> Ciphertext:
    """Public-key encryption of zero (encryptor.go:218-308): (u pk0 + e0,
    u pk1 + e1) over (Q, P), then ModDown by P."""
    level = s.u.shape[-2] - 1
    rq = params.ring_q.at_level(level)
    rp = params.ring_p
    uq = rq.ntt(s.u)
    pk0q, pk1q = (pk.value[i].q[..., :level + 1, :] for i in (0, 1))
    if rp is None:
        c0 = rq.add(rq.mul_coeffs_montgomery(uq, pk0q), rq.ntt(s.e0))
        c1 = rq.add(rq.mul_coeffs_montgomery(uq, pk1q), rq.ntt(s.e1))
        if not metadata.is_ntt:
            c0, c1 = rq.intt(c0), rq.intt(c1)
        return Ciphertext(value=(c0, c1), metadata=metadata)
    q0 = params.q[0]
    up = rp.ntt(extend_basis_small_norm(q0, rp.moduli, s.u[0]))
    # coefficient-domain accumulation (the reference INTTs before adding e)
    c0q = rq.add(rq.intt(rq.mul_coeffs_montgomery(uq, pk0q)), s.e0)
    c1q = rq.add(rq.intt(rq.mul_coeffs_montgomery(uq, pk1q)), s.e1)
    c0p = rp.add(rp.intt(rp.mul_coeffs_montgomery(up, pk.value[0].p)),
                 extend_basis_small_norm(q0, rp.moduli, s.e0[0]))
    c1p = rp.add(rp.intt(rp.mul_coeffs_montgomery(up, pk.value[1].p)),
                 extend_basis_small_norm(q0, rp.moduli, s.e1[0]))
    mdc = params.moddown_constants(level, params.max_level_p)
    c0 = rt.mod_down(c0q, c0p, mdc, rq, rp, ntt=False)
    c1 = rt.mod_down(c1q, c1p, mdc, rq, rp, ntt=False)
    if metadata.is_ntt:
        c0, c1 = rq.ntt(c0), rq.ntt(c1)
    return Ciphertext(value=(c0, c1), metadata=metadata)


def encrypt_zero_pk(gen: torch.Generator, params: Parameters, pk: PublicKey,
                    level: int | None = None, metadata: MetaData = MetaData()) -> Ciphertext:
    return encrypt_zero_pk_from_sample(params, pk, sample_pk(gen, params, level), metadata)


def sample_for(gen: torch.Generator, params: Parameters, enc_key, level: int):
    """The random part of an encryption under ``enc_key`` at ``level``."""
    if isinstance(enc_key, SecretKey):
        return sample_sk(gen, params, level)
    return sample_pk(gen, params, level)


def encrypt_from_sample(params: Parameters, enc_key, pt: Plaintext, s) -> Ciphertext:
    """EncryptZero + addPtToCt (encryptor.go:148-166, 512-533)."""
    md = pt.metadata
    if isinstance(enc_key, SecretKey):
        ct = encrypt_zero_sk_from_sample(params, enc_key, s, md)
    else:
        ct = encrypt_zero_pk_from_sample(params, enc_key, s, md)
    rq = params.ring_q.at_level(pt.level)
    return ct.with_value((rq.add(ct.value[0], pt.value), ct.value[1]))


def encrypt(gen: torch.Generator, params: Parameters, enc_key, pt: Plaintext) -> Ciphertext:
    return encrypt_from_sample(params, enc_key, pt,
                               sample_for(gen, params, enc_key, pt.level))

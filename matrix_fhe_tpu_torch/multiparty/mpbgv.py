"""BGV multiparty: EncToShare / ShareToEnc and the collective refresh.

Counterpart of ``matrix_fhe_tpu/multiparty/mpbgv.py`` (the reference's
multiparty/mpbgv/: sharing.go, refresh.go): the integer analogue of
``mpckks``.  Masks are uniform elements of R_T, moved between the plaintext
ring and R_Q by the BGV encoder's scaled RingT2Q / RingQ2T maps (the
T^{-1} mod Q factor a BGV ciphertext carries), over ``ops/rns_tools.py``.
Each share's draws (the mask and the smudging noise) come from
``sample_share``, the share from ``share_from_sample``.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch

from matrix_fhe_tpu_torch.multiparty.mpckks import _zero_sk
from matrix_fhe_tpu_torch.multiparty.protocols import KeySwitch, sample_crp_q
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData
from matrix_fhe_tpu_torch.schemes.bgv.scheme import mform_scalars


def _ring_t2q_scaled(params, level: int, mask_t: torch.Tensor, ntt: bool) -> torch.Tensor:
    """RingT2Q with scale-up: m in R_T lifted to (m T^{-1}) mod each q_i
    (the BGV plaintext format; schemes/bgv/encoder.go RingT2Q + scaleUp)."""
    ring = params.ring_q.at_level(level)
    limbs = mask_t.to(params.device).expand(level + 1, -1) % ring.moduli[:, None]
    tinv = [pow(params.t, -1, q) * (1 << 64) % q for q in ring.moduli_tuple]
    out = ring.mul_scalar_montgomery(limbs, tinv)
    return ring.ntt(out) if ntt else out


def _ring_q2t_scaled(params, level: int, poly_q: torch.Tensor) -> torch.Tensor:
    """RingQ2T with scale-down: the centered exact map (m T mod Q) -> R_T."""
    ring = params.ring_q.at_level(level)
    v = ring.mul_scalar_montgomery(poly_q, mform_scalars(ring.moduli_tuple, params.t,
                                                         ring.device))
    return rt.mod_up(v, params.q_to_t(level), ring, params.ring_t, centered=True)


@dataclasses.dataclass(frozen=True)
class EncToShareSample:
    """A party's draws of enc-to-share: its mask in R_T ([1, N], uniform in
    [0, T)), then its smudging noise."""
    mask_t: torch.Tensor
    e: torch.Tensor


class EncToShare:
    """mpbgv/sharing.go:91-129."""

    @staticmethod
    def sample_share(gen: torch.Generator, params, ct: Ciphertext,
                     sigma_smudge: float = 3.2) -> EncToShareSample:
        mask_t = torch.randint(0, params.t, (1, params.n), generator=gen, dtype=torch.int64,
                               device=gen.device)
        return EncToShareSample(mask_t=mask_t.to(params.device), e=KeySwitch.sample_share(
            gen, params, ct.level, sigma_smudge))

    @staticmethod
    def share_from_sample(params, sk: K.SecretKey, ct: Ciphertext, s: EncToShareSample):
        """(the party's mask, its public share)."""
        pub = KeySwitch.share_from_sample(params, sk, _zero_sk(params), ct, s.e)
        rq = params.ring_q.at_level(ct.level)
        lifted = _ring_t2q_scaled(params, ct.level, s.mask_t, ntt=ct.metadata.is_ntt)
        return s.mask_t, rq.sub(pub, lifted)

    @staticmethod
    def gen_share(gen: torch.Generator, params, sk: K.SecretKey, ct: Ciphertext,
                  sigma_smudge: float = 3.2):
        return EncToShare.share_from_sample(params, sk, ct, EncToShare.sample_share(
            gen, params, ct, sigma_smudge))

    aggregate = staticmethod(KeySwitch.aggregate)

    @staticmethod
    def get_share(params, secret_share, agg, ct: Ciphertext):
        rq = params.ring_q.at_level(ct.level)
        buff = rq.add(agg, ct.value[0])
        if ct.metadata.is_ntt:
            buff = rq.intt(buff)
        vt = _ring_q2t_scaled(params, ct.level, buff)
        if secret_share is not None:
            return params.ring_t.add(secret_share, vt)
        return vt


class ShareToEnc:
    """mpbgv/sharing.go:168-210."""

    @staticmethod
    def sample_share(gen: torch.Generator, params, crs_poly: torch.Tensor,
                     sigma_smudge: float = 3.2) -> torch.Tensor:
        return KeySwitch.sample_share(gen, params, crs_poly.shape[-2] - 1, sigma_smudge)

    @staticmethod
    def share_from_sample(params, sk: K.SecretKey, crs_poly, secret_share_t, e: torch.Tensor):
        level = crs_poly.shape[-2] - 1
        ct = Ciphertext(value=(crs_poly, crs_poly), metadata=MetaData(is_ntt=True))
        share = KeySwitch.share_from_sample(params, _zero_sk(params), sk, ct, e)
        rq = params.ring_q.at_level(level)
        return rq.add(share, _ring_t2q_scaled(params, level, secret_share_t, ntt=True))

    @staticmethod
    def gen_share(gen: torch.Generator, params, sk: K.SecretKey, crs_poly, secret_share_t,
                  sigma_smudge: float = 3.2):
        return ShareToEnc.share_from_sample(params, sk, crs_poly, secret_share_t,
                                            ShareToEnc.sample_share(gen, params, crs_poly,
                                                                    sigma_smudge))

    aggregate = staticmethod(KeySwitch.aggregate)

    @staticmethod
    def get_encryption(params, c0_agg, crs_poly, scale) -> Ciphertext:
        md = MetaData(scale=Fraction(scale), is_ntt=True)
        return Ciphertext(value=(c0_agg, crs_poly), metadata=md)


@dataclasses.dataclass(frozen=True)
class RefreshSample:
    """A party's draws of the refresh: its enc-to-share's, then its
    share-to-enc's smudging noise."""
    e2s: EncToShareSample
    s2e: torch.Tensor


class Refresh:
    """mpbgv/refresh.go: enc-to-share at the input level and share-to-enc at
    the top level with the same R_T mask."""

    sample_crp = staticmethod(sample_crp_q)

    @staticmethod
    def sample_share(gen: torch.Generator, params, ct: Ciphertext, crs_poly,
                     sigma_smudge: float = 3.2) -> RefreshSample:
        e2s = EncToShare.sample_share(gen, params, ct, sigma_smudge)
        return RefreshSample(e2s=e2s, s2e=ShareToEnc.sample_share(gen, params, crs_poly,
                                                                  sigma_smudge))

    @staticmethod
    def share_from_sample(params, sk: K.SecretKey, ct: Ciphertext, crs_poly,
                          s: RefreshSample):
        mask_t, e2s = EncToShare.share_from_sample(params, sk, ct, s.e2s)
        return e2s, ShareToEnc.share_from_sample(params, sk, crs_poly, mask_t, s.s2e)

    @staticmethod
    def gen_share(gen: torch.Generator, params, sk: K.SecretKey, ct: Ciphertext, crs_poly,
                  sigma_smudge: float = 3.2):
        return Refresh.share_from_sample(params, sk, ct, crs_poly, Refresh.sample_share(
            gen, params, ct, crs_poly, sigma_smudge))

    @staticmethod
    def aggregate(params, a, b):
        return (KeySwitch.aggregate(params, a[0], b[0]), KeySwitch.aggregate(params, a[1], b[1]))

    @staticmethod
    def finalize(params, ct: Ciphertext, agg, crs_poly) -> Ciphertext:
        e2s_agg, s2e_agg = agg
        vt = EncToShare.get_share(params, None, e2s_agg, ct)
        max_level = crs_poly.shape[-2] - 1
        rq = params.ring_q.at_level(max_level)
        c0 = rq.add(_ring_t2q_scaled(params, max_level, vt, ntt=True), s2e_agg)
        return ShareToEnc.get_encryption(params, c0, crs_poly, ct.scale)

"""CKKS multiparty: EncToShare / ShareToEnc and the masked-transform
(collective refresh) protocol.

Counterpart of ``matrix_fhe_tpu/multiparty/mpckks.py`` (the reference's
multiparty/mpckks/: sharing.go:18-283, transform.go:17-379):

  * enc-to-share: each party publishes c1 s_i + e_i - M_i (NTT domain) with a
    private mask M_i of log_bound bits; the sum plus c0 decrypts to the
    message additively masked;
  * share-to-enc: each party publishes -crs s_i + e_i + M_i; the aggregate
    plus the positional re-encoding of the masked message re-encrypts it
    under the collective key at the top level;
  * masked transform: enc-to-share at the input level and share-to-enc at
    the output level with the same masks (scaled by scale_out / scale_in);
    both together refresh the ciphertext (collective bootstrapping),
    optionally applying a slot-wise transform to the masked values.

Masks are Python integers (exact host arithmetic, as the reference's
*big.Int path) drawn by ``sample_mask`` from an integer seed with Python's
``random.Random``: deterministic, so it is the JAX package's own draw.  The
smudging noise of each share is drawn by ``sample_share`` from a
``torch.Generator`` and used by ``share_from_sample``.  The positional
values move between the host and the device once a call.
"""

from __future__ import annotations

import dataclasses
import random
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.multiparty.protocols import KeySwitch, sample_crp_q
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered


def _zero_sk(params: Parameters) -> K.SecretKey:
    z = torch.zeros((len(params.q), params.n), dtype=torch.int64, device=params.device)
    zp = None
    if params.ring_p is not None:
        zp = torch.zeros((len(params.p), params.n), dtype=torch.int64, device=params.device)
    return K.SecretKey(value=K.QPPoly(q=z, p=zp))


def _dslots(params: Parameters, metadata: MetaData) -> int:
    slots = 1 << metadata.log_dimensions[1]
    if params.ring_type == "standard":
        slots *= 2
    return slots


def set_coefficients_bigint(params: Parameters, level: int, values: list[int],
                            metadata: MetaData) -> torch.Tensor:
    """Positional integer values -> RNS limbs at stride N / len(values), then
    the NTT and MForm the metadata asks for (ring.SetCoefficientsBigint +
    rlwe.NTTSparseAndMontgomery)."""
    rq = params.ring_q.at_level(level)
    gap = params.n // len(values)
    arr = np.zeros((level + 1, params.n), dtype=np.int64)
    for j, q in enumerate(params.q[:level + 1]):
        arr[j, ::gap] = [v % q for v in values]
    out = torch.from_numpy(arr).to(params.device)
    if metadata.is_ntt:
        out = rq.ntt(out)
    if metadata.is_montgomery:
        out = rq.mform(out)
    return out


def poly_to_bigint_centered(params: Parameters, level: int, arr: torch.Tensor,
                            gap: int) -> list[int]:
    """ring.PolyToBigintCentered at stride ``gap``."""
    return crt_reconstruct_centered(arr[..., ::gap].cpu().numpy(), params.q[:level + 1])


def sample_mask(seed: int, count: int, log_bound: int) -> list[int]:
    """Centered uniform masks of log_bound bits (sharing.go:118-131)."""
    rng = random.Random(seed)
    bound = 1 << log_bound
    half = bound >> 1
    out = []
    for _ in range(count):
        m = rng.randrange(bound)
        out.append(m - bound if m >= half else m)
    return out


class EncToShare:
    """sharing.go:18-189."""

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters, ct: Ciphertext,
                     sigma_smudge: float = 3.2) -> torch.Tensor:
        return KeySwitch.sample_share(gen, params, ct.level, sigma_smudge)

    @staticmethod
    def share_from_sample(seed: int, params: Parameters, sk: K.SecretKey, log_bound: int,
                          ct: Ciphertext, e: torch.Tensor):
        """(the party's mask, its public share)."""
        level = ct.level
        if (1 << log_bound) > params.ring_q.modulus_at_level(level):
            raise ValueError("ciphertext level too low for refresh correctness")
        mask = sample_mask(seed, _dslots(params, ct.metadata), log_bound)
        pub = KeySwitch.share_from_sample(params, sk, _zero_sk(params), ct, e)
        rq = params.ring_q.at_level(level)
        return mask, rq.sub(pub, set_coefficients_bigint(params, level, mask, ct.metadata))

    @staticmethod
    def gen_share(gen: torch.Generator, seed: int, params: Parameters, sk: K.SecretKey,
                  log_bound: int, ct: Ciphertext, sigma_smudge: float = 3.2):
        return EncToShare.share_from_sample(
            seed, params, sk, log_bound, ct,
            EncToShare.sample_share(gen, params, ct, sigma_smudge))

    @staticmethod
    def aggregate(params: Parameters, s1, s2):
        return KeySwitch.aggregate(params, s1, s2)

    @staticmethod
    def get_share(params: Parameters, secret_share, agg, ct: Ciphertext):
        """Masked decryption and the party's own mask removed (sharing.go:145-189)."""
        level = ct.level
        rq = params.ring_q.at_level(level)
        buff = rq.add(agg, ct.value[0])
        if ct.metadata.is_ntt:
            buff = rq.intt(buff)
        vals = poly_to_bigint_centered(params, level, buff,
                                       params.n // _dslots(params, ct.metadata))
        if secret_share is not None:
            return [a + b for a, b in zip(secret_share, vals)]
        return vals


class ShareToEnc:
    """sharing.go:190-283."""

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters, crs_poly: torch.Tensor,
                     sigma_smudge: float = 3.2) -> torch.Tensor:
        return KeySwitch.sample_share(gen, params, crs_poly.shape[-2] - 1, sigma_smudge)

    @staticmethod
    def share_from_sample(params: Parameters, sk: K.SecretKey, crs_poly: torch.Tensor,
                          metadata: MetaData, secret_share: list[int], e: torch.Tensor):
        level = crs_poly.shape[-2] - 1
        ct = Ciphertext(value=(crs_poly, crs_poly), metadata=metadata)
        share = KeySwitch.share_from_sample(params, _zero_sk(params), sk, ct, e)
        rq = params.ring_q.at_level(level)
        return rq.add(share, set_coefficients_bigint(params, level, secret_share, metadata))

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk: K.SecretKey,
                  crs_poly: torch.Tensor, metadata: MetaData, secret_share: list[int],
                  sigma_smudge: float = 3.2):
        return ShareToEnc.share_from_sample(
            params, sk, crs_poly, metadata, secret_share,
            ShareToEnc.sample_share(gen, params, crs_poly, sigma_smudge))

    @staticmethod
    def aggregate(params: Parameters, s1, s2):
        return KeySwitch.aggregate(params, s1, s2)

    @staticmethod
    def get_encryption(params: Parameters, c0_agg, crs_poly, metadata: MetaData) -> Ciphertext:
        return Ciphertext(value=(c0_agg, crs_poly), metadata=metadata)


@dataclasses.dataclass
class RefreshShare:
    e2s: torch.Tensor
    s2e: torch.Tensor
    metadata: MetaData


@dataclasses.dataclass(frozen=True)
class MaskedTransformSample:
    """A party's smudging noise for its enc-to-share and its share-to-enc share."""
    e2s: torch.Tensor
    s2e: torch.Tensor


class MaskedTransform:
    """transform.go:17-379 (refresh = the identity transform).  ``transform``
    is an optional callable applied to the masked complex slot values."""

    @staticmethod
    def sample_crp(crs: torch.Generator, params: Parameters, level: int) -> torch.Tensor:
        return sample_crp_q(crs, params, level)

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters, ct: Ciphertext,
                     crs_poly: torch.Tensor, sigma_smudge: float = 3.2
                     ) -> MaskedTransformSample:
        e2s = EncToShare.sample_share(gen, params, ct, sigma_smudge)
        return MaskedTransformSample(e2s=e2s, s2e=ShareToEnc.sample_share(
            gen, params, crs_poly, sigma_smudge))

    @staticmethod
    def share_from_sample(seed: int, params: Parameters, sk_in: K.SecretKey,
                          sk_out: K.SecretKey, log_bound: int, ct: Ciphertext, crs_poly,
                          target_scale: Fraction, s: MaskedTransformSample,
                          transform=None) -> RefreshShare:
        mask, e2s_share = EncToShare.share_from_sample(seed, params, sk_in, log_bound, ct,
                                                       s.e2s)
        mask = _apply_transform_and_scale(params, ct.metadata, mask, transform,
                                          Fraction(target_scale) / ct.scale)
        s2e_share = ShareToEnc.share_from_sample(params, sk_out, crs_poly, ct.metadata, mask,
                                                 s.s2e)
        return RefreshShare(e2s=e2s_share, s2e=s2e_share, metadata=ct.metadata)

    @staticmethod
    def gen_share(gen: torch.Generator, seed: int, params: Parameters, sk_in: K.SecretKey,
                  sk_out: K.SecretKey, log_bound: int, ct: Ciphertext, crs_poly,
                  target_scale: Fraction, transform=None, sigma_smudge: float = 3.2
                  ) -> RefreshShare:
        return MaskedTransform.share_from_sample(
            seed, params, sk_in, sk_out, log_bound, ct, crs_poly, target_scale,
            MaskedTransform.sample_share(gen, params, ct, crs_poly, sigma_smudge), transform)

    @staticmethod
    def aggregate(params: Parameters, a: RefreshShare, b: RefreshShare) -> RefreshShare:
        return RefreshShare(e2s=KeySwitch.aggregate(params, a.e2s, b.e2s),
                            s2e=KeySwitch.aggregate(params, a.s2e, b.s2e), metadata=a.metadata)

    @staticmethod
    def transform(params: Parameters, ct: Ciphertext, crs_poly, share: RefreshShare,
                  target_scale: Fraction, transform=None) -> Ciphertext:
        """transform.go:220-300."""
        max_level = crs_poly.shape[-2] - 1
        vals = EncToShare.get_share(params, None, share.e2s, ct)
        vals = _apply_transform_and_scale(params, ct.metadata, vals, transform,
                                          Fraction(target_scale) / ct.scale)
        rq = params.ring_q.at_level(max_level)
        c0 = rq.add(set_coefficients_bigint(params, max_level, vals, ct.metadata), share.s2e)
        out = Ciphertext(value=(c0, crs_poly), metadata=ct.metadata)
        return out.with_metadata(scale=Fraction(target_scale))


def _apply_transform_and_scale(params, metadata, mask: list[int], transform,
                               diffscale: Fraction) -> list[int]:
    """applyTransformAndScale (transform.go:302-379): the optional slot-wise
    complex transform of the masked values, then the scaling by diffscale."""
    if transform is not None:
        slots = 1 << metadata.log_dimensions[1]
        re = np.array([float(v) for v in mask[:slots]])
        if params.ring_type == "standard":
            im = np.array([float(v) for v in mask[slots:2 * slots]])
        else:
            im = np.zeros(slots)
        z = transform(re + 1j * im)
        out = [round(x) for x in np.real(z)]
        if params.ring_type == "standard":
            out += [round(x) for x in np.imag(z)]
        mask = out
    if diffscale != 1:
        mask = [round(v * diffscale) for v in mask]
    return mask

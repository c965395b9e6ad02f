"""Share-based multiparty protocols: collective key generation and key
switching.

Counterpart of ``matrix_fhe_tpu/multiparty/protocols.py`` (the reference's
multiparty/: keygen_cpk.go, keygen_evk.go, keygen_gal.go, keygen_relin.go,
keyswitch_sk.go, keyswitch_pk.go).  Every protocol has the reference's
shape

    sample_crp (from the common reference string) -> gen_share -> aggregate
    -> finalize

as functions of tensors the caller moves between parties; aggregation is
modular addition, so it reduces in any order (keygen_cpk.go:86).

Randomness is split as the keys are (``rlwe/keys.py``): the CRS is a
``torch.Generator`` all parties seed alike, and ``sample_crp_*`` draws the
common polynomials from it (``crp_qp_from_samples`` / ``crp_q_from_samples``
put given draws on the parameters' device); each ``gen_share`` is a
``sample_share`` (the party's own draws, from its generator) followed by
the deterministic ``share_from_sample(s)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe import encryptor as enc_mod
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.params import Parameters


# ---------------------------------------------------------------------------
# CRS sampling.
# ---------------------------------------------------------------------------

def crp_qp_from_samples(params: Parameters, a_q: torch.Tensor, a_p: torch.Tensor | None
                        ) -> K.QPPoly:
    """The common (Q, P) polynomial of the uniform draws ``a_q`` [LQ, N]
    and ``a_p`` [LP, N] (None without P), on the parameters' device."""
    if tuple(a_q.shape) != (len(params.q), params.n):
        raise ValueError(f"crp q part of shape {tuple(a_q.shape)}")
    if (a_p is None) != (params.ring_p is None):
        raise ValueError("crp p part does not match the parameters' P")
    return K.QPPoly(q=a_q.to(params.device),
                    p=None if a_p is None else a_p.to(params.device))


def sample_crp_qp(crs: torch.Generator, params: Parameters) -> K.QPPoly:
    """A uniform (Q, P) common random polynomial (keygen_cpk.go:59)."""
    a_q = smp.uniform_poly(crs, params.ring_q)
    a_p = None if params.ring_p is None else smp.uniform_poly(crs, params.ring_p)
    return crp_qp_from_samples(params, a_q, a_p)


def crp_q_from_samples(params: Parameters, level: int, a: torch.Tensor) -> torch.Tensor:
    if tuple(a.shape) != (level + 1, params.n):
        raise ValueError(f"crp of shape {tuple(a.shape)} at level {level}")
    return a.to(params.device)


def sample_crp_q(crs: torch.Generator, params: Parameters, level: int) -> torch.Tensor:
    """A uniform mod-Q polynomial at ``level`` (keyswitch_sk.go:107)."""
    return crp_q_from_samples(params, level,
                              smp.uniform_poly(crs, params.ring_q.at_level(level)))


def _sample_e(gen: torch.Generator, params: Parameters) -> torch.Tensor:
    """The draw of one fresh noise polynomial over (Q, P): e from Xe mod Q
    (coefficient domain)."""
    return smp.sample(gen, params.ring_q, params.xe)


def _e_qp_from_sample(params: Parameters, e: torch.Tensor, ntt: bool = True,
                      mform: bool = False) -> K.QPPoly:
    """Fresh noise over (Q, P): e mod Q, sign-extended to P (the
    ExtendBasisSmallNormAndCenter idiom)."""
    rq, rp = params.ring_q, params.ring_p
    eq, ep = e, None
    if rp is not None:
        ep = K.extend_basis_small_norm(params.q[0], rp.moduli, e[0])
    if ntt:
        eq = rq.ntt(eq)
        ep = None if ep is None else rp.ntt(ep)
    if mform:
        eq = rq.mform(eq)
        ep = None if ep is None else rp.mform(ep)
    return K.QPPoly(q=eq, p=ep)


def _qp_add(params, a: K.QPPoly, b: K.QPPoly) -> K.QPPoly:
    rq, rp = params.ring_q, params.ring_p
    return K.QPPoly(q=rq.add(a.q, b.q), p=None if a.p is None else rp.add(a.p, b.p))


def _qp_sub(params, a: K.QPPoly, b: K.QPPoly) -> K.QPPoly:
    rq, rp = params.ring_q, params.ring_p
    return K.QPPoly(q=rq.sub(a.q, b.q), p=None if a.p is None else rp.sub(a.p, b.p))


def _qp_mul_mont(params, a: K.QPPoly, b: K.QPPoly) -> K.QPPoly:
    rq, rp = params.ring_q, params.ring_p
    return K.QPPoly(q=rq.mul_coeffs_montgomery(a.q, b.q),
                    p=None if a.p is None else rp.mul_coeffs_montgomery(a.p, b.p))


def _digit_mask(params: Parameters, i: int) -> torch.Tensor:
    """[LQ, 1] ones on the limbs of RNS digit i."""
    L = len(params.q)
    alpha = max(len(params.p), 1)
    mask = torch.zeros((L, 1), dtype=torch.int64, device=params.device)
    mask[i * alpha: min((i + 1) * alpha, L)] = 1
    return mask


def _p_scalars(params: Parameters) -> list[int]:
    """MForm(P mod q_i) a Q limb."""
    big_p = params.big_p()
    return [(big_p << 64) % q for q in params.q]


# ---------------------------------------------------------------------------
# Collective public key (keygen_cpk.go).
# ---------------------------------------------------------------------------

class PublicKeyGen:
    """share_i = -crp*s_i + e_i; pk = (sum shares, crp)."""

    @staticmethod
    def sample_crp(crs: torch.Generator, params: Parameters) -> K.QPPoly:
        return sample_crp_qp(crs, params)

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters) -> torch.Tensor:
        return _sample_e(gen, params)

    @staticmethod
    def share_from_sample(params: Parameters, sk: K.SecretKey, crp: K.QPPoly,
                          e: torch.Tensor) -> K.QPPoly:
        e = _e_qp_from_sample(params, e, ntt=True, mform=True)
        return _qp_sub(params, e, _qp_mul_mont(params, sk.value, crp))

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk: K.SecretKey,
                  crp: K.QPPoly) -> K.QPPoly:
        return PublicKeyGen.share_from_sample(params, sk, crp,
                                              PublicKeyGen.sample_share(gen, params))

    @staticmethod
    def aggregate(params: Parameters, s1: K.QPPoly, s2: K.QPPoly) -> K.QPPoly:
        return _qp_add(params, s1, s2)

    @staticmethod
    def finalize(params: Parameters, agg: K.QPPoly, crp: K.QPPoly) -> K.PublicKey:
        return K.PublicKey(value=(agg, crp))


# ---------------------------------------------------------------------------
# Collective evaluation key skIn -> skOut (keygen_evk.go).
# ---------------------------------------------------------------------------

class EvaluationKeyGen:
    """For RNS digit i: share_i = MForm(e) + MForm(P skIn sel_i) - skOut crp_i;
    evk = (sum shares, crp) (keygen_evk.go:120-220)."""

    @staticmethod
    def num_digits(params: Parameters) -> int:
        alpha = max(len(params.p), 1)
        return -(-len(params.q) // alpha)

    @staticmethod
    def sample_crp(crs: torch.Generator, params: Parameters) -> list[K.QPPoly]:
        return [sample_crp_qp(crs, params) for _ in range(EvaluationKeyGen.num_digits(params))]

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters) -> list[torch.Tensor]:
        """One noise draw a digit."""
        return [_sample_e(gen, params) for _ in range(EvaluationKeyGen.num_digits(params))]

    @staticmethod
    def share_from_samples(params: Parameters, sk_in_q: torch.Tensor, sk_out: K.SecretKey,
                           crp: list, es: list[torch.Tensor]) -> list[K.QPPoly]:
        """sk_in_q: the input key mod Q, NTT + MForm."""
        if len(es) != len(crp):
            raise ValueError(f"{len(es)} noise draws for {len(crp)} digits")
        rq = params.ring_q
        scaled = rq.mul_scalar_montgomery(sk_in_q, _p_scalars(params))
        shares = []
        for i, (crp_i, e) in enumerate(zip(crp, es)):
            e = _e_qp_from_sample(params, e, ntt=True, mform=True)
            h = K.QPPoly(q=rq.add(e.q, scaled * _digit_mask(params, i)), p=e.p)
            shares.append(_qp_sub(params, h, _qp_mul_mont(params, sk_out.value, crp_i)))
        return shares

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk_in_q: torch.Tensor,
                  sk_out: K.SecretKey, crp: list) -> list[K.QPPoly]:
        return EvaluationKeyGen.share_from_samples(
            params, sk_in_q, sk_out, crp, EvaluationKeyGen.sample_share(gen, params))

    @staticmethod
    def aggregate(params: Parameters, s1: list, s2: list) -> list:
        return [_qp_add(params, a, b) for a, b in zip(s1, s2)]

    @staticmethod
    def finalize(params: Parameters, agg: list, crp: list) -> K.EvaluationKey:
        gq = torch.stack([torch.stack([a.q, c.q]) for a, c in zip(agg, crp)])
        gp = None
        if params.ring_p is not None:
            gp = torch.stack([torch.stack([a.p, c.p]) for a, c in zip(agg, crp)])
        return K.EvaluationKey(gadget=K.GadgetCiphertext(q=gq, p=gp))


# ---------------------------------------------------------------------------
# Collective Galois key (keygen_gal.go).
# ---------------------------------------------------------------------------

class GaloisKeyGen:
    sample_crp = EvaluationKeyGen.sample_crp
    sample_share = EvaluationKeyGen.sample_share
    aggregate = EvaluationKeyGen.aggregate

    @staticmethod
    def share_from_samples(params: Parameters, sk: K.SecretKey, gal_el: int, crp: list,
                           es: list[torch.Tensor]) -> list[K.QPPoly]:
        """skOut = pi_{galEl^-1}(sk) (keygen_gal.go:56-79)."""
        idx = am.ntt_index(params.ring_type, params.n, params.nth_root,
                           params.mod_inv_galois_element(gal_el))
        iidx = torch.from_numpy(idx.astype("int64")).to(params.device)
        sk_out = K.SecretKey(value=K.QPPoly(
            q=sk.value.q[..., iidx], p=None if sk.value.p is None else sk.value.p[..., iidx]))
        return EvaluationKeyGen.share_from_samples(params, sk.value.q, sk_out, crp, es)

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk: K.SecretKey, gal_el: int,
                  crp: list) -> list[K.QPPoly]:
        return GaloisKeyGen.share_from_samples(params, sk, gal_el, crp,
                                               EvaluationKeyGen.sample_share(gen, params))

    @staticmethod
    def finalize(params: Parameters, agg: list, crp: list, gal_el: int) -> K.GaloisKey:
        evk = EvaluationKeyGen.finalize(params, agg, crp)
        return K.GaloisKey(gadget=evk.gadget, gal_el=gal_el)


# ---------------------------------------------------------------------------
# Collective relinearization key (keygen_relin.go, two rounds).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RelinRound1Sample:
    """A party's draws of round 1: its ephemeral secret u (coefficient
    domain, from Xs) and two noise polynomials a digit."""
    u: torch.Tensor
    e0: list[torch.Tensor]
    e1: list[torch.Tensor]


class RelinKeyGen:
    """round1_i = [-u_i a + P s_i sel + e0_i, s_i a + e1_i] (a digit);
    round2_i = s_i round1[0] + (u_i - s_i) round1[1] + e2_i;
    rlk = (MForm(sum round2), MForm(sum round1[1])) (keygen_relin.go:125-310).

    Round shares stay out of the Montgomery domain as in the reference
    (MForm at finalize)."""

    sample_crp = EvaluationKeyGen.sample_crp

    @staticmethod
    def sample_round1(gen: torch.Generator, params: Parameters) -> RelinRound1Sample:
        u = smp.sample(gen, params.ring_q, params.xs)
        digits = EvaluationKeyGen.num_digits(params)
        e0, e1 = [], []
        for _ in range(digits):
            e0.append(_sample_e(gen, params))
            e1.append(_sample_e(gen, params))
        return RelinRound1Sample(u=u, e0=e0, e1=e1)

    @staticmethod
    def round1_from_samples(params: Parameters, sk: K.SecretKey, crp: list,
                            s: RelinRound1Sample):
        """(the ephemeral secret u_i, the round-1 share list of (h0, h1))."""
        if len(s.e0) != len(crp) or len(s.e1) != len(crp):
            raise ValueError(f"{len(s.e0)} + {len(s.e1)} noise draws for {len(crp)} digits")
        rq, rp = params.ring_q, params.ring_p
        uq = rq.mform(rq.ntt(s.u))
        up = None
        if rp is not None:
            up = rp.mform(rp.ntt(K.extend_basis_small_norm(params.q[0], rp.moduli, s.u[0])))
        eph = K.SecretKey(value=K.QPPoly(q=uq, p=up))
        # P s_i out of the Montgomery domain (IMForm, :151)
        sP = rq.imform(rq.mul_scalar_montgomery(sk.value.q, _p_scalars(params)))
        shares = []
        for i, crp_i in enumerate(crp):
            e0 = _e_qp_from_sample(params, s.e0[i], ntt=True, mform=False)
            h0 = K.QPPoly(q=rq.add(e0.q, sP * _digit_mask(params, i)), p=e0.p)
            h0 = _qp_sub(params, h0, _qp_mul_mont(params, eph.value, crp_i))
            e1 = _e_qp_from_sample(params, s.e1[i], ntt=True, mform=False)
            shares.append((h0, _qp_add(params, e1, _qp_mul_mont(params, sk.value, crp_i))))
        return eph, shares

    @staticmethod
    def gen_share_round1(gen: torch.Generator, params: Parameters, sk: K.SecretKey,
                         crp: list):
        return RelinKeyGen.round1_from_samples(params, sk, crp,
                                               RelinKeyGen.sample_round1(gen, params))

    @staticmethod
    def sample_round2(gen: torch.Generator, params: Parameters) -> list[torch.Tensor]:
        return EvaluationKeyGen.sample_share(gen, params)

    @staticmethod
    def round2_from_samples(params: Parameters, eph: K.SecretKey, sk: K.SecretKey,
                            round1_agg, es: list[torch.Tensor]) -> list[K.QPPoly]:
        """round2_i = s_i h0 + (u_i - s_i) h1 + e2_i (:231-271)."""
        if len(es) != len(round1_agg):
            raise ValueError(f"{len(es)} noise draws for {len(round1_agg)} digits")
        delta = _qp_sub(params, eph.value, sk.value)
        out = []
        for (h0, h1), e in zip(round1_agg, es):
            t = _qp_mul_mont(params, h0, sk.value)
            t = _qp_add(params, t, _e_qp_from_sample(params, e, ntt=True, mform=False))
            out.append(_qp_add(params, t, _qp_mul_mont(params, delta, h1)))
        return out

    @staticmethod
    def gen_share_round2(gen: torch.Generator, params: Parameters, eph: K.SecretKey,
                         sk: K.SecretKey, round1_agg) -> list[K.QPPoly]:
        return RelinKeyGen.round2_from_samples(params, eph, sk, round1_agg,
                                               RelinKeyGen.sample_round2(gen, params))

    @staticmethod
    def aggregate_round1(params, s1, s2):
        return [(_qp_add(params, a0, b0), _qp_add(params, a1, b1))
                for (a0, a1), (b0, b1) in zip(s1, s2)]

    @staticmethod
    def aggregate_round2(params, s1, s2):
        return [_qp_add(params, a, b) for a, b in zip(s1, s2)]

    @staticmethod
    def finalize(params: Parameters, round1_agg, round2_agg) -> K.RelinearizationKey:
        rq, rp = params.ring_q, params.ring_p
        rows_q, rows_p = [], []
        for (_, h1), r2 in zip(round1_agg, round2_agg):
            rows_q.append(torch.stack([rq.mform(r2.q), rq.mform(h1.q)]))
            if rp is not None:
                rows_p.append(torch.stack([rp.mform(r2.p), rp.mform(h1.p)]))
        return K.RelinearizationKey(gadget=K.GadgetCiphertext(
            q=torch.stack(rows_q), p=torch.stack(rows_p) if rows_p else None))


# ---------------------------------------------------------------------------
# Collective key switching (keyswitch_sk.go / keyswitch_pk.go).
# ---------------------------------------------------------------------------

def _smudging_sigma(params: Parameters, sigma_smudge: float) -> smp.DiscreteGaussian:
    """The share's noise: sigma = sqrt(sigma_e^2 + sigma_smudge^2), bound 6 sigma."""
    e_fresh = params.xe.sigma
    sigma = math.sqrt(e_fresh * e_fresh + sigma_smudge * sigma_smudge)
    return smp.DiscreteGaussian(sigma=sigma, bound=6 * sigma)


def _smudged_share(params: Parameters, level: int, share: torch.Tensor, e: torch.Tensor,
                   is_ntt: bool) -> torch.Tensor:
    rq = params.ring_q.at_level(level)
    if is_ntt:
        return rq.add(share, rq.ntt(e))
    return rq.add(rq.intt(share), e)


class KeySwitch:
    """CKS: share_i = c1 (skIn_i - skOut_i) + e_i; out = (c0 + sum, c1)
    (keyswitch_sk.go:114-165)."""

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters, level: int,
                     sigma_smudge: float = 3.2) -> torch.Tensor:
        """The smudging noise at ``level`` (coefficient domain)."""
        return smp.sample(gen, params.ring_q.at_level(level),
                          _smudging_sigma(params, sigma_smudge))

    @staticmethod
    def share_from_sample(params: Parameters, sk_in: K.SecretKey, sk_out: K.SecretKey,
                          ct: Ciphertext, e: torch.Tensor) -> torch.Tensor:
        level = ct.level
        rq = params.ring_q.at_level(level)
        delta = rq.sub(sk_in.value.q[:level + 1], sk_out.value.q[:level + 1])
        share = rq.mul_coeffs_montgomery(ct.value[1], delta)
        return _smudged_share(params, level, share, e, ct.metadata.is_ntt)

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk_in: K.SecretKey,
                  sk_out: K.SecretKey, ct: Ciphertext, sigma_smudge: float = 3.2
                  ) -> torch.Tensor:
        return KeySwitch.share_from_sample(
            params, sk_in, sk_out, ct,
            KeySwitch.sample_share(gen, params, ct.level, sigma_smudge))

    @staticmethod
    def aggregate(params: Parameters, s1, s2):
        return params.ring_q.at_level(s1.shape[-2] - 1).add(s1, s2)

    @staticmethod
    def finalize(params: Parameters, ct: Ciphertext, agg) -> Ciphertext:
        rq = params.ring_q.at_level(ct.level)
        return ct.with_value((rq.add(ct.value[0], agg), ct.value[1]))


@dataclasses.dataclass(frozen=True)
class PublicKeySwitchSample:
    """A party's draws of PCKS: a public-key zero encryption's, then the
    smudging noise."""
    enc: enc_mod.PkSample
    e: torch.Tensor


class PublicKeySwitch:
    """PCKS: share_i = EncZero_pk + (c1 s_i + e, 0); out = (c0 + sum0, sum1)
    (keyswitch_pk.go:69-140)."""

    @staticmethod
    def sample_share(gen: torch.Generator, params: Parameters, level: int,
                     sigma_smudge: float = 3.2) -> PublicKeySwitchSample:
        z = enc_mod.sample_pk(gen, params, level)
        return PublicKeySwitchSample(enc=z, e=KeySwitch.sample_share(gen, params, level,
                                                                     sigma_smudge))

    @staticmethod
    def share_from_sample(params: Parameters, sk: K.SecretKey, pk: K.PublicKey,
                          ct: Ciphertext, s: PublicKeySwitchSample) -> tuple:
        level = ct.level
        rq = params.ring_q.at_level(level)
        z0, z1 = enc_mod.encrypt_zero_pk_from_sample(params, pk, s.enc, ct.metadata).value
        c1s = rq.mul_coeffs_montgomery(ct.value[1], sk.value.q[:level + 1])
        return rq.add(z0, _smudged_share(params, level, c1s, s.e, ct.metadata.is_ntt)), z1

    @staticmethod
    def gen_share(gen: torch.Generator, params: Parameters, sk: K.SecretKey,
                  pk: K.PublicKey, ct: Ciphertext, sigma_smudge: float = 3.2) -> tuple:
        return PublicKeySwitch.share_from_sample(
            params, sk, pk, ct,
            PublicKeySwitch.sample_share(gen, params, ct.level, sigma_smudge))

    @staticmethod
    def aggregate(params: Parameters, s1, s2):
        rq = params.ring_q.at_level(s1[0].shape[-2] - 1)
        return rq.add(s1[0], s2[0]), rq.add(s1[1], s2[1])

    @staticmethod
    def finalize(params: Parameters, ct: Ciphertext, agg) -> Ciphertext:
        rq = params.ring_q.at_level(ct.level)
        return ct.with_value((rq.add(ct.value[0], agg[0]), agg[1]))

"""PyTorch port, the multiparty protocols (multiparty/): the eight cases of
tests/test_multiparty.py at its sizes (CKKS at logN 7, Q 55 + 45 x 2 bits,
a 60-bit P, scale 2^45; BGV at logN 6, T = 65537), three parties, with
its bounds.

Every party's share is made by the port's ``share_from_sample(s)`` (and the
common reference polynomials by ``crp_*_from_samples``) from the arrays the
JAX package draws: ``Port`` below mirrors each of the JAX protocols' key
splits, ``Jax`` runs the JAX protocols themselves.  A case is one function
over (modules, context), so the same protocol runs on either side;
``tools/port_circuit_digests.py test_torch_multiparty`` pins the JAX
package's shares, finalized keys and outputs (``DIGESTS``), which the
port's must equal bit for bit.  Decrypted values are then held to the JAX
tests' bounds; the threshold case's recombined secret must equal the ideal
one exactly, and the BGV refresh's slots equal the input mod T.
"""

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import multiparty as jmp
from matrix_fhe_tpu.multiparty import mpbgv as jmpbgv
from matrix_fhe_tpu.multiparty import mpckks as jmpckks
from matrix_fhe_tpu.multiparty import protocols as jprot
from matrix_fhe_tpu.rlwe import encryptor as jenc
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu.schemes import bgv as jbgv
from matrix_fhe_tpu.schemes import ckks as jckks
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.multiparty import mpbgv as tmpbgv
from matrix_fhe_tpu_torch.multiparty import mpckks as tmpckks
from matrix_fhe_tpu_torch.multiparty import protocols as tprot
from matrix_fhe_tpu_torch.multiparty import threshold as tthr
from matrix_fhe_tpu_torch.rlwe import decryptor as tdec
from matrix_fhe_tpu_torch.rlwe import encryptor as tenc
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.schemes import bgv as tbgv
from matrix_fhe_tpu_torch.schemes import ckks as tckks
from matrix_fhe_tpu_torch.schemes.ckks import precision
from test_torch_matrix_ckks import _SAMPLE, _UNIFORM, pk_draws, sk_draws
from test_torch_polynomial import JAX, check_case
from test_torch_rlwe import _w

N_PARTIES = 3
T = 65537
POINTS = [1, 2, 3]
ACTIVES = [1, 3]
LOG_BOUND = 40
SMUDGE = jprot._smudging_sigma  # the JAX package's distribution, for its draws


def _literals(m):
    return (m.ckks.CKKSParametersLiteral(logn=7, logq=(55, 45, 45), logp=(60,),
                                         log_default_scale=45),
            m.bgv.BGVParametersLiteral(logn=6, t=T, logq=(45, 40, 40), logp=(50,)))


def _vectors(slots: int, n: int) -> dict:
    """tests/test_multiparty.py's inputs, from its generators."""
    def cplx(seed):
        rng = np.random.default_rng(seed)
        return rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    return {"cpk": cplx(0), "gal": cplx(1), "relin": np.random.default_rng(2).uniform(
        -1, 1, slots) + 0j, "cks": np.random.default_rng(3).uniform(-1, 1, slots) + 0j,
        "refresh": cplx(4), "transform": cplx(5),
        "bgv": np.random.default_rng(11).integers(0, T, n, dtype=np.uint64)}


def _ideal(params, sks):
    rq, rp = params.ring_q, params.ring_p
    q, p = sks[0].value.q, sks[0].value.p
    for s in sks[1:]:
        q, p = rq.add(q, s.value.q), rp.add(p, s.value.p)
    return q, p


class Jax:
    """The JAX package's protocols: every random part from its keys."""

    def __init__(self):
        lit, blit = _literals(JAX)
        self.params, self.bparams = jckks.new_parameters(lit), jbgv.new_parameters(blit)
        self.enc, self.benc = jckks.Encoder(self.params), jbgv.Encoder(self.bparams)
        self.sks = [JK.gen_secret_key(k, self.params)
                    for k in jax.random.split(jax.random.key(0), N_PARTIES)]
        self.bsks = [JK.gen_secret_key(k, self.bparams)
                     for k in jax.random.split(jax.random.key(50), N_PARTIES)]
        self.sk_outs = [JK.gen_secret_key(k, self.params)
                        for k in jax.random.split(jax.random.key(41), N_PARTIES)]
        self.sk_ideal = JK.SecretKey(value=JK.QPPoly(*_ideal(self.params, self.sks)))
        self.bsk_ideal = JK.SecretKey(value=JK.QPPoly(*_ideal(self.bparams, self.bsks)))
        self.v = _vectors(self.params.max_slots, self.bparams.n)

    def crp_qp(self, seed):
        return jmp.PublicKeyGen.sample_crp(jax.random.key(seed), self.params)

    def crp_list(self, seed):
        return jmp.EvaluationKeyGen.sample_crp(jax.random.key(seed), self.params)

    def crp_q(self, seed, params):
        return jmp.sample_crp_q(jax.random.key(seed), params, params.max_level)

    def cpk_share(self, seed, i, crp):
        return jmp.PublicKeyGen.gen_share(jax.random.key(seed), self.params, self.sks[i], crp)

    def gal_share(self, seed, i, gal_el, crp):
        return jmp.GaloisKeyGen.gen_share(jax.random.key(seed), self.params, self.sks[i],
                                          gal_el, crp)

    def relin_round1(self, seed, i, crp):
        return jmp.RelinKeyGen.gen_share_round1(jax.random.key(seed), self.params, self.sks[i],
                                                crp)

    def relin_round2(self, seed, i, eph, agg):
        return jmp.RelinKeyGen.gen_share_round2(jax.random.key(seed), self.params, eph,
                                                self.sks[i], agg)

    def cks_share(self, seed, i, ct):
        return jmp.KeySwitch.gen_share(jax.random.key(seed), self.params, self.sks[i],
                                       self.sk_outs[i], ct)

    def pcks_share(self, seed, i, pk, ct):
        return jmp.PublicKeySwitch.gen_share(jax.random.key(seed), self.params, self.sks[i],
                                             pk, ct)

    def shamir(self, seed, i, t):
        return jmp.Thresholdizer.gen_shamir_polynomial(jax.random.key(seed), self.params, t,
                                                       self.sks[i])

    def refresh_share(self, seed, mask_seed, i, ct, crs_poly, transform=None):
        return jmpckks.MaskedTransform.gen_share(
            jax.random.key(seed), mask_seed, self.params, self.sks[i], self.sks[i], LOG_BOUND,
            ct, crs_poly, self.params.default_scale, transform=transform)

    def bgv_refresh_share(self, seed, i, ct, crs_poly):
        return jmpbgv.Refresh.gen_share(jax.random.key(seed), self.bparams, self.bsks[i], ct,
                                        crs_poly)

    def encrypt(self, seed, params, key, pt):
        return jenc.encrypt(jax.random.key(seed), params, key, pt)


class Port:
    """The port's protocols, each share from the arrays JAX draws for it."""

    def __init__(self):
        lit, blit = _literals(JAX)
        self.jp, self.jbp = jckks.new_parameters(lit), jbgv.new_parameters(blit)
        self.params = carry.carry(self.jp, "cpu")
        self.bparams = carry.carry(self.jbp, "cpu")
        self.enc, self.benc = tckks.Encoder(self.params), tbgv.Encoder(self.bparams)

        def secrets(params, jp, seed):
            return [TK.secret_key_from_sample(params, _w(_SAMPLE(k, jp.ring_q, jp.xs)))
                    for k in jax.random.split(jax.random.key(seed), N_PARTIES)]
        self.sks = secrets(self.params, self.jp, 0)
        self.bsks = secrets(self.bparams, self.jbp, 50)
        self.sk_outs = secrets(self.params, self.jp, 41)
        self.sk_ideal = TK.SecretKey(value=TK.QPPoly(*_ideal(self.params, self.sks)))
        self.bsk_ideal = TK.SecretKey(value=TK.QPPoly(*_ideal(self.bparams, self.bsks)))
        self.v = _vectors(self.params.max_slots, self.bparams.n)

    # -- the JAX protocols' draws, in their key splits ---------------------------
    def _e(self, key, jp=None, level=None, dist=None):
        jp = self.jp if jp is None else jp
        ring = jp.ring_q if level is None else jp.ring_q.at_level(level)
        return _w(_SAMPLE(key, ring, jp.xe if dist is None else dist))

    def _digit_es(self, key):
        out = []
        for _ in range(tprot.EvaluationKeyGen.num_digits(self.params)):
            key, sub = jax.random.split(key)
            out.append(self._e(sub))
        return out

    def _crp_qp(self, key):
        kq, kp = jax.random.split(key)
        return tprot.crp_qp_from_samples(self.params, _w(_UNIFORM(kq, self.jp.ring_q)),
                                         _w(_UNIFORM(kp, self.jp.ring_p)))

    def crp_qp(self, seed):
        return self._crp_qp(jax.random.key(seed))

    def crp_list(self, seed):
        keys = jax.random.split(jax.random.key(seed),
                                tprot.EvaluationKeyGen.num_digits(self.params))
        return [self._crp_qp(k) for k in keys]

    def crp_q(self, seed, params):
        jp = self.jp if params is self.params else self.jbp
        return tprot.crp_q_from_samples(params, params.max_level,
                                        _w(_UNIFORM(jax.random.key(seed), jp.ring_q)))

    def cpk_share(self, seed, i, crp):
        return tprot.PublicKeyGen.share_from_sample(self.params, self.sks[i], crp,
                                                    self._e(jax.random.key(seed)))

    def gal_share(self, seed, i, gal_el, crp):
        return tprot.GaloisKeyGen.share_from_samples(self.params, self.sks[i], gal_el, crp,
                                                     self._digit_es(jax.random.key(seed)))

    def relin_round1(self, seed, i, crp):
        k_u, key = jax.random.split(jax.random.key(seed))
        e0, e1 = [], []
        for _ in crp:
            key, k0, k1 = jax.random.split(key, 3)
            e0.append(self._e(k0))
            e1.append(self._e(k1))
        s = tprot.RelinRound1Sample(u=_w(_SAMPLE(k_u, self.jp.ring_q, self.jp.xs)), e0=e0, e1=e1)
        return tprot.RelinKeyGen.round1_from_samples(self.params, self.sks[i], crp, s)

    def relin_round2(self, seed, i, eph, agg):
        return tprot.RelinKeyGen.round2_from_samples(self.params, eph, self.sks[i], agg,
                                                     self._digit_es(jax.random.key(seed)))

    def _smudge(self, key, level, jp=None):
        jp = self.jp if jp is None else jp
        return self._e(key, jp, level, SMUDGE(jp, 3.2))

    def cks_share(self, seed, i, ct):
        return tprot.KeySwitch.share_from_sample(self.params, self.sks[i], self.sk_outs[i], ct,
                                                 self._smudge(jax.random.key(seed), ct.level))

    def pcks_share(self, seed, i, pk, ct):
        k_enc, k_e = jax.random.split(jax.random.key(seed))
        s = tprot.PublicKeySwitchSample(enc=pk_draws(k_enc, self.jp, ct.level),
                                        e=self._smudge(k_e, ct.level))
        return tprot.PublicKeySwitch.share_from_sample(self.params, self.sks[i], pk, ct, s)

    def shamir(self, seed, i, t):
        key, coeffs = jax.random.key(seed), []
        for _ in range(t - 1):
            key, sub = jax.random.split(key)
            kq, kp = jax.random.split(sub)
            coeffs.append(TK.QPPoly(q=_w(_UNIFORM(kq, self.jp.ring_q)),
                                    p=_w(_UNIFORM(kp, self.jp.ring_p))))
        return tthr.Thresholdizer.shamir_polynomial_from_samples(self.params, self.sks[i],
                                                                 coeffs)

    def refresh_share(self, seed, mask_seed, i, ct, crs_poly, transform=None):
        k1, k2 = jax.random.split(jax.random.key(seed))
        s = tmpckks.MaskedTransformSample(e2s=self._smudge(k1, ct.level),
                                          s2e=self._smudge(k2, self.params.max_level))
        return tmpckks.MaskedTransform.share_from_sample(
            mask_seed, self.params,
            self.sks[i], self.sks[i], LOG_BOUND, ct, crs_poly, self.params.default_scale, s,
            transform=transform)

    def bgv_refresh_share(self, seed, i, ct, crs_poly):
        k1, k2 = jax.random.split(jax.random.key(seed))
        k_m, k_s = jax.random.split(k1)
        mask = np.asarray(jax.random.randint(k_m, (1, self.bparams.n), 0, T, dtype=np.int64))
        s = tmpbgv.RefreshSample(
            e2s=tmpbgv.EncToShareSample(mask_t=torch.from_numpy(mask.copy()),
                                        e=self._smudge(k_s, ct.level, self.jbp)),
            s2e=self._smudge(k2, self.bparams.max_level, self.jbp))
        return tmpbgv.Refresh.share_from_sample(self.bparams, self.bsks[i], ct, crs_poly, s)

    def encrypt(self, seed, params, key, pt):
        jp = self.jp if params is self.params else self.jbp
        draws = sk_draws if isinstance(key, TK.SecretKey) else pk_draws
        return tenc.encrypt_from_sample(params, key, pt, draws(jax.random.key(seed), jp,
                                                               pt.level))


def _sum(agg, shares, params):
    out = shares[0]
    for s in shares[1:]:
        out = agg(params, out, s)
    return out


def _gen_cpk(m, c, crs_seed=11):
    crp = c.crp_qp(crs_seed)
    shares = [c.cpk_share(100 + i, i, crp) for i in range(N_PARTIES)]
    return shares, m.mp.PublicKeyGen.finalize(
        c.params, _sum(m.mp.PublicKeyGen.aggregate, shares, c.params), crp)


def _cpk(m, c):
    shares, pk = _gen_cpk(m, c)
    ct = c.encrypt(5, c.params, pk, c.enc.encode(c.v["cpk"]))
    return shares + [pk, ct]


def _galois(m, c):
    gal_el = c.params.galois_element(1)
    crp = c.crp_list(21)
    shares = [c.gal_share(200 + i, i, gal_el, crp) for i in range(N_PARTIES)]
    gk = m.mp.GaloisKeyGen.finalize(c.params, _sum(m.mp.GaloisKeyGen.aggregate, shares,
                                                   c.params), crp, gal_el)
    ct = c.encrypt(6, c.params, c.sk_ideal, c.enc.encode(c.v["gal"]))
    return shares + [gk.gadget.q, gk.gadget.p, ct, m.rlwe_eval.automorphism(c.params, ct, gk)]


def _relin(m, c):
    crp = c.crp_list(31)
    r1 = [c.relin_round1(300 + i, i, crp) for i in range(N_PARTIES)]
    r1_agg = _sum(m.mp.RelinKeyGen.aggregate_round1, [s for _, s in r1], c.params)
    r2 = [c.relin_round2(400 + i, i, r1[i][0], r1_agg) for i in range(N_PARTIES)]
    rlk = m.mp.RelinKeyGen.finalize(c.params, r1_agg,
                                    _sum(m.mp.RelinKeyGen.aggregate_round2, r2, c.params))
    ev = m.ckks.Evaluator(c.params, rlk=rlk)
    ct = c.encrypt(7, c.params, c.sk_ideal, c.enc.encode(c.v["relin"]))
    return [e.value for e, _ in r1] + [s for _, s in r1] + r2 + [
        rlk.gadget.q, rlk.gadget.p, ct, ev.rescale(ev.mul_relin(ct, ct))]


def _cks_pcks(m, c):
    ct = c.encrypt(8, c.params, c.sk_ideal, c.enc.encode(c.v["cks"]))
    cks = [c.cks_share(500 + i, i, ct) for i in range(N_PARTIES)]
    ct2 = m.mp.KeySwitch.finalize(c.params, ct, _sum(m.mp.KeySwitch.aggregate, cks, c.params))
    _, pk_out = _gen_cpk(m, c, crs_seed=51)
    pcks = [c.pcks_share(600 + i, i, pk_out, ct) for i in range(N_PARTIES)]
    ct3 = m.mp.PublicKeySwitch.finalize(c.params, ct, _sum(m.mp.PublicKeySwitch.aggregate, pcks,
                                                           c.params))
    return [ct] + cks + [ct2] + pcks + [ct3]


def _threshold(m, c):
    t = 2
    received = {p: [] for p in POINTS}
    polys = []
    for i in range(N_PARTIES):
        spoly = c.shamir(700 + i, i, t)
        polys += spoly[1:]
        for p in POINTS:
            received[p].append(m.threshold.Thresholdizer.gen_shamir_secret_share(
                c.params, p, spoly))
    own = {p: _sum(m.threshold.Thresholdizer.aggregate, received[p], c.params) for p in POINTS}
    adds = [m.threshold.Combiner(c.params, p, POINTS, t).gen_additive_share(ACTIVES, own[p])
            for p in ACTIVES]
    return polys + [own[p] for p in POINTS] + [a.value for a in adds]


def _refresh(m, c, what, crs_seed, enc_seed, seed0, mask_seed0, transform=None):
    ct = c.encrypt(enc_seed, c.params, c.sk_ideal, c.enc.encode(c.v[what], level=0))
    crs_poly = c.crp_q(crs_seed, c.params)
    shares = [c.refresh_share(seed0 + i, mask_seed0 + i, i, ct, crs_poly, transform)
              for i in range(N_PARTIES)]
    agg = _sum(m.mpckks.MaskedTransform.aggregate, shares, c.params)
    out = m.mpckks.MaskedTransform.transform(c.params, ct, crs_poly, agg,
                                             c.params.default_scale, transform=transform)
    return [ct, crs_poly] + [x for s in shares for x in (s.e2s, s.s2e)] + [out]


def _flip(z):
    return -z  # a slot-wise linear transform applied during the refresh


def _bgv_refresh(m, c):
    ct = c.encrypt(51, c.bparams, c.bsk_ideal, c.benc.encode(c.v["bgv"], level=0))
    crs_poly = c.crp_q(52, c.bparams)
    shares = [c.bgv_refresh_share(60 + i, i, ct, crs_poly) for i in range(N_PARTIES)]
    agg = _sum(m.mpbgv.Refresh.aggregate, shares, c.bparams)
    return [ct, crs_poly] + [x for s in shares for x in s] + [
        m.mpbgv.Refresh.finalize(c.bparams, ct, agg, crs_poly)]


CASES = {
    "collective_public_key": _cpk,
    "collective_galois_key": _galois,
    "collective_relin_key": _relin,
    "cks_and_pcks": _cks_pcks,
    "threshold_shamir": _threshold,
    "refresh_masked_transform": lambda m, c: _refresh(m, c, "refresh", 61, 9, 800, 9000),
    "refresh_with_slot_transform": lambda m, c: _refresh(m, c, "transform", 71, 10, 900, 9900,
                                                         _flip),
    "bgv_refresh": _bgv_refresh,
}


def jax_context():
    return Jax()


# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "collective_public_key": "f602da67a5e4608fa1cceec510c2c687d1966f9abf64870a1a778db9ae133c91",
    "collective_galois_key": "5f1a5784feea8559b4474260080767d1348375c81ddfb8ddd054d62570f2b1d4",
    "collective_relin_key": "e209a28beb26a36efc47cbf61113ee9dca6aa21d1a9928e890726d219bace139",
    "cks_and_pcks": "e63ebde4a8296819c4964cee93b7aea9b317a41c7993b5a1502732a235ee509e",
    "threshold_shamir": "3b44af3dbdcf6505aba2ef4549fa0c197a80a70e3b652b69940b52952eda0cc1",
    "refresh_masked_transform": "5c4b82ed057bd2f1ba2022f82ec5d10c18cd58b7449d0fa3286827387e20a8b4",
    "refresh_with_slot_transform": "f207fb79924efec61e40d0f17736619149aefeadba493083c5e66588e6db2a81",
    "bgv_refresh": "0a1a5a9b081875c8428f213cbb096ad875b7ef024145b6d8ff4870780c3ea42a",
}


@pytest.fixture(scope="module")
def ctx():
    return Port()


def _dec(c, sk, ct):
    return c.enc.decode(tdec.decrypt(c.params, sk, ct))


def test_collective_public_key(ctx):
    """tests/test_multiparty.py:44: 15 bits under the ideal secret."""
    ct = check_case(CASES, DIGESTS, "collective_public_key", ctx)[-1]
    precision.assert_precision(ctx.v["cpk"], _dec(ctx, ctx.sk_ideal, ct), 15)


def test_collective_galois_key(ctx):
    """tests/test_multiparty.py:54: a rotation by one slot, 12 bits."""
    rot = check_case(CASES, DIGESTS, "collective_galois_key", ctx)[-1]
    precision.assert_precision(np.roll(ctx.v["gal"], -1), _dec(ctx, ctx.sk_ideal, rot), 12)


def test_collective_relin_key(ctx):
    """tests/test_multiparty.py:74: two rounds, then v^2 to 10 bits."""
    out = check_case(CASES, DIGESTS, "collective_relin_key", ctx)[-1]
    v = ctx.v["relin"]
    precision.assert_precision(v * v, _dec(ctx, ctx.sk_ideal, out), 10)


def test_cks_and_pcks(ctx):
    """tests/test_multiparty.py:102: to a fresh collective key (12 bits) and
    to a public key (10 bits)."""
    outs = check_case(CASES, DIGESTS, "cks_and_pcks", ctx)
    ct2, ct3 = outs[1 + N_PARTIES], outs[-1]
    sk_out = TK.SecretKey(value=TK.QPPoly(*_ideal(ctx.params, ctx.sk_outs)))
    precision.assert_precision(ctx.v["cks"], _dec(ctx, sk_out, ct2), 12)
    precision.assert_precision(ctx.v["cks"], _dec(ctx, ctx.sk_ideal, ct3), 10)


def test_threshold_shamir(ctx):
    """tests/test_multiparty.py:141: parties {1, 3} of a 2-of-3 sharing
    recombine an additive sharing of the ideal secret, exactly."""
    outs = check_case(CASES, DIGESTS, "threshold_shamir", ctx)
    a, b = outs[-2:]
    rq, rp = ctx.params.ring_q, ctx.params.ring_p
    assert torch.equal(rq.add(a.q, b.q), ctx.sk_ideal.value.q)
    assert torch.equal(rp.add(a.p, b.p), ctx.sk_ideal.value.p)
    with pytest.raises(ValueError, match="active"):
        tthr.Combiner(ctx.params, 1, POINTS, 2).gen_additive_share([1], outs[N_PARTIES])


def test_refresh_masked_transform(ctx):
    """tests/test_multiparty.py:175: level 0 -> the top level, 10 bits."""
    outs = check_case(CASES, DIGESTS, "refresh_masked_transform", ctx)
    assert outs[0].level == 0 and outs[-1].level == ctx.params.max_level
    precision.assert_precision(ctx.v["refresh"], _dec(ctx, ctx.sk_ideal, outs[-1]), 10)


def test_refresh_with_slot_transform(ctx):
    """tests/test_multiparty.py:202: the refresh applying z -> -z, 8 bits."""
    out = check_case(CASES, DIGESTS, "refresh_with_slot_transform", ctx)[-1]
    precision.assert_precision(-ctx.v["transform"], _dec(ctx, ctx.sk_ideal, out), 8)


def test_bgv_refresh(ctx):
    """tests/test_multiparty.py:225: the BGV refresh, exact mod T."""
    outs = check_case(CASES, DIGESTS, "bgv_refresh", ctx)
    assert outs[0].level == 0 and outs[-1].level == ctx.bparams.max_level
    got = ctx.benc.decode(tdec.decrypt(ctx.bparams, ctx.bsk_ideal, outs[-1]))
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), ctx.v["bgv"])


def test_sample_mask_and_carry(ctx):
    """sample_mask is deterministic: the JAX package's own draw; and the
    refresh's shares carry over from JAX objects."""
    for seed, count, bound in ((9000, 256, 40), (7, 5, 3)):
        assert tmpckks.sample_mask(seed, count, bound) == jmpckks.sample_mask(seed, count, bound)
    ct = ctx.encrypt(9, ctx.params, ctx.sk_ideal, ctx.enc.encode(ctx.v["refresh"], level=0))
    share = ctx.refresh_share(800, 9000, 0, ct, ctx.crp_q(61, ctx.params))
    jshare = jmpckks.RefreshShare(e2s=share.e2s.numpy().view(np.uint64),
                                  s2e=share.s2e.numpy().view(np.uint64),
                                  metadata=jax_metadata(share.metadata))
    back = carry.carry(jshare, "cpu")
    assert torch.equal(back.e2s, share.e2s) and torch.equal(back.s2e, share.s2e)
    assert back.metadata == share.metadata


def jax_metadata(md):
    from matrix_fhe_tpu.rlwe.elements import MetaData
    return MetaData(scale=md.scale, log_dimensions=md.log_dimensions, is_batched=md.is_batched,
                    is_ntt=md.is_ntt, is_montgomery=md.is_montgomery)

"""Multiparty private set intersection (PSI) over BGV.

Counterpart of ``examples/multiparty_psi.py`` (the reference's
examples/multiparty/int_psi/main.go): each party encodes its set as a 0/1
indicator vector and encrypts it under a collectively generated key; the
cloud multiplies all ciphertexts slot-wise (the product is 1 exactly where
every party has the element); the parties collectively switch the result
to the querier's key.

    python -m matrix_fhe_tpu_torch.examples.multiparty_psi [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch import multiparty as mp
from matrix_fhe_tpu_torch.examples import cli, crs, generator, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import bgv

T = 65537
N_PARTIES = 3


def main(device="cuda", seed: int = 0) -> dict:
    params = bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=7, t=T, logq=(55, 45, 45), logp=(61,)), device)
    enc = bgv.Encoder(params)

    sks = [K.gen_secret_key(g, params) for g in generators(seed, N_PARTIES)]

    # --- collective pk ------------------------------------------------------
    crp = mp.PublicKeyGen.sample_crp(crs(42), params)
    agg = None
    for i, sk in enumerate(sks):
        s = mp.PublicKeyGen.gen_share(generator(seed, 100 + i), params, sk, crp)
        agg = s if agg is None else mp.PublicKeyGen.aggregate(params, agg, s)
    cpk = mp.PublicKeyGen.finalize(params, agg, crp)

    # --- collective relinearization key (2 rounds) --------------------------
    crp_r = mp.RelinKeyGen.sample_crp(crs(43), params)
    ephs, r1 = [], None
    for i, sk in enumerate(sks):
        eph, s1 = mp.RelinKeyGen.gen_share_round1(generator(seed, 200 + i), params, sk, crp_r)
        ephs.append(eph)
        r1 = s1 if r1 is None else mp.RelinKeyGen.aggregate_round1(params, r1, s1)
    r2 = None
    for i, sk in enumerate(sks):
        s2 = mp.RelinKeyGen.gen_share_round2(generator(seed, 300 + i), params, ephs[i], sk, r1)
        r2 = s2 if r2 is None else mp.RelinKeyGen.aggregate_round2(params, r2, s2)
    rlk = mp.RelinKeyGen.finalize(params, r1, r2)
    print(f"collective pk + rlk generated by {N_PARTIES} parties")

    # --- each party encrypts its set's indicator vector ---------------------
    rng = np.random.default_rng(seed + 5)
    universe = params.n
    sets = [set(rng.choice(universe, universe // 2, replace=False).tolist())
            for _ in range(N_PARTIES)]
    cts = []
    for i, s in enumerate(sets):
        ind = np.zeros(universe, dtype=np.int64)
        ind[list(s)] = 1
        cts.append(encryptor.encrypt(generator(seed, 400 + i), params, cpk, enc.encode(ind)))

    # --- cloud: slot-wise product of all indicators --------------------------
    ev = bgv.Evaluator(params, rlk=rlk)
    acc = cts[0]
    for ct in cts[1:]:
        acc = ev.rescale(ev.mul_relin(acc, ct))

    # --- collective key switch to the querier -------------------------------
    sk_q = K.gen_secret_key(generator(seed, 9), params)
    zero = K.SecretKey(value=K.QPPoly(q=sk_q.value.q * 0, p=sk_q.value.p * 0))
    shares = [mp.KeySwitch.gen_share(generator(seed, 500 + i), params, sk, zero, acc)
              for i, sk in enumerate(sks)]
    shares.append(mp.KeySwitch.gen_share(generator(seed, 600), params, zero, sk_q, acc))
    ks_agg = shares[0]
    for s in shares[1:]:
        ks_agg = mp.KeySwitch.aggregate(params, ks_agg, s)
    ct_out = mp.KeySwitch.finalize(params, acc, ks_agg)

    pt = decryptor.decrypt(params, sk_q, ct_out)
    got = enc.decode(pt)
    inter = set.intersection(*sets)
    want = np.zeros(universe, dtype=np.int64)
    want[list(inter)] = 1
    assert np.array_equal(got, want)
    print(f"PSI of {N_PARTIES} sets over a universe of {universe}: "
          f"|intersection| = {len(inter)}, exact")
    return {"words": {"intersection": pt.value}, "decoded": {"intersection": got}}


if __name__ == "__main__":
    cli(main)

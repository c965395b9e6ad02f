"""t-out-of-N threshold key generation and decryption.

Counterpart of ``examples/multiparty_threshold_keygen.py`` (the
reference's examples/multiparty/thresh_eval_key_gen): N parties
Shamir-share their additive secrets so that ANY t of them can later stand
in for the full set: here 2 of 3 parties regenerate an additive sharing of
the ideal key, produce a collective public key, and key-switch a result to
a receiver — the third party stays offline throughout.

    python -m matrix_fhe_tpu_torch.examples.multiparty_threshold_keygen [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch import multiparty as mp
from matrix_fhe_tpu_torch.examples import cli, crs, generator, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks

N_PARTIES, THRESHOLD = 3, 2
POINTS = [1, 2, 3]  # public Shamir evaluation points, one per party


def main(device="cuda", seed: int = 0) -> dict:
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45), logp=(60,), log_default_scale=45), device)
    enc = ckks.Encoder(params)

    # each party holds an additive share sk_i of the ideal key
    sks = [K.gen_secret_key(g, params) for g in generators(seed, N_PARTIES)]

    # --- thresholdize: everyone Shamir-shares its sk_i to everyone ---------
    received = {p: [] for p in POINTS}
    for i in range(N_PARTIES):
        spoly = mp.Thresholdizer.gen_shamir_polynomial(
            generator(seed, 100 + i), params, THRESHOLD, sks[i])
        for p in POINTS:
            received[p].append(mp.Thresholdizer.gen_shamir_secret_share(params, p, spoly))
    own = {}
    for p in POINTS:
        agg = received[p][0]
        for s in received[p][1:]:
            agg = mp.Thresholdizer.aggregate(params, agg, s)
        own[p] = agg

    # --- only parties {1, 3} are online: rebuild additive shares -----------
    actives = [1, 3]
    tsk = {p: mp.Combiner(params, p, POINTS, THRESHOLD).gen_additive_share(actives, own[p])
           for p in actives}
    print(f"{len(actives)} of {N_PARTIES} parties online (threshold t={THRESHOLD})")

    # --- collective pk from the threshold shares ----------------------------
    crp = mp.PublicKeyGen.sample_crp(crs(42), params)
    agg = None
    for j, p in enumerate(actives):
        share = mp.PublicKeyGen.gen_share(generator(seed, 200 + j), params, tsk[p], crp)
        agg = share if agg is None else mp.PublicKeyGen.aggregate(params, agg, share)
    cpk = mp.PublicKeyGen.finalize(params, agg, crp)

    # --- encrypt, compute, threshold key-switch to the receiver ------------
    rng = np.random.default_rng(seed + 1)
    v = rng.uniform(-1, 1, params.max_slots)
    ct = encryptor.encrypt(generator(seed, 7), params, cpk, enc.encode(v))
    ev = ckks.Evaluator(params)
    ct = ev.add(ct, ct)  # 2v

    sk_rx = K.gen_secret_key(generator(seed, 9), params)
    zero = K.SecretKey(value=K.QPPoly(q=sk_rx.value.q * 0, p=sk_rx.value.p * 0))
    shares = [mp.KeySwitch.gen_share(generator(seed, 300 + j), params, tsk[p], zero, ct)
              for j, p in enumerate(actives)]
    shares.append(mp.KeySwitch.gen_share(generator(seed, 400), params, zero, sk_rx, ct))
    agg = shares[0]
    for s in shares[1:]:
        agg = mp.KeySwitch.aggregate(params, agg, s)
    ct_rx = mp.KeySwitch.finalize(params, ct, agg)

    pt = decryptor.decrypt(params, sk_rx, ct_rx)
    got = np.real(enc.decode(pt))
    err = float(np.max(np.abs(got - 2 * v)))
    print(f"threshold key-switched result: max err {err:.2e}")
    assert err < 1e-3
    return {"words": {"key-switched": pt.value}, "decoded": {"key-switched": got}, "err": err}


if __name__ == "__main__":
    cli(main)

"""Multiparty demo: collective keygen + encrypted compute + collective
key switch back to a receiver.

Counterpart of ``examples/multiparty_pir.py`` (in spirit the reference's
examples/multiparty/int_pir): N parties with additive key shares produce a
collective public key, a client encrypts under it, computation happens
homomorphically, and the parties key-switch the result to the client's
personal key.

    python -m matrix_fhe_tpu_torch.examples.multiparty_pir [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch import multiparty as mp
from matrix_fhe_tpu_torch.examples import cli, crs, generator, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks

N_PARTIES = 3


def main(device="cuda", seed: int = 0) -> dict:
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45), logp=(60,), log_default_scale=45), device)
    enc = ckks.Encoder(params)

    # each party has an additive secret share
    sks = [K.gen_secret_key(g, params) for g in generators(seed, N_PARTIES)]

    # collective public key from a shared CRS
    crp = mp.PublicKeyGen.sample_crp(crs(42), params)
    agg = None
    for i, sk in enumerate(sks):
        share = mp.PublicKeyGen.gen_share(generator(seed, 100 + i), params, sk, crp)
        agg = share if agg is None else mp.PublicKeyGen.aggregate(params, agg, share)
    cpk = mp.PublicKeyGen.finalize(params, agg, crp)
    print(f"collective pk generated by {N_PARTIES} parties")

    # client encrypts a query under the collective key
    rng = np.random.default_rng(seed + 1)
    v = rng.uniform(-1, 1, params.max_slots)
    ct = encryptor.encrypt(generator(seed, 7), params, cpk, enc.encode(v))

    # servers compute homomorphically (here: scale by 0.5)
    ev = ckks.Evaluator(params)
    ct = ev.rescale(ev.mul_const(ct, 0.5))

    # parties collectively switch the result to the client's own key
    sk_client = K.gen_secret_key(generator(seed, 9), params)
    zero = K.SecretKey(value=K.QPPoly(q=sk_client.value.q * 0, p=sk_client.value.p * 0))
    shares = []
    for i, sk in enumerate(sks):
        # party i switches its share of sum(sk_i) to 0; the client's key is
        # added by the last party (client) switching 0 -> sk_client
        shares.append(mp.KeySwitch.gen_share(generator(seed, 200 + i), params, sk, zero, ct))
    shares.append(mp.KeySwitch.gen_share(generator(seed, 300), params, zero, sk_client, ct))
    agg = shares[0]
    for s in shares[1:]:
        agg = mp.KeySwitch.aggregate(params, agg, s)
    ct_out = mp.KeySwitch.finalize(params, ct, agg)

    pt = decryptor.decrypt(params, sk_client, ct_out)
    got = np.real(enc.decode(pt))
    err = float(np.max(np.abs(got - 0.5 * v)))
    print(f"key-switched result: max err {err:.2e}")
    assert err < 1e-3
    return {"words": {"key-switched": pt.value}, "decoded": {"key-switched": got}, "err": err}


if __name__ == "__main__":
    cli(main)

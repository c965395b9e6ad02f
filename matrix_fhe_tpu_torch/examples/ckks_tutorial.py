"""CKKS tutorial: encode -> encrypt -> compute -> decrypt -> decode.

Counterpart of ``examples/ckks_tutorial.py`` (the reference's
examples/singleparty/tutorials/ckks/main.go), on insecure demo parameters
(LogN=7):

    python -m matrix_fhe_tpu_torch.examples.ckks_tutorial [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks


def main(device="cuda", seed: int = 0) -> dict:
    # Parameters: ring degree 2^7, 55+45+45-bit moduli, one auxiliary prime.
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45, 45), logp=(61,), log_default_scale=45), device)
    print(f"N={params.n}, levels={params.max_level + 1}, slots={params.max_slots}")

    enc = ckks.Encoder(params)
    ks, kp, kr, kg, k1, k2 = generators(seed, 6)
    sk = K.gen_secret_key(ks, params)
    pk = K.gen_public_key(kp, params, sk)
    rlk = K.gen_relinearization_key(kr, params, sk)
    gks = K.gen_galois_keys(kg, params, sk, [params.galois_element(1)])
    ev = ckks.Evaluator(params, rlk=rlk, galois_keys=gks)

    rng = np.random.default_rng(seed)
    v1 = rng.uniform(-1, 1, params.max_slots)
    v2 = rng.uniform(-1, 1, params.max_slots)

    ct1 = encryptor.encrypt(k1, params, pk, enc.encode(v1))
    ct2 = encryptor.encrypt(k2, params, sk, enc.encode(v2))

    # homomorphic: (v1 + v2), (v1 * v2), rot(v1, 1)
    ct_add = ev.add(ct1, ct2)
    ct_mul = ev.rescale(ev.mul_relin(ct1, ct2))
    ct_rot = ev.rotate(ct1, 1)

    out = {"words": {}, "decoded": {}, "err": {}}
    for name, ct, want in [("add", ct_add, v1 + v2),
                           ("mul", ct_mul, v1 * v2),
                           ("rot", ct_rot, np.roll(v1, -1))]:
        pt = decryptor.decrypt(params, sk, ct)
        got = np.real(enc.decode(pt))
        err = float(np.max(np.abs(got - want)))
        print(f"{name:>4}: max err {err:.2e} ({-np.log2(err):.1f} bits)")
        assert err < 1e-4
        out["words"][name], out["decoded"][name], out["err"][name] = pt.value, got, err
    return out


if __name__ == "__main__":
    cli(main)

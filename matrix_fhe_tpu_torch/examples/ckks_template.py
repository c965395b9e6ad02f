"""CKKS starter template: parameters, keys, encode/encrypt, the core
evaluator ops, decrypt/decode — the boilerplate to copy for a new workload.

Counterpart of ``examples/ckks_template.py`` (the reference's
examples/singleparty/templates/ckks/main.go), on insecure demo parameters
(LogN=7):

    python -m matrix_fhe_tpu_torch.examples.ckks_template [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks


def main(device="cuda", seed: int = 0) -> dict:
    # --- parameters (templates/ckks/main.go uses LogN=14; demo uses 7) ----
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=7, logq=(55, 45, 45, 45), logp=(61,), log_default_scale=45), device)

    # --- key material ------------------------------------------------------
    ks, kp, kr, kg, ke = generators(seed, 5)
    sk = K.gen_secret_key(ks, params)
    pk = K.gen_public_key(kp, params, sk)
    rlk = K.gen_relinearization_key(kr, params, sk)
    rots = [1, 4]
    gks = K.gen_galois_keys(kg, params, sk, [params.galois_element(r) for r in rots])

    enc = ckks.Encoder(params)
    ev = ckks.Evaluator(params, rlk=rlk, galois_keys=gks)

    # --- encode + encrypt ---------------------------------------------------
    rng = np.random.default_rng(seed)
    want = rng.uniform(-1, 1, params.max_slots)
    ct = encryptor.encrypt(ke, params, pk, enc.encode(want))

    # --- the template circuit: 0.5 * (x + x^2) + rot(x, 1) ------------------
    ct2 = ev.rescale(ev.mul_relin(ct, ct))            # x^2, one level down
    acc = ev.add(ct2, ct)                             # x^2 + x
    acc = ev.rescale(ev.mul_const(acc, 0.5))          # * 0.5
    acc = ev.add(acc, ev.rotate(ct, 1))               # + rot(x, 1)

    pt = decryptor.decrypt(params, sk, acc)
    got = np.real(enc.decode(pt))
    ref = 0.5 * (want + want ** 2) + np.roll(want, -1)
    err = float(np.max(np.abs(got - ref)))
    print(f"template circuit: level {acc.level}, max err {err:.2e}")
    assert err < 1e-4
    return {"words": {"template": pt.value}, "decoded": {"template": got}, "err": err}


if __name__ == "__main__":
    cli(main)

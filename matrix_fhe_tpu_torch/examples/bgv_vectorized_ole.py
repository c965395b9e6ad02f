"""Vectorized oblivious linear evaluation (OLE) over Z_t with BGV.

Counterpart of ``examples/bgv_vectorized_ole.py`` (the reference's
examples/singleparty/bgv_vectorized_ole/main.go): a receiver encrypts x;
the sender computes z = a*x + b homomorphically without learning x; the
receiver decrypts z without learning (a, b) beyond the relation.

    python -m matrix_fhe_tpu_torch.examples.bgv_vectorized_ole [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import bgv

T = 65537


def main(device="cuda", seed: int = 0) -> dict:
    params = bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=7, t=T, logq=(55, 45), logp=(61,)), device)
    enc = bgv.Encoder(params)

    # receiver: keys + encrypted input
    ks, kp, ke = generators(seed, 3)
    sk = K.gen_secret_key(ks, params)
    pk = K.gen_public_key(kp, params, sk)
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, T, params.n)
    ct_x = encryptor.encrypt(ke, params, pk, enc.encode(x))

    # sender: batched affine map with plaintext (a, b) — one ct-pt multiply
    # and one ct-pt add for n OLEs at once
    a = rng.integers(1, T, params.n)
    b = rng.integers(0, T, params.n)
    ev = bgv.Evaluator(params)
    ct_z = ev.add(ev.mul(ct_x, enc.encode(a)), enc.encode(b))

    # receiver decrypts z = a*x + b
    pt = decryptor.decrypt(params, sk, ct_z)
    z = enc.decode(pt)
    assert np.array_equal(z, (a * x + b) % T)
    print(f"vectorized OLE: {params.n} evaluations of z = a*x + b mod {T}, all exact")
    return {"words": {"z": pt.value}, "decoded": {"z": z}}


if __name__ == "__main__":
    cli(main)

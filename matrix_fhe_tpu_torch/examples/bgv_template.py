"""BGV starter template: exact integer SIMD arithmetic mod t.

Counterpart of ``examples/bgv_template.py`` (the reference's
examples/singleparty/templates/bgv/main.go), on insecure demo parameters:

    python -m matrix_fhe_tpu_torch.examples.bgv_template [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import bgv

T = 65537  # plaintext modulus, t = 1 mod 2N


def main(device="cuda", seed: int = 0) -> dict:
    params = bgv.new_parameters(bgv.BGVParametersLiteral(
        logn=7, t=T, logq=(55, 45, 45), logp=(61,)), device)

    ks, kp, kr, kg, k1, k2 = generators(seed, 6)
    sk = K.gen_secret_key(ks, params)
    pk = K.gen_public_key(kp, params, sk)
    rlk = K.gen_relinearization_key(kr, params, sk)
    gks = K.gen_galois_keys(kg, params, sk, [params.galois_element(2)])

    enc = bgv.Encoder(params)
    ev = bgv.Evaluator(params, rlk=rlk, galois_keys=gks)

    rng = np.random.default_rng(seed)
    a = rng.integers(0, T, params.n)
    b = rng.integers(0, T, params.n)
    ct_a = encryptor.encrypt(k1, params, pk, enc.encode(a))
    ct_b = encryptor.encrypt(k2, params, sk, enc.encode(b))

    # the template circuit: a*b + b, then rotate columns by 2
    ct = ev.add(ev.mul_relin(ct_a, ct_b), ct_b)
    ct = ev.rescale(ct)
    ct = ev.rotate_columns(ct, 2)

    pt = decryptor.decrypt(params, sk, ct)
    got = enc.decode(pt)
    half = params.n // 2
    ref = (a * b + b) % T
    ref = np.concatenate([np.roll(ref[:half], -2), np.roll(ref[half:], -2)])
    assert np.array_equal(got, ref)
    print(f"BGV template: exact match on {params.n} slots mod {T}")
    return {"words": {"template": pt.value}, "decoded": {"template": got}}


if __name__ == "__main__":
    cli(main)

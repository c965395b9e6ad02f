"""Blind rotation (LMKCDEY): evaluate an arbitrary function via its LUT.

Counterpart of ``examples/rgsw_blind_rotation.py`` (the reference's
examples/singleparty/rgsw_blind_rotations/main.go): encrypt small LWE
samples, then homomorphically evaluate sign(x) by blind-rotating a test
polynomial holding the function's look-up table.

    python -m matrix_fhe_tpu_torch.examples.rgsw_blind_rotation [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from matrix_fhe_tpu_torch import rlwe as rlwe_pkg
from matrix_fhe_tpu_torch.examples import cli, generator, generators
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rgsw import blindrot
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered
from matrix_fhe_tpu_torch.utils import primes as pr


def sign(x: float) -> float:
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def main(device="cuda", seed: int = 0) -> dict:
    # blind-rotation ring (insecure demo sizes; reference uses LogN=10)
    n_br = 1 << 8
    q_br = pr.NTTFriendlyPrimesGenerator(25, 2 * n_br).next_alternating_primes(1)
    p_br = pr.NTTFriendlyPrimesGenerator(29, 2 * n_br).next_alternating_primes(1)
    params_br = rlwe_pkg.new_parameters(rlwe_pkg.ParametersLiteral(
        logn=8, q=tuple(q_br), p=tuple(p_br)), device)

    # small LWE parameters for the inputs
    n_lwe = 1 << 5
    q_lwe = pr.NTTFriendlyPrimesGenerator(13, 2 * n_lwe).next_alternating_primes(1)
    params_lwe = rlwe_pkg.new_parameters(rlwe_pkg.ParametersLiteral(
        logn=5, q=tuple(q_lwe), xs=smp.Ternary(h=8)), device)

    k0, k1, k2 = generators(seed, 3)
    sk_br = K.gen_secret_key(k0, params_br)
    sk_lwe = K.gen_secret_key(k1, params_lwe)
    brk = blindrot.gen_evaluation_key(k2, params_br, sk_br, params_lwe, sk_lwe)

    scale_lwe, scale_br = q_lwe[0] / 4.0, q_br[0] / 4.0
    slots = 4
    test_poly = blindrot.init_test_polynomial(sign, scale_br, params_br, -1, 1)
    test_map = {i: test_poly for i in range(slots)}

    values = np.array([-0.75, -0.3, 0.4, 0.8])
    coeffs = np.zeros((1, params_lwe.n), dtype=np.int64)
    for i, v in enumerate(values):
        c = int(round(abs(v) * scale_lwe))
        coeffs[0, i] = (q_lwe[0] - c) % q_lwe[0] if v < 0 else c
    ring = params_lwe.ring_q
    pt = Plaintext(value=ring.ntt(torch.from_numpy(coeffs).to(params_lwe.device)),
                   metadata=MetaData(is_ntt=True))
    ct = encryptor.encrypt(generator(seed, 3), params_lwe, sk_lwe, pt)

    ev = blindrot.Evaluator(params_br, params_lwe)
    out = ev.evaluate(ct, test_map, brk)

    words, got_all = {}, []
    for i, v in enumerate(values):
        ptd = decryptor.decrypt(params_br, sk_br, out[i])
        c = params_br.ring_q.intt(ptd.value)
        dec = crt_reconstruct_centered(c.cpu().numpy(), params_br.q)
        got = float(dec[0]) / scale_br
        print(f"sign({v:+.2f}) = {got:+.3f}")
        assert abs(got - sign(v)) < 0.1
        words[f"slot {i}"] = ptd.value
        got_all.append(got)
    return {"words": words, "decoded": {"sign": np.array(got_all)}}


if __name__ == "__main__":
    cli(main)

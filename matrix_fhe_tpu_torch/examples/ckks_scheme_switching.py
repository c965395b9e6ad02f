"""Scheme switching: standard (complex) CKKS <-> conjugate-invariant (real).

Counterpart of ``examples/ckks_scheme_switching.py`` (the reference's
examples/singleparty/ckks_scheme_switching/main.go): move a real-valued
ciphertext from the standard ring Z[X]/(X^N+1) into the conjugate-invariant
ring Z[X+X^-1]/(X^N+1) of half the degree (2x cheaper real arithmetic),
compute there, and switch back.  On the card the CI ring's NTT is kernel
B4's CI mode.

    python -m matrix_fhe_tpu_torch.examples.ckks_scheme_switching [--device cpu]
"""

from __future__ import annotations

import numpy as np

from matrix_fhe_tpu_torch.examples import cli, generators
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K
from matrix_fhe_tpu_torch.schemes import ckks
from matrix_fhe_tpu_torch.schemes.ckks import bridge
from matrix_fhe_tpu_torch.utils import primes as pr


def main(device="cuda", seed: int = 0) -> dict:
    logn = 7
    n = 1 << logn
    q = tuple(pr.NTTFriendlyPrimesGenerator(45, 2 * n).next_alternating_primes(3))
    p = tuple(pr.NTTFriendlyPrimesGenerator(55, 2 * n).next_alternating_primes(1))
    params_std = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=logn, q=q, p=p, log_default_scale=40, ring_type="standard"), device)
    params_ci = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=logn - 1, q=q, p=p, log_default_scale=40,
        ring_type="conjugate_invariant"), device)
    print(f"standard N={params_std.n} ({params_std.max_slots} complex slots) "
          f"<-> conjugate-invariant N={params_ci.n} "
          f"({params_ci.max_slots} real slots)")

    k0, k1, k2, ke = generators(seed, 4)
    sk_std = K.gen_secret_key(k0, params_std)
    sk_ci = K.gen_secret_key(k1, params_ci)
    s2c, c2s = bridge.gen_ring_swap_keys_ci(k2, params_std, sk_std, sk_ci)

    enc_std = ckks.Encoder(params_std)
    ev_ci = ckks.Evaluator(params_ci)

    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, params_std.max_slots)
    ct = encryptor.encrypt(ke, params_std, sk_std, enc_std.encode(v + 0j))

    # switch to the CI ring, compute 2x there, switch back
    ct_ci = bridge.complex_to_real(params_std, ct, s2c)
    ct_ci = ev_ci.add(ct_ci, ct_ci)
    ct_std = bridge.real_to_complex(params_std, ct_ci, c2s)

    pt = decryptor.decrypt(params_std, sk_std, ct_std)
    got = np.real(enc_std.decode(pt))
    err = float(np.max(np.abs(got - 2 * v)))
    print(f"round trip std -> CI -> std with one CI add: max err {err:.2e}")
    assert err < 1e-3
    return {"words": {"round trip": pt.value}, "decoded": {"round trip": got}, "err": err}


if __name__ == "__main__":
    cli(main)

"""CKKS bootstrapping: refresh an exhausted ciphertext back to the top of
the modulus chain, then keep computing on it.

Counterpart of ``examples/ckks_bootstrapping.py`` (the reference's
examples/singleparty/ckks_bootstrapping/basic/main.go): build bootstrapping
parameters, generate the evaluation keys (relinearization + the DFT
rotation set), drain a ciphertext to level 0 with multiplications,
bootstrap, and verify the refreshed ciphertext still decrypts correctly and
supports more multiplications; then the META-BTS high-precision variant.
Demo degree 2^6 (insecure), reference-shaped 45/55-bit chain
(default_parameters.go):

    python -m matrix_fhe_tpu_torch.examples.ckks_bootstrapping [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
from matrix_fhe_tpu_torch.examples import cli, generator
from matrix_fhe_tpu_torch.fast import fboot
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K


def main(device="cuda", seed: int = 0) -> dict:
    t0 = time.perf_counter()

    # --- bootstrapping parameters (parameters_literal.go budgeting) -------
    # 55-bit q0 / 45-bit scale, CosDiscrete EvalMod, 3-level C2S/S2C —
    # the reference default sets' shape at demo degree 2^6.
    lit = fboot.wide_parameters_literal(6, residual_levels=3, sparse_weight=0)
    p = btp.Parameters(lit, device)
    params = p.params
    print(f"logN={params.log_n}  chain levels={params.max_level + 1}  "
          f"residual={p.residual_level + 1}  slots=2^{p.log_slots}")

    # --- keys: sk, rlk + the C2S/S2C rotation set (keys.go:400) -----------
    sk = K.gen_secret_key(generator(seed, 0), params)
    evk = btp.gen_evaluation_keys(generator(seed, 1), p, sk)
    ev = btp.Evaluator(p, evk)
    print(f"keys + evaluator [{time.perf_counter() - t0:.1f}s]")

    # --- encrypt at the top residual level, drain it ----------------------
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.8, 0.8, params.max_slots)
    pt = ev.enc.encode(v, level=p.residual_level)
    ct = encryptor.encrypt(generator(seed, 2), params, sk, pt)

    sq = ev.ev.rescale(ev.ev.mul_relin(ct, ct))          # v^2, one level down
    while sq.level > 0:
        sq = ev.ev.drop_level(sq, 1)
    print(f"ciphertext drained to level {sq.level} [{time.perf_counter() - t0:.1f}s]")

    # --- bootstrap: back to the top residual level ------------------------
    fresh = ev.bootstrap(sq)
    print(f"bootstrapped to level {fresh.level} [{time.perf_counter() - t0:.1f}s]")

    pt_fresh = decryptor.decrypt(params, sk, fresh)
    got = ev.enc.decode(pt_fresh)
    err = np.abs(np.asarray(got).real[: len(v)] - v * v)
    prec = float(-np.log2(max(err.max(), 1e-17)))
    print(f"refreshed precision: {prec:.1f} bits (max err {err.max():.2e})")
    assert prec > 8, "bootstrap lost the payload"

    # --- the refreshed ciphertext supports more work ----------------------
    quad = ev.ev.rescale(ev.ev.mul_relin(fresh, fresh))   # (v^2)^2
    pt_quad = decryptor.decrypt(params, sk, quad)
    got4 = ev.enc.decode(pt_quad)
    err4 = np.abs(np.asarray(got4).real[: len(v)] - v ** 4)
    print(f"post-bootstrap square: max err {err4.max():.2e}")
    assert err4.max() < 0.05

    # --- META-BTS high-precision variant ----------------------------------
    # (ckks_bootstrapping/high_precision/main.go): each extra iteration
    # bootstraps the amplified residual error and folds the correction
    # back, gaining ~reserved_bits bits per round (eprint 2022/1167).
    hp = ev.evaluate(sq, iterations=2, reserved_bits=8)
    pt_hp = decryptor.decrypt(params, sk, hp)
    got_hp = ev.enc.decode(pt_hp)
    err_hp = np.abs(np.asarray(got_hp).real[: len(v)] - v * v)
    prec_hp = float(-np.log2(max(err_hp.max(), 1e-17)))
    print(f"META-BTS 2-iteration precision: {prec_hp:.1f} bits "
          f"(single-pass was {prec:.1f})")
    print(f"OK [{time.perf_counter() - t0:.1f}s]")
    return {"words": {"bootstrap": pt_fresh.value, "square": pt_quad.value,
                      "META-BTS": pt_hp.value},
            "decoded": {"bootstrap": got, "square": got4, "META-BTS": got_hp},
            "prec": prec, "err4": float(err4.max()), "prec_hp": prec_hp}


if __name__ == "__main__":
    cli(main)

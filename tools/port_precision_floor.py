"""Precision of the real-key CKKS session at the bench shape, from the JAX
package on the CPU: the reference for the floor that ``chip_smoke.py``
phase 8 holds the PyTorch port to.

    python tools/port_precision_floor.py

The session (the same as phase 8's, with JAX's keys and random draws in
place of the port's): logN = 14, the 19 + 3 primes < 2^23 of
``find_fast_primes(2^14, 22)``, scale 2^45; a secret key, a relinearization
key and galois keys for rotations by 1..8; two vectors of 8192 complex
slots drawn from ``numpy.random.default_rng(0)`` (real parts then imaginary
parts, uniform in [-1, 1), the first vector then the second), encoded and
encrypted; the fast evaluator's mul_relin then two rescales, and
rotate_hoisted of the first ciphertext over the 8 rotations; decrypt,
decode, ``precision_stats``.  Prints the min L2 precision (bits) of the
product and the lowest over the 8 rotations.  The keys and the errors are
random, so another seed moves these figures by a fraction of a bit.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOGN, NUM_Q, NUM_P, LOG_SCALE, SEED = 14, 19, 3, 45, 0
ROTATIONS = tuple(range(1, 9))


def vectors(slots: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for _ in range(2)]


def main() -> None:
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.fast import feval, fring
    from matrix_fhe_tpu.ops import rings
    from matrix_fhe_tpu.rlwe import decryptor, encryptor, keys as K
    from matrix_fhe_tpu.schemes import ckks

    t0 = time.perf_counter()
    moduli = fring.find_fast_primes(1 << LOGN, NUM_Q + NUM_P)
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(
        logn=LOGN, q=tuple(moduli[:NUM_Q]), p=tuple(moduli[NUM_Q:]),
        log_default_scale=LOG_SCALE))
    ks, kr, kg, k1, k2 = jax.random.split(jax.random.key(SEED), 5)
    sk = jax.jit(lambda k: K.gen_secret_key(k, params))(ks)
    rlk = K.gen_relinearization_key(kr, params, sk)
    gks = K.gen_galois_keys(kg, params, sk, [params.galois_element(k) for k in ROTATIONS])
    enc = ckks.Encoder(params)
    ntt = jax.jit(rings.Ring.ntt)
    intt = jax.jit(rings.Ring.intt)
    encrypt = jax.jit(lambda k, s, pt: encryptor.encrypt(k, params, s, pt))
    decrypt = jax.jit(lambda s, ct: decryptor.decrypt(params, s, ct))

    def encode(v):
        pt = enc.encode(v, is_ntt=False)
        return dataclasses.replace(pt, value=ntt(params.ring_q, pt.value),
                                   metadata=dataclasses.replace(pt.metadata, is_ntt=True))

    def decode(ct):
        pt = decrypt(sk, ct)
        coeffs = intt(params.ring_q.at_level(ct.level), pt.value)
        return enc.decode(dataclasses.replace(
            pt, value=coeffs, metadata=dataclasses.replace(pt.metadata, is_ntt=False)))

    v1, v2 = vectors(params.max_slots)
    ct1, ct2 = encrypt(k1, sk, encode(v1)), encrypt(k2, sk, encode(v2))
    fast = feval.make_fast_evaluator(params, rlk, gks)
    fa, fb = feval.ct_to_fast(ct1), feval.ct_to_fast(ct2)
    prod = jax.jit(lambda a, b: fast.rescale(fast.rescale(fast.mul_relin(a, b))))(fa, fb)
    rots = jax.jit(lambda a: fast.rotate_hoisted(a, list(ROTATIONS)))(fa)
    p_prod = ckks.precision_stats(v1 * v2, decode(feval.ct_to_u64(prod))).min_precision
    p_rot = min(ckks.precision_stats(np.roll(v1, -k), decode(feval.ct_to_u64(rots[k])))
                .min_precision for k in ROTATIONS)
    print(f"# logN={LOGN}, {NUM_Q}+{NUM_P} primes < 2^23, scale 2^{LOG_SCALE}, seed {SEED}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")
    print(f"min precision: product {p_prod:.4f} bits, rotations {p_rot:.4f} bits")


if __name__ == "__main__":
    main()

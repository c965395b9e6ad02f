"""Precision of the circuits that ``chip_smoke.py`` holds the PyTorch port to,
from the JAX package on the CPU: the references of the floors that phases 8
and 9 pin (each floor is the figure printed here less 1 bit).

    python tools/port_precision_floor.py [session] [bootstrap] [ci]

``session`` (phase 8): the same session as phase 8's, with JAX's keys and
random draws in place of the port's: logN = 14, the 19 + 3 primes < 2^23 of
``find_fast_primes(2^14, 22)``, scale 2^45; a secret key, a relinearization
key and galois keys for rotations by 1..8; two vectors of 8192 complex
slots drawn from ``numpy.random.default_rng(0)`` (real parts then imaginary
parts, uniform in [-1, 1), the first vector then the second), encoded and
encrypted; the fast evaluator's mul_relin then two rescales, and
rotate_hoisted of the first ciphertext over the 8 rotations; decrypt,
decode, ``precision_stats``.  Prints the min L2 precision (bits) of the
product and the lowest over the 8 rotations.  The keys and the errors are
random, so another seed moves these figures by a fraction of a bit.

``bootstrap`` (phase 9; ~8 min and ~7 GB on an 8-core CPU): the fast
bootstrapper of ``FAST_N14`` (logN = 14, 17 + 3 primes < 2^23, 8192 slots,
sparse weight 32), keys from ``jax.random.key(0)`` (secret) and ``key(1)``
(evaluation keys), built by ``make_fast_bootstrapper``.  Two circuits of the
bootstrap, each decoded and held against what it computes
(``precision_stats``, mean and min L2 bits over the 8192 slots):

* the DFT round trip: ``v`` (real then imaginary parts uniform in [-1, 1)
  from ``default_rng(0)``) encoded at the top level, encrypted with
  ``key(3)``, CoeffsToSlots then SlotsToCoeffs without EvalMod; the result,
  divided by the product of the two matrices' scalings, is held against
  ``v``.  At two input scales (``DFT_LOG_SCALES``): the default 2^15, whose
  plaintext coefficients (~2^8) are what a bootstrap's message brings to
  CoeffsToSlots, and 2^34, whose coefficients (~2^27) are what q0 times
  the ModUp overflow brings;
* EvalMod (``mod1.Evaluator.evaluate``) on the input of
  ``tests/test_mod1.py``'s harness with ``default_rng(5)``: round(U) Q + u
  encoded one level above the EvalMod level, encrypted with ``key(4)``,
  scaled to the bottom scale and normalized by 1/(K q_diff); held against
  the scaled sine it approximates.

``ci`` (phase 16; a few minutes): CKKS on the conjugate-invariant ring at
``CI_LITERAL`` (logN 14, 55 + 45x6-bit Q, a 61-bit P, scale 2^45, 16384
real slots): keys from ``jax.random.key(0)`` split five ways (secret,
relinearization, galois, the two encryptions); two vectors uniform in
[-1, 1) from ``default_rng(0)``; mul_relin then rescale, and a rotation by
one slot of the first (``CI_ROTATION``).  Prints the min and mean L2
precision (bits) of each.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOGN, NUM_Q, NUM_P, LOG_SCALE, SEED = 14, 19, 3, 45, 0
DFT_LOG_SCALES = (15, 34)
ROTATIONS = tuple(range(1, 9))


def vectors(slots: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for _ in range(2)]


def session() -> None:
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


CI_LITERAL = dict(logn=14, logq=(55,) + (45,) * 6, logp=(61,), log_default_scale=45,
                  ring_type="conjugate_invariant")
CI_ROTATION = 1


def ci_vectors(slots: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) for _ in range(2)]


def ci_session() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.rlwe import decryptor, encryptor, keys as K
    from matrix_fhe_tpu.schemes import ckks

    t0 = time.perf_counter()
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**CI_LITERAL))
    ks, kr, kg, k1, k2 = jax.random.split(jax.random.key(SEED), 5)
    g = params.galois_element(CI_ROTATION)
    sk = jax.jit(lambda k: K.gen_secret_key(k, params))(ks)
    rlk = jax.jit(lambda k, s: K.gen_relinearization_key(k, params, s))(kr, sk)
    gk = jax.jit(lambda k, s: K.gen_galois_key(k, params, s, g))(kg, sk)
    enc = ckks.Encoder(params)
    ev = ckks.Evaluator(params, rlk=rlk, galois_keys={g: gk})
    encrypt = jax.jit(lambda k, s, pt: encryptor.encrypt(k, params, s, pt))
    v1, v2 = ci_vectors(params.max_slots)
    ct1 = encrypt(k1, sk, enc.encode(v1))
    ct2 = encrypt(k2, sk, enc.encode(v2))
    prod = jax.jit(lambda a, b: ev.rescale(ev.mul_relin(a, b)))(ct1, ct2)
    rot = jax.jit(lambda a: ev.rotate(a, CI_ROTATION))(ct1)

    def decode(ct):
        return enc.decode(jax.jit(lambda s, c: decryptor.decrypt(params, s, c))(sk, ct))

    st_p = ckks.precision_stats(v1 * v2, decode(prod))
    st_r = ckks.precision_stats(np.roll(v1, -CI_ROTATION), decode(rot))
    print(f"# CI ring: {CI_LITERAL}, {params.max_slots} slots, seed {SEED}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")
    print(f"precision: product min {st_p.min_precision:.4f} mean {st_p.avg_precision:.4f} bits, "
          f"rotation min {st_r.min_precision:.4f} mean {st_r.avg_precision:.4f} bits")


def boot_vector(slots: int, seed: int = SEED):
    """The DFT round trip's input (and phase 9's bootstrap input)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)


def mod1_input(m1p, slots: int, seed: int = 5):
    """tests/test_mod1.py:_evaluate_mod1's values and the function EvalMod
    approximates on them."""
    rng = np.random.default_rng(seed)
    k = m1p.k - 1
    q = m1p.q_diff * m1p.message_ratio
    values = np.round(rng.uniform(-k, k, slots)) * q + rng.uniform(-1, 1, slots)
    values[0] = k * q + 0.5
    x = np.sin(2 * np.pi * (values / m1p.message_ratio / m1p.q_diff))
    return values, x * m1p.message_ratio * m1p.q_diff / (2 * np.pi)


def mod1_prepare(ev, ct, m1p, q0: int):
    """tests/test_mod1.py:_evaluate_mod1's scaling to the bottom scale and
    normalization to the Chebyshev variable (one level)."""
    import math
    scale = math.exp2(round(math.log2(q0 / m1p.message_ratio)))
    ct = ev.scale_up(ct, round(scale / float(ct.scale)))
    ct = ev.scale_up(ct, round(float(m1p.scaling_factor) / float(ct.scale) / m1p.message_ratio))
    return ev.rescale(ev.mul_const(ct, 1.0 / (m1p.k * m1p.q_diff)))


def bootstrap_circuits() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu.fast import fboot, feval
    from matrix_fhe_tpu.rlwe import decryptor, encryptor, keys as K
    from matrix_fhe_tpu.schemes import ckks

    t0 = time.perf_counter()
    p = btp.Parameters(fboot.FAST_N14)
    params = p.params
    sk = K.gen_secret_key(jax.random.key(0), params)
    evk = btp.gen_evaluation_keys(jax.random.key(1), p, sk)
    bts = fboot.make_fast_bootstrapper(p, evk)
    enc, fev = bts.enc, bts.ev
    print(f"# FAST_N14: logN={params.log_n}, {len(params.q)} + {len(params.p)} primes, "
          f"{len(p.galois_elements())} galois keys; keys and bootstrapper "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")

    def decode(ct):
        return enc.decode(decryptor.decrypt(params, sk, feval.ct_to_u64(ct)))

    def report(name, want, got):
        st = ckks.precision_stats(want, got)
        print(f"{name}: mean {st.avg_precision:.4f} bits, min {st.min_precision:.4f} bits "
              f"[{time.perf_counter() - t0:.1f} s]")

    v = boot_vector(params.max_slots)
    scaling = bts.c2s_matrix.literal.scaling * bts.s2c_matrix.literal.scaling
    for log_scale in DFT_LOG_SCALES:
        ct = encryptor.encrypt(jax.random.key(3), params, sk, enc.encode(
            v, level=params.max_level, scale=1 << log_scale))
        re, im = bts.coeffs_to_slots(feval.ct_to_fast(ct))
        out = bts.slots_to_coeffs(re, im)
        report(f"dft round trip at scale 2^{log_scale} (level {out.level}, scaling "
               f"{scaling!r})", v, decode(out) / scaling)

    m1p = bts.mod1_params
    values, want = mod1_input(m1p, params.max_slots)
    ct = encryptor.encrypt(jax.random.key(4), params, sk,
                           enc.encode(values, level=p.mod1_lit.level_q + 1))
    ct = mod1_prepare(fev, feval.ct_to_fast(ct), m1p, params.q[0])
    out = bts.mod1_eval.evaluate(ct)
    report(f"eval_mod (level {out.level})", want, np.real(decode(out)))


def main() -> None:
    what = sys.argv[1:] or ["session", "bootstrap"]
    for w in what:
        {"session": session, "bootstrap": bootstrap_circuits, "ci": ci_session}[w]()


if __name__ == "__main__":
    main()

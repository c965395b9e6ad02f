"""Reference digests of the int32 CKKS step at the bench shape, from the JAX
package on the CPU.

The PyTorch port (``matrix_fhe_tpu_torch``) pins these digests in
``tests/test_torch_fckks.py`` and ``chip_smoke.py``: on the same synthetic
context (``make_synthetic_context(14, 19, 3, seed=0, num_rot=8)``) and the
same operands, its outputs must hash to the same values.

    python tools/port_reference_digest.py
    python tools/port_reference_digest.py wide [logn]
    python tools/port_reference_digest.py 3n

* ``mul_relin_rescale(c0, c1, d0, d1)``: sha256 over the little-endian
  int32 bytes of out0, then out1;
* ``rotations_hoisted(c0, c1, ctx.gal_els)``: sha256 over each galois
  element's out0 then out1, in ``ctx.gal_els`` order.

``num_rot`` changes the order of the numpy draws (the galois keys are drawn
before the relinearization key), so the digests hold for this call only.

``wide``: the same two calls on the wide path (``fast/wckks.py``) at
bench.py's two wide shapes at logN 14, each with 8 galois keys
(``num_rot=8``): PN14QP438 (``make_synthetic_context(14, 0, 0,
moduli=(PN14QP438_Q, PN14QP438_P), num_rot=8)``) and wide61, bench.py's
``make_synthetic_context(14, 6, 2, q_bits=(60,) + (45,) * 8, p_bits=61)``
with its own Q and P (``WIDE61_Q``, ``WIDE61_P``): P's first prime,
2305843009214414849, lies above 2^61, below the wide path's limit
2^61 + 2^55.  The
digests are over the canonical words (``wide.unpack_pair`` of the pairs) as
little-endian int64, the form of the port's wide ring.  Name shapes after
``wide`` to run only those.

``3n``: the 3N ring's factorized NTT (``ops/ntt_3n.py``) at N = 12288 over
the 7 primes of the Matrix-CKKS literal ``THREE_N`` (its 6 Q primes, then
its P prime, ``gen_3n_moduli``), forward and inverse on one [2, 7, N]
input drawn by ``three_n_input`` (numpy, ``SEED``); sha256 of the output
words as little-endian int64 (~10 s).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOGN, NUM_Q, NUM_P, NUM_ROT, SEED = 14, 19, 3, 8, 0


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes())
    return h.hexdigest()


WIDE61_Q = (1152921504606748673, 35184372121601, 35184372744193, 35184373006337,
            35184371138561, 35184370941953)
WIDE61_P = (2305843009214414849, 2305843009211662337)
WIDE_SHAPES = {
    "pn14qp438": lambda wckks: wckks.make_synthetic_context(
        LOGN, 0, 0, moduli=(wckks.PN14QP438_Q, wckks.PN14QP438_P), seed=SEED,
        num_rot=NUM_ROT),
    "wide61": lambda wckks: wckks.make_synthetic_context(
        LOGN, 0, 0, moduli=(WIDE61_Q, WIDE61_P), seed=SEED, num_rot=NUM_ROT),
}


# chip_smoke.py phase 15's Matrix-CKKS literal (N = 2^12 3 = 12288)
THREE_N = dict(order2=12, order3=1, logq=(50, 40, 40, 40, 40, 40), logp=(60,))


def three_n_input(moduli, n: int) -> np.ndarray:
    """[2, L, N] words uniform in [0, q) from ``SEED``, one limb a modulus."""
    rng = np.random.default_rng(SEED)
    return np.stack([rng.integers(0, q, (2, n), dtype=np.int64) for q in moduli], axis=-2)


def words_digest(arrays) -> str:
    """sha256 of 64-bit words as little-endian int64."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a).view(np.int64), dtype="<i8").tobytes())
    return h.hexdigest()


def main_3n() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.ops import modmath as mm
    from matrix_fhe_tpu.ops import rings
    from matrix_fhe_tpu.rlwe import params as rp

    t0 = time.perf_counter()
    n = (1 << THREE_N["order2"]) * 3 ** THREE_N["order3"]
    q, p = rp.gen_3n_moduli(n, THREE_N["logq"], THREE_N["logp"])
    ring = rings.new_ring(n, q + p, rings.MATRIX)
    x = mm.u64(three_n_input(q + p, n).astype(np.uint64))
    fwd = jax.jit(rings.Ring.ntt)(ring, x)
    bwd = jax.jit(rings.Ring.intt)(ring, x)
    print(f"# 3N NTT: N {n}, moduli {q + p}, R x C = {ring.ntt3n.rows} x {ring.ntt3n.cols}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")
    print(f'NTT3N_SHA256 = {{"fwd": "{words_digest([np.asarray(fwd)])}",\n'
          f'                "bwd": "{words_digest([np.asarray(bwd)])}"}}')


def wide_digest(pairs, moduli) -> str:
    """sha256 of canonical words, little-endian int64, of wide pairs."""
    from matrix_fhe_tpu.ops import wide
    h = hashlib.sha256()
    for a in pairs:
        lq = np.asarray(a).shape[-2]
        h.update(wide.unpack_pair(np.asarray(a), moduli[:lq]).astype("<i8").tobytes())
    return h.hexdigest()


def main_wide(names) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.fast import wckks

    for name in names or WIDE_SHAPES:
        t0 = time.perf_counter()
        ctx, (c0, c1, d0, d1) = WIDE_SHAPES[name](wckks)
        Q = ctx.ring_q.moduli_tuple
        out0, out1 = jax.jit(wckks.mul_relin_rescale)(ctx, c0, c1, d0, d1)
        mrr = wide_digest([out0, out1], Q)
        t1 = time.perf_counter()
        rots = jax.jit(wckks.rotations_hoisted, static_argnums=3)(
            ctx, c0, c1, ctx.gal_els)
        rot = wide_digest([a for g in ctx.gal_els for a in rots[g]], Q)
        print(f"# {name}: logN {LOGN}, Q {list(Q)}, P {list(ctx.ring_p.moduli_tuple)}, "
              f"gal_els {ctx.gal_els}; mul_relin_rescale {t1 - t0:.1f} s, "
              f"rotations_hoisted {time.perf_counter() - t1:.1f} s on "
              f"{jax.devices()[0].platform}", flush=True)
        print(f'    "{name}": ("{mrr}",\n{" " * 18}"{rot}"),', flush=True)


def main() -> None:
    if sys.argv[1:2] == ["wide"]:
        main_wide(sys.argv[2:])
        return
    if sys.argv[1:2] == ["3n"]:
        main_3n()
        return
    import jax
    jax.config.update("jax_platforms", "cpu")
    from matrix_fhe_tpu.fast import fckks

    t0 = time.perf_counter()
    ctx, (c0, c1, d0, d1) = fckks.make_synthetic_context(
        LOGN, NUM_Q, NUM_P, seed=SEED, num_rot=NUM_ROT)
    out0, out1 = jax.jit(fckks.mul_relin_rescale)(ctx, c0, c1, d0, d1)
    rots = jax.jit(fckks.rotations_hoisted, static_argnums=3)(
        ctx, c0, c1, ctx.gal_els)
    mrr = digest([out0, out1])
    rot = digest([a for g in ctx.gal_els for a in rots[g]])
    print(f"# make_synthetic_context({LOGN}, {NUM_Q}, {NUM_P}, seed={SEED}, "
          f"num_rot={NUM_ROT}); gal_els={ctx.gal_els}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")
    print(f'MUL_RELIN_RESCALE_SHA256 = "{mrr}"')
    print(f'ROTATIONS_HOISTED_SHA256 = "{rot}"')


if __name__ == "__main__":
    main()

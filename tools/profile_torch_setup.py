"""Where the time of the port's setup path goes on the GPU, by torch.profiler.

    python tools/profile_torch_setup.py [--rows 8]

At the bench shape of ``chip_smoke.py`` phase 8 (logN = 14, 19 + 3 primes
< 2^23, scale 2^45), on the card: one u64 NTT of a [19, 2^14] polynomial,
one galois key split into its sampling part (CPU generator, then the copy to
the card) and its deterministic part, one FastEncoder.encode + encrypt, and
one decrypt + decode.  Prints, for each, the wall time, the number of
kernels, the summed device time of all kernels and its share of the wall
time (the rest is the device waiting on the host), and the kernels with the
most device time.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8, help="kernels to list")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from matrix_fhe_tpu_torch.fast import feval
    from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, keys as K

    if not torch.cuda.is_available():
        print("profile_torch_setup: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    params = chip_smoke.session_params(dev)
    gen = torch.Generator().manual_seed(0)
    sk = K.gen_secret_key(gen, params)
    g = params.galois_element(1)
    enc = feval.FastEncoder(params)
    v = np.random.default_rng(0).uniform(-1, 1, params.max_slots) + 0j
    x = params.ring_q.moduli[:, None] - 1 - torch.arange(params.n, device=dev)
    samples = K.sample_evaluation_key(gen, params)
    ct = encryptor.encrypt(gen, params, sk, enc.encode(v))
    work = {
        "u64 NTT [19, 2^14]": lambda: params.ring_q.ntt(x),
        "galois key, sampling (CPU generator, copy)":
            lambda: K.sample_evaluation_key(gen, params),
        "galois key, deterministic part":
            lambda: K.galois_key_from_samples(params, sk, g, samples),
        "encode + encrypt": lambda: encryptor.encrypt(gen, params, sk, enc.encode(v)),
        "decrypt + decode": lambda: enc.decode(decryptor.decrypt(params, sk, ct)),
    }
    for fn in work.values():  # warm-up: allocator, kernel loads
        fn()
    torch.cuda.synchronize()

    for name, fn in work.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kernels)
        print(f"{name}: wall {wall_us:.1f} us, {len(kernels)} kernels, device busy "
              f"{busy:.1f} us ({100 * busy / wall_us:.1f}% of wall)")
        print(prof.key_averages().table(sort_by="device_time_total",
                                        row_limit=args.rows, max_name_column_width=50))
    # unprofiled wall times, for the profiler's own cost
    for name, fn in work.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{name}: unprofiled wall {(time.perf_counter() - t0) * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

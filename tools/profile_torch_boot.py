"""Where the time of the port's bootstrap goes on the GPU, by torch.profiler.

    python tools/profile_torch_boot.py [--rows 10]

At ``chip_smoke.py`` phase 9's session (``fboot.FAST_N14``: logN = 14,
17 + 3 primes < 2^23, 8192 slots, sparse secret weight 32), on the card:

* keygen's deterministic part and ``make_fast_bootstrapper``: wall time, and
  the host time spent in the u64 NTT (``ops/rings.py``, torch ops, each call
  synchronized and timed) against the rest (Python, the encoder's host-side
  embedding, the word arithmetic);
* one warm ``bootstrap`` under the profiler: the wall time, the number of
  kernels, the summed device time of all kernels and its share of the wall
  time (the rest is the device waiting on the host), the NTT kernel's (B1's)
  device time and share of the device time, and the kernels with the most
  device time; then the unprofiled wall time of one more.

Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10, help="kernels to list")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot, feval
    from matrix_fhe_tpu_torch.ops import rings
    from matrix_fhe_tpu_torch.rlwe import encryptor, keys as K
    from tools.port_precision_floor import boot_vector

    if not torch.cuda.is_available():
        print("profile_torch_boot: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    p = btp.Parameters(fboot.FAST_N14, device=dev)
    params = p.params
    sk = K.gen_secret_key(torch.Generator().manual_seed(101), params)
    samples = btp.sample_evaluation_keys(torch.Generator().manual_seed(102), p)

    ntt_ms = [0.0]
    plain_ntt, plain_intt = rings.Ring.ntt, rings.Ring.intt

    def timed(fn):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            ntt_ms[0] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def split(name, fn):
        """fn()'s wall time and its u64 NTT's share of it."""
        ntt_ms[0] = 0.0
        rings.Ring.ntt, rings.Ring.intt = timed(plain_ntt), timed(plain_intt)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            rings.Ring.ntt, rings.Ring.intt = plain_ntt, plain_intt
        print(f"{name}: wall {wall:.1f} ms, u64 NTT {ntt_ms[0]:.1f} ms "
              f"({100 * ntt_ms[0] / wall:.1f}%), the rest {wall - ntt_ms[0]:.1f} ms")
        return out

    evk = split("keygen deterministic part", lambda: btp.evaluation_keys_from_samples(
        p, sk, samples))
    bts = split("make_fast_bootstrapper", lambda: fboot.make_fast_bootstrapper(p, evk))

    v = boot_vector(params.max_slots)
    ct = feval.ct_to_fast(encryptor.encrypt(torch.Generator().manual_seed(103), params, sk,
                                            bts.enc.encode(v, level=p.residual_level)))
    bts.bootstrap(ct)  # warm-up: the per-level contexts, the allocator's blocks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bts.bootstrap(ct)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels)
    ntt = sum(e.device_time_total for e in kernels if "ntt" in e.name.lower())
    n_ntt = sum(1 for e in kernels if "ntt" in e.name.lower())
    print(f"bootstrap (profiled): wall {wall_us / 1e3:.1f} ms, {len(kernels)} kernels, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall); NTT kernel "
          f"{n_ntt} launches, {ntt / 1e3:.3f} ms ({100 * ntt / max(busy, 1e-9):.1f}% of device "
          f"time) | {chip_smoke.card_label()}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=args.rows,
                                    max_name_column_width=50))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bts.bootstrap(ct)
    torch.cuda.synchronize()
    print(f"bootstrap (unprofiled): wall {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of the port's wide path goes on the GPU, by torch.profiler.

    python tools/profile_torch_wide.py [--rows 10]

On the card, warm (each profiled call follows one unprofiled call):

* the wide step at ``chip_smoke.py`` phase 11's PN14QP438 shape (logN 14,
  7 + 2 primes of 45-56 bits): one ``mul_relin_rescale`` and one
  ``rotations_hoisted`` over 8 galois elements;
* one wide bootstrap at phase 12's ``fboot.wide_parameters_literal(14)``.

For each: the wall time, the number of kernels, the summed device time of
all kernels and its share of the wall time (the rest is the device waiting
on the host), kernel B4's (``ntt64``) launches, device time and share of the
device time, and the kernels with the most device time.  Needs a CUDA
device; imports no jax.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profiled(name: str, fn, rows: int, label: str, kernels=(("B4", "ntt64"),)) -> None:
    """Profile one warm call of fn(): its wall time, kernels, device busy
    time, and the launches and device time of each (label, name part) of
    ``kernels``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events)
    parts = []
    for kernel, tag in kernels:
        mine = [e for e in events if tag in e.name]
        us = sum(e.device_time_total for e in mine)
        parts.append(f"{kernel} {len(mine)} launches, {us / 1e3:.3f} ms "
                     f"({100 * us / max(busy, 1e-9):.1f}% of device time)")
    print(f"{name} (profiled): wall {wall_us / 1e3:.1f} ms, {len(events)} kernels, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall); {'; '.join(parts)} "
          f"| {label}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=rows,
                                    max_name_column_width=50))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    print(f"{name} (unprofiled): wall {(time.perf_counter() - t0) * 1e3:.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10, help="kernels to list")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot, wckks
    from matrix_fhe_tpu_torch.rlwe import encryptor, keys as K
    from tools.port_precision_floor import boot_vector

    if not torch.cuda.is_available():
        print("profile_torch_wide: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    label = chip_smoke.card_label()
    ctx, ops = chip_smoke.WIDE_SHAPES["pn14qp438"](wckks, dev)
    profiled("wide mul_relin_rescale", lambda: wckks.mul_relin_rescale(ctx, *ops), args.rows,
             label)
    profiled("wide rotations_hoisted x8", lambda: wckks.rotations_hoisted(
        ctx, ops[0], ops[1], ctx.gal_els), args.rows, label)
    del ctx, ops

    p = btp.Parameters(fboot.wide_parameters_literal(14), device=dev)
    params = p.params
    sk = K.gen_secret_key(torch.Generator().manual_seed(101), params)
    evk = btp.gen_evaluation_keys(torch.Generator().manual_seed(102), p, sk)
    bts = fboot.make_wide_bootstrapper(p, evk)
    v = boot_vector(params.max_slots)
    ct = encryptor.encrypt(torch.Generator().manual_seed(103), params, sk,
                           bts.enc.encode(v, level=p.residual_level))
    profiled("wide bootstrap", lambda: bts.bootstrap(ct), args.rows, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of the port's fork rings goes on the GPU, by torch.profiler.

    python tools/profile_torch_matrix.py [--rows 10]

On the card, warm (each profiled call follows one unprofiled call):

* Matrix-CKKS at ``chip_smoke.py`` phase 15's literal (N = 12288, 6 + 1
  3N primes): one ``mul_relin`` + rescale and one automorphism by 5;
* CKKS on the conjugate-invariant ring at phase 16's literal (logN 14,
  7 + 1 primes): one ``mul_relin`` + rescale and one rotation by a slot.

For each: the wall time, the number of kernels, the summed device time of
all kernels and its share of the wall time (the rest is the device waiting
on the host), the launches, device time and share of the device time of
kernel B5 (``ntt3n``) and of B4 (``ntt64``), and the kernels with the most
device time (``tools/profile_torch_wide.py:profiled``).  Needs a CUDA
device; imports no jax.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.profile_torch_wide import profiled  # noqa: E402

KERNELS = (("B5", "ntt3n"), ("B4", "ntt64"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10, help="kernels to list")
    args = ap.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("profile_torch_matrix: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    label = chip_smoke.card_label()
    ms = chip_smoke.matrix_session(dev, {})
    ops = chip_smoke.matrix_ops(ms["params"], ms["keys"][1], ms["keys"][2])
    for name in ("mul_relin + rescale", "automorphism 5"):
        profiled(f"Matrix-CKKS {name}", lambda: ops[name](*ms["cts"]), args.rows, label,
                 KERNELS)
    del ms, ops

    from matrix_fhe_tpu_torch.schemes import ckks
    from tools.port_precision_floor import CI_ROTATION
    ci = chip_smoke.ci_session(dev, {})
    sk, rlk, gk = ci["keys"]
    params = ci["params"]
    ev = ckks.Evaluator(params, rlk=rlk, galois_keys={params.galois_element(CI_ROTATION): gk})
    a, b = ci["cts"]
    profiled("CI mul_relin + rescale", lambda: ev.rescale(ev.mul_relin(a, b)), args.rows, label,
             KERNELS)
    profiled(f"CI rotate {CI_ROTATION}", lambda: ev.rotate(a, CI_ROTATION), args.rows, label,
             KERNELS)
    return 0


if __name__ == "__main__":
    sys.exit(main())

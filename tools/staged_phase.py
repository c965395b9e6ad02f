"""Phase 27 of chip_smoke.py alone: the staged bootstrap (one CUDA graph a
stage, circuits/ckks/staged.py) at logN 14 on a fresh session of each path;
and phase 28 alone, the wide bootstrap at logN 16 eager and staged.

    python tools/staged_phase.py [fast] [wide] [n16]

On one GPU, ~3 min for fast and wide: builds B1 and B4 at N = 2^14, then
for each path makes the keys and the eager session (``chip_smoke.boot_keys``
and ``boot_session`` / ``wide_boot_session`` with 3 warm repeats, then
``boot_stages``) and runs ``chip_smoke.staged_phase`` on it.  ``n16``
builds B4 at 2^16, runs ``chip_smoke.n16_phase`` (phase 28, all of it,
~4-6 min) and writes B4's launch shapes there to
``matrix_fhe_tpu_torch/_build/b4_shapes_n16.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
    from matrix_fhe_tpu_torch.fast import fboot
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda
    dev = torch.device("cuda", 0)
    smi = cs.card_label()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    kinds = sys.argv[1:] or ["fast", "wide"]
    ntt_cuda.build_all([(ntt_cuda.SOURCE, 14), (ntt64_cuda.SOURCE, 14)]
                       + [(ntt64_cuda.SOURCE, cs.N16_LITERAL[0])] * ("n16" in kinds))
    for kind in kinds:
        t0 = time.perf_counter()
        if kind == "n16":
            clock = cs.PhaseClock()
            _, rate = cs.int32_rate(torch.cuda.get_device_properties(dev).multi_processor_count)
            r = cs.n16_phase(dev, smi, np.random.default_rng(cs.SEED), rate, clock)
            print(f"n16: phase 28 {time.perf_counter() - t0:.1f} s ({clock.times[28]:.1f} s "
                  f"on its clock): B4 launches by path {r['by_path']}", flush=True)
            out = ntt_cuda.BUILD_DIR / "b4_shapes_n16.json"
            out.write_text(json.dumps({"device": smi, "shapes": r["loss"]}))
            print(f"n16: B4's launch shapes written to {out} (for tools/ntt_cluster_sweep.py "
                  f"--b4 --shapes)", flush=True)
            continue
        lit = fboot.FAST_N14 if kind == "fast" else fboot.wide_parameters_literal(14)
        p = btp.Parameters(lit, device=dev)
        times: dict = {}
        sk, evk = cs.boot_keys(p, times)
        if kind == "fast":
            s = cs.boot_session(p, sk, evk, times, repeats=3)
            counts = {"B1": s["counts"]["bootstrap"]}
        else:
            s = cs.wide_boot_session(p, sk, evk, times, repeats=3)
            counts = {"B4": s["counts"]["bootstrap"], "B1": {"fwd": 0, "bwd": 0}}
        rows, _ = cs.boot_stages(s["bts"], sk, s["ct"], s["v"])
        t1 = time.perf_counter()
        print(f"{kind}: session {t1 - t0:.1f} s; eager warm {s['repeats']}", flush=True)
        r = cs.staged_phase(kind, dict(s, counts=counts), rows, sk, 127, dev, smi)
        print(f"{kind}: phase 27 {time.perf_counter() - t1:.1f} s: {r}", flush=True)


if __name__ == "__main__":
    main()

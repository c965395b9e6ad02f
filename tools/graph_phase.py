"""Phase 29 of chip_smoke.py alone: the key-switch graph caches
(rlwe/evaluator.py ``_pgraph``, rlwe/keys.py ``_EVK_GRAPH_CACHE``) held to
their eager bodies on fresh sessions of phases 8, 15, 16, 21 and 23.

    python tools/graph_phase.py

On one GPU, ~3-5 min: builds B4 at N = 2^9, 2^10 and 2^14 and B5, makes
each session with chip_smoke's own helpers (``session_keys``,
``matrix_session``, ``ci_session``, ``blindrot_session``,
``flagship_session``), then runs ``chip_smoke.graph_phase`` on them.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    import chip_smoke as cs
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda, ntt_cuda
    dev = torch.device("cuda", 0)
    smi = cs.card_label()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    ntt_cuda.build_all([(ntt64_cuda.SOURCE, logn) for logn in
                        sorted({cs.LOGN, cs.BR_RING[0], cs.BR_LWE[0]})]
                       + [(ntt3n_cuda.SOURCE, ntt3n_cuda.BUILD_KEY)])
    t0 = time.perf_counter()
    params = cs.session_params(dev)
    sk, _, gks = cs.session_keys(params, cs.SESSION_ROTATIONS, {})
    f = cs.flagship_session(dev, {})
    objs = f["objs"]
    sessions = {
        "session": {"params": params, "sk": sk, "gks": gks},
        "matrix": cs.matrix_session(dev, {}), "ci": cs.ci_session(dev, {}),
        "blindrot": cs.blindrot_session(dev, {}),
        "flagship": {**{k: objs[k] for k in ("params", "rlk", "ct1", "ct2")}, "step": f["step"],
                     "gks": {k.gal_el: k for n, k in objs.items() if n.startswith("galois")}}}
    print(f"sessions {time.perf_counter() - t0:.1f} s", flush=True)
    clock = cs.PhaseClock()
    r = cs.graph_phase(dev, smi, sessions, clock)
    print(f"phase 29 {clock.times[29]:.1f} s: " + ", ".join(
        f"{k} eager {v['median']['eager']:.3f} ms, graphed {v['median']['graphed']:.3f} ms"
        for k, v in r.items()), flush=True)


if __name__ == "__main__":
    main()

"""Time the NTT kernel at every cluster size C, for ``ntt_cuda.geometry``.

    python tools/ntt_cluster_sweep.py [--out PATH] [--b5]

On one CUDA card: builds the kernel libraries of N = 2^10 .. 2^15 (every
size with a cluster kernel) and, at each N, times one transform
(``ntt_cuda.launch``, forward and inverse) over 6, 10, 40, 130 and 640 rows
([2, 3, N], [1, 10, N], [4, 10, N], [13, 10, N], [64, 10, N]) and the chain
of k = 100 transforms over 24 and 240 rows ([8, 3, N], [24, 10, N]) at
C = 1, 2, 4 and 8.  One transform is timed with L2 warm and with L2 flushed
before each launch, the chain warm; all on the device, the launches queued
behind a spin kernel (``chip_smoke._device_ms``, ``_flushed_ms``).  Every C
gives the same output as C = 1.  Prints one line a launch shape, the C that
``geometry`` picks beside the fastest, and writes every time (ms) as JSON to
``--out`` (by default beside the libraries, in ``matrix_fhe_tpu_torch/_build/``).
Run it when the geometry rule is revisited; the smoke run does not.

``--b5``: the same for kernel B5 (``ops/ntt3n_cuda.py:geometry``), at
``chip_smoke.py`` phase 15's launch shapes, one polynomial of 1, 5, 6 and
7 limbs at N = 12288 on phase 15's primes, and at [2, 3, N] for N = 1152,
24576 and 27648, forward and inverse, at every C the kernel takes there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from matrix_fhe_tpu_torch.ops import ntt_cuda  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
ONE = [(2, 3), (1, 10), (4, 10), (13, 10), (64, 10)]
CHAIN = [(8, 3), (24, 10)]
CHAIN_K = 100


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="JSON of every time (default: beside the "
                    "libraries, ntt_cluster_sweep[_b5].json)")
    ap.add_argument("--b5", action="store_true", help="kernel B5 at phase 15's shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = "ntt_cluster_sweep_b5.json" if args.b5 else "ntt_cluster_sweep.json"
    args.out = args.out or str(ntt_cuda.BUILD_DIR / name)
    if args.b5:
        return sweep_b5(dev, sms, smi, args.out)
    logns = range(ntt_cuda.MIN_CLUSTER_N.bit_length() - 1, ntt_cuda.MAX_KERNEL_N.bit_length())
    ntt_cuda.build(logns)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(0)
    out = []
    for logn in logns:
        n = 1 << logn
        moduli = ntt_cuda.find_v2_primes(n, 10)
        for lead, k in [(s, 1) for s in ONE] + [(s, CHAIN_K) for s in CHAIN]:
            mods = moduli[:lead[-1]]
            tabs = ntt_cuda.build_tables(n, mods, dev)
            hi = np.array(mods, dtype=np.int64)[:, None]
            x = torch.from_numpy(
                (rng.integers(0, 1 << 62, lead + (n,)) % hi).astype(np.int32)).to(dev)
            rows = int(np.prod(lead))
            rec = {"logn": logn, "rows": rows, "k": k, "shape": list(lead) + [n],
                   "picked": ntt_cuda.geometry(rows, n, k, sms)}
            for fwd in (True, False):
                d = "fwd" if fwd else "bwd"
                want = ntt_cuda.launch(x, tabs, fwd, k, cluster=1)
                for c in CLUSTERS:
                    got = ntt_cuda.launch(x, tabs, fwd, k, cluster=c)
                    assert torch.equal(got, want), (logn, lead, k, d, c)
                    run = lambda: ntt_cuda.launch(x, tabs, fwd, k, cluster=c)  # noqa: E731
                    iters = 20 if k == 1 else 3
                    rec[f"{d}_C{c}"] = chip_smoke._device_ms(run, iters=iters)
                    if k == 1:
                        rec[f"{d}_flushed_C{c}"] = chip_smoke._flushed_ms(run, flush)
            out.append(rec)
            for key in ("", "flushed_") if k == 1 else ("",):
                cells = []
                for d in ("fwd", "bwd"):
                    t = [rec[f"{d}_{key}C{c}"] for c in CLUSTERS]
                    best = CLUSTERS[int(np.argmin(t))]
                    cells.append(f"{d} " + " / ".join(f"{v * 1e3:.2f}" for v in t)
                                 + f" us (fastest C={best})")
                print(f"N=2^{logn} {str(rec['shape']):18s} k={k:<3d} "
                      f"{'L2 flushed' if key else 'L2 warm':10s} picked C={rec['picked']} | "
                      f"at C = 1 / 2 / 4 / 8: " + " | ".join(cells))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "sweep": out}, indent=1))
    print(f"wrote {args.out}")
    return 0


def sweep_b5(dev, sms: int, smi: str, out_path: str) -> int:
    """B5 at every cluster size, at phase 15's shapes and a few others."""
    from matrix_fhe_tpu_torch.ops import ntt3n_cuda, rings
    from matrix_fhe_tpu_torch.rlwe import params as rparams
    from matrix_fhe_tpu_torch.utils import primes as pr
    lit = chip_smoke.MATRIX_LITERAL
    n0 = (1 << lit["order2"]) * 3 ** lit["order3"]
    q, p = rparams.gen_3n_moduli(n0, lit["logq"], lit["logp"])
    cases = [(n0, (limbs,), (q + p)[:limbs]) for limbs in (1, 5, 6, 7)]
    cases += [(n, (2, 3), [pr.find_3n_rns_primes(n, b, 1)[0] for b in (45, 55, 60)])
              for n in (1152, 24576, 27648)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(0)
    out = []
    for n, lead, moduli in cases:
        ring = rings.new_ring(n, moduli, rings.MATRIX, device=dev)
        x = chip_smoke._words(rng, lead[:-1], moduli, n).to(dev)
        rows = int(np.prod(lead))
        cs = ntt3n_cuda.clusters(n)
        rec = {"n": n, "rows": rows, "shape": list(lead) + [n], "clusters": list(cs),
               "picked": ntt3n_cuda.geometry(rows, n, sms)}
        cells = []
        for fwd in (True, False):
            d = "fwd" if fwd else "bwd"
            want = ntt3n_cuda.launch(x, ring, fwd, cluster=cs[0])
            for c in cs:
                assert torch.equal(ntt3n_cuda.launch(x, ring, fwd, cluster=c), want), (n, d, c)
                run = lambda: ntt3n_cuda.launch(x, ring, fwd, cluster=c)  # noqa: E731
                rec[f"{d}_C{c}"] = chip_smoke._device_ms(run)
                rec[f"{d}_flushed_C{c}"] = chip_smoke._flushed_ms(run, flush)
            for key in ("", "flushed_"):
                t = [rec[f"{d}_{key}C{c}"] for c in cs]
                cells.append(f"{d}{' L2 flushed' if key else ''} "
                             + " / ".join(f"{v * 1e3:.2f}" for v in t)
                             + f" us (fastest C={cs[int(np.argmin(t))]})")
        out.append(rec)
        print(f"B5 N={n} {str(rec['shape']):14s} picked C={rec['picked']} | at C = "
              f"{' / '.join(map(str, cs))}: " + " | ".join(cells))
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps({"device": smi, "sweep": out}, indent=1))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

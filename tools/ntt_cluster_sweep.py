"""Time the NTT kernel at every cluster size C, for ``ntt_cuda.geometry``.

    python tools/ntt_cluster_sweep.py [--out PATH] [--b4 [--shapes PATH] | --b5]

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

``--b4``: the same for kernel B4 (``ops/ntt64_cuda.py:geometry``), the NTT
of 64-bit words, on 45-, 55- and 61-bit primes (``chip_smoke._b4_moduli``):
at ``chip_smoke.py`` phase 10's sizes (N = 2^6, 2^10, 2^14, 2^15, 2^16 at
[1, 1], [1, 9] and [2, 21]) and at the launch shapes of the wide step,
bootstrap and circuits at N = 2^14 (4 to 126 rows), forward and inverse, at
every C the kernel is built for there (``ntt64_cuda.clusters``), L2 warm;
and the row counts between, where the rule changes (N = 2^13 at phase 10's
rows and 126, 2^14 at 64-126 rows, 2^15 at 2-8 and 126 rows, 2^16 at 2-8
rows).  With ``--shapes``
(``chip_smoke.py``'s ``_build/b4_shapes.json``, or ``b4_shapes_n16.json``
from ``tools/staged_phase.py n16``), also every shape the phases recorded
launched B4 at, in its direction and ring (the CI ring's through the
CI mode).  Then the ladder below one transform at [1, 1], [2, 7] and
[2, 21] x 2^14 and every C: an empty launch of B4's geometry, the row's data
movement alone (``tools/ntt64_ladder.cu``, rungs 0 and 1), and the full
kernel: the launch's own cost, the load and store, and what the passes add.

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
    ap.add_argument("--b4", action="store_true", help="kernel B4 at phases 10-11's shapes")
    ap.add_argument("--shapes", default=None, help="with --b4: chip_smoke.py's b4_shapes.json")
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
    name = "ntt_cluster_sweep_b5.json" if args.b5 else \
        "ntt_cluster_sweep_b4.json" if args.b4 else "ntt_cluster_sweep.json"
    args.out = args.out or str(ntt_cuda.BUILD_DIR / name)
    if args.b4:
        return sweep_b4(dev, sms, smi, args.out, args.shapes)
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


B4_SIZES = [(logn, lead, limbs) for logn in (6, 10, 14, 15, 16)
            for lead, limbs in (((1,), 1), ((1,), 9), ((2,), 21))]
B4_STEP = [(14, lead, limbs) for lead, limbs in (
    ((1,), 6), ((1,), 7), ((2,), 2), ((4,), 2), ((2,), 7), ((4,), 7), ((2,), 14), ((2,), 19),
    ((6,), 19), ((6,), 21))]
B4_RULE = [(13, lead, limbs) for lead, limbs in (((1,), 1), ((1,), 9), ((2,), 21), ((6,), 21))] + [
    (15, (6,), 21)] + [
    (14, lead, limbs) for lead, limbs in (((4,), 16), ((4,), 21), ((5,), 20), ((6,), 21))] + [
    (logn, lead, 1) for logn in (15, 16) for lead in ((2,), (3,), (4,), (5,), (6,), (7,), (8,))]
B4_LADDER = [(14, (1,), 1), (14, (2,), 7), (14, (2,), 21)]
LADDER_SOURCE = Path(__file__).resolve().parent / "ntt64_ladder.cu"


def _ladder(logn: int):
    """The ladder library of N = 2^logn (``tools/ntt64_ladder.cu``)."""
    import ctypes
    ntt_cuda.build([logn], LADDER_SOURCE)
    lib = ctypes.CDLL(str(ntt_cuda.library_path(logn, LADDER_SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt64_ladder.argtypes = [i, i, p, p, i, i, p]
    lib.mfhe_ntt64_ladder.restype = i
    return lib


def sweep_b4(dev, sms: int, smi: str, out_path: str, shapes_path=None) -> int:
    """B4 at every cluster size at phases 10-11's shapes (and the recorded
    ones), then the ladder."""
    from matrix_fhe_tpu_torch.ops import ntt64_cuda, rings
    recorded = json.loads(Path(shapes_path).read_text())["shapes"] if shapes_path else []
    logns = sorted({logn for logn, _, _ in B4_SIZES + B4_STEP + B4_RULE}
                   | {r["shape"][-1].bit_length() - 1 for r in recorded})
    ntt_cuda.build_all([(ntt64_cuda.SOURCE, logn) for logn in logns]
                       + [(LADDER_SOURCE, logn) for logn, _, _ in B4_LADDER[:1]])
    rng = np.random.default_rng(0)
    rings_by_n = {}
    out = {"device": smi, "sweep": [], "ladder": []}

    def operands(logn, lead, limbs):
        n = 1 << logn
        if n not in rings_by_n:
            rings_by_n[n] = rings.new_ring(n, chip_smoke._b4_moduli(n), device=dev)
        ring = rings_by_n[n].limbs(0, limbs)
        return ring, chip_smoke._words(rng, lead, ring.moduli_tuple, n).to(dev)

    cases = [(logn, lead, limbs, None, False, ("fwd", "bwd"), None)
             for logn, lead, limbs in B4_SIZES + B4_STEP + B4_RULE]
    cases += [(r["shape"][-1].bit_length() - 1, tuple(r["shape"][:-2]), r["shape"][-2],
               r["moduli"], r["ci"], (r["dir"],), r["launches"]) for r in recorded]
    for logn, lead, limbs, moduli, ci, dirs, launches in cases:
        n = 1 << logn
        if moduli is None:
            ring, x = operands(logn, lead, limbs)
        else:
            key = (n, tuple(moduli), ci)
            if key not in rings_by_n:
                rings_by_n[key] = rings.new_ring(
                    n, moduli, rings.CONJUGATE_INVARIANT if ci else rings.STANDARD, device=dev)
            ring = rings_by_n[key]
            x = chip_smoke._words(rng, lead, ring.moduli_tuple, n).to(dev)
        rows = int(np.prod(lead)) * limbs
        cs = ntt64_cuda.clusters(n)
        rec = {"shape": list(lead) + [limbs, n], "rows": rows, "clusters": cs, "ci": ci,
               "launches": launches, "picked": ntt64_cuda.geometry(rows, n, sms)}
        cells = []
        for d in dirs:
            fwd = d == "fwd"
            want = ntt64_cuda.launch(x, ring, fwd, cluster=cs[0], ci=ci)
            for c in cs:
                assert torch.equal(ntt64_cuda.launch(x, ring, fwd, cluster=c, ci=ci), want), \
                    (rec["shape"], d, c)
                rec[f"{d}_C{c}"] = chip_smoke._device_ms(
                    lambda: ntt64_cuda.launch(x, ring, fwd, cluster=c, ci=ci))
            t = [rec[f"{d}_C{c}"] for c in cs]
            cells.append(f"{d} " + " / ".join(f"{v * 1e3:.2f}" for v in t)
                         + f" us (fastest C={cs[int(np.argmin(t))]})")
        out["sweep"].append(rec)
        print(f"B4 {'CI ' if ci else ''}{str(rec['shape']):18s} picked C={rec['picked']}"
              f"{'' if launches is None else f' ({launches} launches)'} | device time queued at "
              f"C = {' / '.join(map(str, cs))}: " + " | ".join(cells))
    lib = _ladder(14)
    for logn, lead, limbs in B4_LADDER:
        ring, x = operands(logn, lead, limbs)
        rows = int(np.prod(lead)) * limbs
        y = torch.empty_like(x)
        for fwd in (True, False):
            for c in ntt64_cuda.clusters(1 << logn):
                def rung(k):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    err = lib.mfhe_ntt64_ladder(k, int(fwd), x.data_ptr(), y.data_ptr(),
                                                rows, c, stream)
                    assert err == 0, f"ladder rung {k}: CUDA error {err}"
                rung(1)
                torch.cuda.synchronize()
                assert torch.equal(y, x), "ladder: load + store changed the row"
                rec = {"shape": list(lead) + [limbs, 1 << logn], "dir": "fwd" if fwd else "bwd",
                       "C": c, "launch": chip_smoke._device_ms(lambda: rung(0)),
                       "load_store": chip_smoke._device_ms(lambda: rung(1)),
                       "kernel": chip_smoke._device_ms(
                           lambda: ntt64_cuda.launch(x, ring, fwd, cluster=c))}
                out["ladder"].append(rec)
                print(f"B4 ladder {str(rec['shape']):16s} {rec['dir']} C={c}: empty launch "
                      f"{rec['launch'] * 1e3:.2f} us, load + store {rec['load_store'] * 1e3:.2f} "
                      f"us, full kernel {rec['kernel'] * 1e3:.2f} us (device time queued)")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1))
    print(f"wrote {out_path}")
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

"""Kernel B4 (``csrc/ntt64.cu``) against another version of its source, on
one card, in turns.

    python tools/ntt64_ab.py --old PATH [--shapes PATH] [--out PATH]

``--old`` is a B4 source outside the package, for example the parent
commit's, written by ``git show <commit>:matrix_fhe_tpu_torch/csrc/ntt64.cu``
into a directory that ``.gitignore`` lists.  Both are built with the port's
flags (``ops/ntt_cuda.py:build_all``), each library named by its source's
hash.  An old source whose entry points take the twiddles and their Shoup
quotients as two [L, N] tables (the interface before the 16-byte pairs) is
called with the two halves of the ring's pairs (``psi2``) made contiguous;
one with the pairs, with ``psi2``.  The old kernel runs at the cluster size of
the rule it shipped with (``OLD_RULE``: ``parent_geometry``), the new one at
``ntt64_cuda.geometry``'s.

Shapes: ``chip_smoke.py`` phase 10's sizes (N = 2^6, 2^10, 2^14, 2^15, 2^16
at [1, 1], [1, 9] and [2, 21], standard ring), and every shape in
``--shapes`` (``chip_smoke.py`` writes the shapes of phases 8-13 and 16 with
their launches and moduli to ``_build/b4_shapes.json``), the CI ring's through
the CI entries.  At each, forward and inverse: the two outputs are held
bit-identical, then the device time queued (``chip_smoke._device_ms``) of
each version in turns, old, new, new, old, twice each.  Prints a line a
shape (the median of each version's four turns, the ratio new / old, every
turn, the bound; a turn is the mean of 20 launches queued behind a spin
kernel, and a host stall while they are enqueued shows as one turn several
times the others, which the median leaves out), then for the recorded
shapes the loss launches x (device - bound) summed, old and new, and writes
every time as JSON to ``--out`` (default ``_build/ntt64_ab.json``).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from matrix_fhe_tpu_torch.ops import ntt64_cuda, ntt_cuda, rings  # noqa: E402

SIZES = [(logn, lead, limbs) for logn in (6, 10, 14, 15, 16)
         for lead, limbs in (((1,), 1), ((1,), 9), ((2,), 21))]


def parent_geometry(rows: int, n: int, sms: int) -> int:
    """The cluster rule B4 shipped with before its 64-bit sweep (B1's rule:
    C = 8 from N = 2^14 on; below, C = 8 for few rows, else the smallest C
    with rows * C >= sms, at least N / 2^14; C = 1 below 2^13)."""
    c = max(1, n // (1 << 14))
    if n < 1 << 13:
        return c
    if rows * 8 <= 3 * sms or n >= 1 << 14:
        return 8
    while c < 8 and rows * c < sms:
        c *= 2
    return c


OLD_RULE = parent_geometry


class Version:
    """One B4 source's libraries, bound by the interface its entry points
    declare."""

    def __init__(self, source: Path, logns, rule):
        self.source, self.rule = source, rule
        text = source.read_text()
        head = text[text.index('extern "C" int mfhe_ntt64_fwd'):]
        self.split = "psi_shoup" in head[:head.index("{")]
        ntt_cuda.build_all([(source, logn) for logn in logns])
        self.libs = {}
        p, i = ctypes.c_void_p, ctypes.c_int
        tabs = 2 if self.split else 1
        for logn in logns:
            lib = ctypes.CDLL(str(ntt_cuda.library_path(logn, source)))
            lib.mfhe_ntt64_fwd.argtypes = [p] * (3 + tabs) + [i] * 5 + [p]
            lib.mfhe_ntt64_bwd.argtypes = [p] * (5 + tabs) + [i] * 5 + [p]
            lib.mfhe_ntt64_ci_fwd.argtypes = [p] * (4 + tabs) + [i] * 5 + [p]
            lib.mfhe_ntt64_ci_bwd.argtypes = [p] * (4 + tabs) + [i] * 5 + [p]
            for f in (lib.mfhe_ntt64_fwd, lib.mfhe_ntt64_bwd, lib.mfhe_ntt64_ci_fwd,
                      lib.mfhe_ntt64_ci_bwd):
                f.restype = i
            self.libs[logn] = lib
        self.cache: dict = {}

    def tables(self, ring, fwd: bool):
        if not self.split:
            return (ring.psi2 if fwd else ring.ipsi2,)
        key = (id(ring), fwd)
        if key not in self.cache:
            pairs = ring.psi2 if fwd else ring.ipsi2
            self.cache[key] = (ring, pairs[..., 0].contiguous(), pairs[..., 1].contiguous())
        return self.cache[key][1:]

    def call(self, x, out, ring, fwd: bool, ci: bool, sms: int):
        n = ring.n
        logn = n.bit_length() - 1
        rows = x.numel() // n
        lib = self.libs[logn]
        if ci:
            entry = lib.mfhe_ntt64_ci_fwd if fwd else lib.mfhe_ntt64_ci_bwd
            rest = (ring.moduli, ring.fold_row)
        else:
            entry = lib.mfhe_ntt64_fwd if fwd else lib.mfhe_ntt64_bwd
            rest = (ring.moduli,) if fwd else (ring.moduli, ring.ninv_plain, ring.ninv_shoup)
        ptrs = [t.data_ptr() for t in self.tables(ring, fwd) + rest]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), out.data_ptr(), *ptrs, rows, ring.num_limbs, logn,
                    self.rule(rows, n, sms), x.get_device(), stream)
        assert err == 0, f"{self.source}: CUDA error {err}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the other B4 source")
    ap.add_argument("--shapes", default=None, help="chip_smoke.py's b4_shapes.json")
    ap.add_argument("--out", default=str(ntt_cuda.BUILD_DIR / "ntt64_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt64_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    ops_s = chip_smoke.INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    recorded = json.loads(Path(args.shapes).read_text())["shapes"] if args.shapes else []
    cases = []
    for logn, lead, limbs in SIZES:
        n = 1 << logn
        cases.append({"shape": list(lead) + [limbs, n], "ci": False, "launches": None,
                      "moduli": chip_smoke._b4_moduli(n)[:limbs], "phase": "phase 10 size"})
    for r in recorded:   # "moduli" and "launches" may be left out: phase 10's primes, no count
        n, limbs = r["shape"][-1], r["shape"][-2]
        primes = chip_smoke._b4_moduli(2 * n if r.get("ci") else n)  # CI: q = 1 mod 4N
        cases.append({"moduli": primes[:limbs], "launches": None,
                      **r, "phase": "recorded" if r.get("launches") is not None else "listed"})
    logns = sorted({c["shape"][-1].bit_length() - 1 for c in cases})
    new = Version(ntt64_cuda.SOURCE, logns, ntt64_cuda.geometry)
    old = Version(Path(args.old).resolve(), logns, OLD_RULE)
    print(f"new: {new.source.name} ({'split' if new.split else 'paired'} tables), old: "
          f"{old.source} ({'split' if old.split else 'paired'} tables)")
    rng = np.random.default_rng(0)
    ring_cache: dict = {}
    out = []
    dirs = {"fwd": True, "bwd": False}
    for case in cases:
        n = case["shape"][-1]
        kind = rings.CONJUGATE_INVARIANT if case["ci"] else rings.STANDARD
        key = (n, tuple(case["moduli"]), kind)
        if key not in ring_cache:
            ring_cache[key] = rings.new_ring(n, list(case["moduli"]), kind, device=dev)
        ring = ring_cache[key]
        x = chip_smoke._words(rng, tuple(case["shape"][:-2]), ring.moduli_tuple, n).to(dev)
        rows = int(np.prod(case["shape"][:-1]))
        for d in ([case["dir"]] if "dir" in case else ["fwd", "bwd"]):
            fwd = dirs[d]
            y_old, y_new = torch.empty_like(x), torch.empty_like(x)
            old.call(x, y_old, ring, fwd, case["ci"], sms)
            new.call(x, y_new, ring, fwd, case["ci"], sms)
            torch.cuda.synchronize()
            assert torch.equal(y_old, y_new), f"{case['shape']} {d}: new != old"
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old") * 2:
                v = old if who == "old" else new
                y = y_old if who == "old" else y_new
                times[who].append(chip_smoke._device_ms(
                    lambda: v.call(x, y, ring, fwd, case["ci"], sms)))
            bound = max(chip_smoke._b4_bound(rows, case["shape"][-2], n, fwd, ops_s,
                                             ci=case["ci"]))
            rec = {"shape": case["shape"], "dir": d, "ci": case["ci"], "phase": case["phase"],
                   "launches": case["launches"], "old_C": OLD_RULE(rows, n, sms),
                   "new_C": ntt64_cuda.geometry(rows, n, sms), "old_ms": times["old"],
                   "new_ms": times["new"], "bound_ms": bound}
            t_old, t_new = np.median(times["old"]), np.median(times["new"])
            out.append(rec)
            print(f"{case['phase']:14s} {'CI ' if case['ci'] else ''}{d} "
                  f"{str(case['shape']):18s} C {rec['old_C']:2d} -> {rec['new_C']:2d}: old "
                  f"{t_old * 1e3:7.2f} us, new {t_new * 1e3:7.2f} us (new / old "
                  f"{t_new / t_old:.3f}; turns old {', '.join(f'{t * 1e3:.2f}' for t in times['old'])}"
                  f", new {', '.join(f'{t * 1e3:.2f}' for t in times['new'])}), bound "
                  f"{bound * 1e3:.3f} us{'' if rec['launches'] is None else ', launches ' + str(rec['launches'])}")
    worst = max(out, key=lambda r: np.median(r["new_ms"]) / np.median(r["old_ms"]))
    print(f"largest new / old: {np.median(worst['new_ms']) / np.median(worst['old_ms']):.3f} at "
          f"{'CI ' if worst['ci'] else ''}{worst['dir']} {worst['shape']} ({worst['phase']})")
    rec_rows = [r for r in out if r["launches"]]
    if rec_rows:
        for ci in (False, True):
            part = [r for r in rec_rows if r["ci"] == ci]
            if part:
                lo = sum(r["launches"] * (np.median(r["old_ms"]) - r["bound_ms"]) for r in part)
                ln = sum(r["launches"] * (np.median(r["new_ms"]) - r["bound_ms"]) for r in part)
                print(f"loss launches x (device - bound), {'phase 16, CI ring' if ci else 'phases 8-13'}"
                      f" ({len(part)} shapes, {sum(r['launches'] for r in part)} launches): old "
                      f"{lo:.4f} ms, new {ln:.4f} ms | {smi}")
        lo = sum(r["launches"] * (np.median(r["old_ms"]) - r["bound_ms"]) for r in rec_rows)
        ln = sum(r["launches"] * (np.median(r["new_ms"]) - r["bound_ms"]) for r in rec_rows)
        print(f"loss launches x (device - bound), phases 8-13 and 16: old {lo:.4f} ms, new "
              f"{ln:.4f} ms ({ln / lo:.3f}) | {smi}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "rows": out}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

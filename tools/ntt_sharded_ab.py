"""Kernel B6 (``csrc/ntt_sharded.cu``) against other versions of its source,
and its geometry candidates, on one card, in turns.

    python tools/ntt_sharded_ab.py --old PATH [--variant PATH ...] [--sweep] [--out PATH]

``--old`` is a B6 source outside the package, for example the parent
commit's, written by ``git show <commit>:matrix_fhe_tpu_torch/csrc/ntt_sharded.cu``
into a directory that ``.gitignore`` lists; each ``--variant`` another
source with the new entry point (a change of the new kernel to try).  All
are built with the port's flags (``ops/ntt_cuda.py:build_all``), each
library named by its source's hash.  A source whose entry point takes no
geometry (the kernel before its redesign: one CTA of 256 threads a 16-row
tile) is called without it; the others at ``ntt_sharded_cuda.geometry``'s.

Blocks: ``chip_smoke.py`` phase 26's three (a k = 8, 2 and 1 shard's first
block of [2, 10, 2^14] on the flagship's moduli), then the k = 8, 2 and 1
blocks of [2, 10, N] at N = 2^10, 2^12 and 2^16 (``chip_smoke._b4_moduli``'s
first 10 primes).  At each the outputs of every version are held
bit-identical (and to the plain version at phase 26's blocks), then the
device time queued (``chip_smoke._device_ms``) of each in turns: old, new,
variants, variants, new, old, twice.  Prints a line a block: the median of
each version's four turns, new / old, every turn, the L2-flushed time of
old and new (``chip_smoke._flushed_ms``) and the bound
(``chip_smoke._b6_bound``).  ``--sweep``: at every block, the new kernel at
each geometry it takes (``ntt_sharded_cuda.candidates``) in turns (the list, then reversed,
twice), medians of four, each output held to the rule's.  Every time goes
as JSON to ``--out`` (default ``_build/ntt_sharded_ab.json``).  Needs a CUDA
card.
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
from matrix_fhe_tpu_torch import flagship  # noqa: E402
from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_sharded_cuda  # noqa: E402

LEAD, LIMBS = 2, 10
SHARDS = (8, 2, 1)
OTHER_LOGNS = (10, 12, 16)



class Version:
    """One B6 source's library, bound by the entry point it declares."""

    def __init__(self, source: Path):
        self.source = source
        text = source.read_text()
        head = text[text.index('extern "C" int mfhe_ntt_sharded_local'):]
        self.geom = "int threads" in head[:head.index("{")]
        ntt_cuda.build_all([(source, ntt_sharded_cuda.BUILD_KEY)])
        lib = ctypes.CDLL(str(ntt_cuda.library_path(ntt_sharded_cuda.BUILD_KEY, source)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mfhe_ntt_sharded_local.argtypes = [p] * 8 + [i] * (13 if self.geom else 7) + [p]
        lib.mfhe_ntt_sharded_local.restype = i
        self.entry = lib.mfhe_ntt_sharded_local

    def call(self, x, out, tabs, col0: int, geom=None):
        L, R, C, c = int(tabs.moduli.shape[0]), tabs.rows, tabs.cols, x.shape[-1]
        ts = (tabs.a_mat, tabs.tw, tabs.bt_mat, tabs.moduli, tabs.qinv, tabs.bhi)
        extra = ntt_sharded_cuda.geometry(R, C, c, *(geom or ())) if self.geom else ()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = self.entry(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ts),
                         x.numel() // (L * R * c), L, R, C, c, col0, *extra, x.get_device(),
                         stream)
        assert err == 0, f"{self.source}: CUDA error {err}"


def _turns(versions: dict, call, order) -> dict:
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke._device_ms(lambda: call(versions[name])))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the other B6 source")
    ap.add_argument("--variant", action="append", default=[], help="a variant of the new source")
    ap.add_argument("--sweep", action="store_true", help="time the geometry candidates")
    ap.add_argument("--out", default=str(ntt_cuda.BUILD_DIR / "ntt_sharded_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt_sharded_ab: no CUDA device", file=sys.stderr)
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
    versions = {"old": Version(Path(args.old).resolve()), "new": Version(ntt_sharded_cuda.SOURCE)}
    for k, path in enumerate(args.variant):
        versions[f"variant{k + 1}"] = Version(Path(path).resolve())
    for name, v in versions.items():
        print(f"{name}: {v.source}")
    variants = [n for n in versions if n.startswith("variant")]
    order = ["old", "new", *variants, *variants[::-1], "new", "old"] * 2
    rng = np.random.default_rng(0)
    fp = flagship.flagship_parameters(*chip_smoke.FLAGSHIP, device=dev)
    cases = [(chip_smoke.LOGN, list(fp.q) + list(fp.p), "phase 26")]
    cases += [(logn, chip_smoke._b4_moduli(1 << logn)[:LIMBS], "size") for logn in OTHER_LOGNS]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for logn, moduli, kind in cases:
        n = 1 << logn
        tabs = ntt_sharded_cuda.build_tables(n, moduli, dev)
        x = chip_smoke._words(rng, (LEAD,), moduli, n).to(dev).reshape(
            LEAD, len(moduli), tabs.rows, tabs.cols)
        for k in SHARDS:
            c = tabs.cols // k
            blk = x[..., :c].contiguous()
            outs = {name: torch.empty(blk.shape[:-1] + (tabs.cols,), dtype=torch.int64,
                                      device=dev) for name in versions}
            for name, v in versions.items():
                v.call(blk, outs[name], tabs, 0)
            torch.cuda.synchronize()
            for name in versions:
                assert torch.equal(outs[name], outs["new"]), f"2^{logn} k={k}: {name} != new"
            if kind == "phase 26":
                assert torch.equal(outs["new"], ntt_sharded_cuda.local_step_plain(blk, tabs, 0))
            times = _turns(versions, lambda v: v.call(blk, outs["new"], tabs, 0), order)
            flushed = {name: chip_smoke._flushed_ms(
                lambda v=versions[name]: v.call(blk, outs[name], tabs, 0), flush)
                for name in ("old", "new")}
            bound = chip_smoke._b6_bound(LEAD, len(moduli), tabs.rows, tabs.cols, c, ops_s)
            med = {name: float(np.median(t)) for name, t in times.items()}
            if args.sweep:
                got = torch.empty_like(outs["new"])
                cands = ntt_sharded_cuda.candidates(tabs.rows, tabs.cols, c)
                sw = {g: [] for g in cands}
                for g in (cands + cands[::-1]) * 2:
                    versions["new"].call(blk, got, tabs, 0, g)
                    torch.cuda.synchronize()
                    assert torch.equal(got, outs["new"]), f"geometry {g}, 2^{logn} k={k}"
                    sw[g].append(chip_smoke._device_ms(
                        lambda: versions["new"].call(blk, got, tabs, 0, g)))
                rows_sweep = {",".join(map(str, g)): t for g, t in sw.items()}
                print(f"sweep    2^{logn} k = {k} (threads, ti, cn): " + ", ".join(
                    f"{g}: {np.median(t) * 1e3:.2f} us" for g, t in sw.items()), flush=True)
            rows.append({"kind": kind, "logn": logn, "k": k, "block": list(blk.shape),
                         "geometry": ntt_sharded_cuda.geometry(tabs.rows, tabs.cols, c)[:3],
                         "ms": times, "median_ms": med, "flushed_ms": flushed,
                         "bound_ms": bound, "sweep_ms": rows_sweep if args.sweep else None})
            turns = "; ".join(f"{name} " + ", ".join(f"{t * 1e3:.2f}" for t in ts)
                              for name, ts in times.items())
            print(f"{kind:8s} 2^{logn} k = {k} {list(blk.shape)}: "
                  + ", ".join(f"{name} {m * 1e3:.2f} us" for name, m in med.items())
                  + f" (new / old {med['new'] / med['old']:.3f}; turns {turns}); L2 flushed "
                  f"old {flushed['old'] * 1e3:.2f} us, new {flushed['new'] * 1e3:.2f} us; bound "
                  f"{max(bound) * 1e3:.3f} us ({'bytes' if bound[0] > bound[1] else 'operations'})"
                  f" | {smi}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

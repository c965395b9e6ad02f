"""Smoke run of the PyTorch port (matrix_fhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at the bench shape of the JAX package
(bench.py: logN = 14, 19 q-limbs + 3 p-limbs of primes < 2^23, rescale by
two primes, 8 hoisted rotations):

1. device: requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the NTT kernel (csrc/ntt.cu) from this checkout, one
   library for each N the path runs (2^14, and 2^10 for phase 7), one nvcc
   each, started together;
3. kernel vs plain: at every NTT shape of the step, the kernel's forward and
   inverse are bit-identical to the plain torch version run on CPU copies,
   inverse(forward(x)) == x, and both versions are timed on the card; the
   cluster size C the wrapper picks for the shape is printed, and beside the
   kernel's time its device time with the launches queued back to back, with
   L2 flushed before each launch (as the step finds it), and the wrapper's
   host time a call;
4. main path: three requests, each one mul_relin_rescale and one
   rotations_hoisted over the 8 galois elements, served from a synthetic
   context on the card.  The first request's outputs hash to the digests
   the JAX package gives for the same call (tools/port_reference_digest.py),
   every request equals the same step on the CPU through the plain path, and
   the NTT kernel is launched the expected number of times per request.

Then the NTT-throughput path of the JAX package (bench.py:50-98) and the
w22 transform:

5. chain kernel vs plain: at [8, 3, 2^14] with k = 3, the chained transform
   (ntt_cuda.ntt_chain) forward and inverse is bit-identical to the plain
   version on CPU copies, and inverse-chain(forward-chain(x)) == x;
6. NTT path at bench width: over [24, 10, 2^14] the forward and the inverse
   chain of k = 500 transforms, one launch each, and the per-launch
   transform over [64, 10, 2^14] (bench.py's dispatch form), on bench.py's
   primes and operands.  The forward chain equals 500 sequential ntt_fwd
   launches and the plain chain, the inverse chain returns x, and the rates
   (NTTs per second) of both forms are printed beside the card, with the
   chain kernels' instructions a butterfly in their hot pass and their
   registers and spills (tools/ntt_sass.py, from the built SASS);
7. w22 transform (ntt_w22, the v1 kernel's counterpart, q < 2^22): a
   forward and inverse over [8, 4, 2^14] (tests/test_pallas_ntt.py's shape)
   returns x, and at that shape and at [2, 3, 2^10] the kernel is
   bit-identical to the plain version.

Prints a JSON line of per-kernel results, one entry per kernel entry point:
launches on its path (phase 4 for ntt_fwd/ntt_bwd, 6 for the chain, 7 for
w22; counts zeroed just before and read just after), max |kernel - plain|,
the kernel's and plain version's times (phase 3's shapes summed, one launch
each, for ntt_fwd/ntt_bwd; the path's shape for the others), and the bound:
the larger of the bytes over the card's memory rate and the butterflies'
integer operations over its int32 rate.  Times in that line are CUDA-event
means of launches issued back to back from the host (_event_ms).  No single
PyTorch call computes a negacyclic NTT mod q, so library_ms is null.  Then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero.
The script imports no jax.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LOGN, NUM_Q, NUM_P, NUM_ROT, SEED = 14, 19, 3, 8, 0
# tools/port_reference_digest.py: the JAX package on the CPU, same call
MUL_RELIN_RESCALE_SHA256 = "54a57d651c2c489df7f6716e62e7749541871319469d9fe59d568cc024185523"
ROTATIONS_HOISTED_SHA256 = "b78881c6409abe820ebe6b32a2f780dbf5b4481f3637a5244d0557d0b1defc94"
# the TPU kernel each entry point replaces: ntt_fwd / ntt_bwd reach
# _transform (pallas_ntt2.py:304) and its pl.pallas_call, the chain is
# pallas_ntt2.ntt_chain, ntt_w22's reach _transform -> _call (pallas_ntt.py)
REPLACES = {"fwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:352",
            "bwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:357",
            "chain_fwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:363",
            "chain_bwd": "matrix_fhe_tpu/ops/pallas_ntt2.py:363",
            "w22_fwd": "matrix_fhe_tpu/ops/pallas_ntt.py:294",
            "w22_bwd": "matrix_fhe_tpu/ops/pallas_ntt.py:299"}
SOURCE = "matrix_fhe_tpu_torch/csrc/ntt.cu"
# bench.py:64-74 and :86-88: the chain and the dispatch form of the NTT bench
BENCH_LIMBS, CHAIN_BATCH, CHAIN_K, DISPATCH_BATCH = 10, 24, 500, 64
# tests/test_pallas_ntt.py:51, and a small ring
W22_SHAPES = [(8, 4, 1 << 14), (2, 3, 1 << 10)]
# log2 N of every launch of the path: the step's and the NTT bench's, and w22's
PATH_LOGNS = sorted({LOGN} | {s[-1].bit_length() - 1 for s in W22_SHAPES})
# The bound.  Bytes: each input read once (x, the twiddles and their Shoup
# quotients), the output written once, at the H100 SXM's 3.35 TB/s.
# Operations: 7 integer operations a butterfly (a Shoup product is two
# multiplies and a high multiply; then an add, a subtract and a conditional
# subtract of two), (N/2) log2(N) butterflies a transform, at the SM's
# int32 issue rate at the card's maximum SM clock.  On compute capability
# 9.0 the multiplies run on the FMA pipe and the adds, compares and selects
# on the ALU pipe, 64 a clock each, so a mix of both issues at 128 a clock
# (4 schedulers x 32 lanes).  The per-element reductions are left out (< 5%).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_BUTTERFLY = 7
INT32_OPS_PER_CLOCK_PER_SM = 128


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().astype("<i4").tobytes())
    return h.hexdigest()


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time of one call of fn() (the wrapper's enqueue), the
    device left to run behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3 / iters


def _hold_device(host_s: float) -> None:
    """Keep the device busy for a while (a spin kernel) so that the launches
    enqueued after it run back to back."""
    torch.cuda._sleep(int(min(max(host_s * 1.5, 1e-3), 0.5) * 2e9))


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches queued behind a spin
    kernel: the events time the device alone, without the host's gaps
    between the launches of a kernel shorter than its wrapper's host time."""
    host = _host_ms(fn, 1, warmup) / 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    _hold_device(host * iters)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _flushed_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Mean device time of fn() with L2 flushed before each launch: a write
    of ``flush`` (larger than the 50 MB L2) between launches, outside the
    timed spans."""
    fn()
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    _hold_device(2e-4 * iters)
    for start, stop in spans:
        flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(stop) for start, stop in spans) / iters


def _bound(rows: int, limbs: int, n: int, k: int, int32_ops_per_s: float):
    """(bytes time, operations time) in ms of k transforms of ``rows`` rows
    over ``limbs`` limbs of N = n."""
    nbytes = 4 * n * (2 * rows + 2 * limbs)
    ops = rows * k * (n // 2) * (n.bit_length() - 1) * OPS_PER_BUTTERFLY
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / int32_ops_per_s * 1e3


def _bound_entry(parts) -> dict:
    """bound_ms and bound_by of a kernel over one or more (bytes, ops) times."""
    total = sum(max(b, o) for b, o in parts)
    by = "operations" if sum(o for _, o in parts) >= sum(b for b, _ in parts) else "bytes"
    return {"bound_ms": total, "bound_by": by}


def _operands(rng, shape, moduli) -> torch.Tensor:
    hi = np.array(moduli, dtype=np.int64)[:, None]
    return torch.from_numpy((rng.integers(0, 1 << 62, shape) % hi).astype(np.int32))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from matrix_fhe_tpu_torch.fast import fckks, fring
    from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain, ntt_w22

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = ntt_cuda.build(PATH_LOGNS)
    print(f"phase build: built {len(built)} libraries, "
          f"{', '.join(ntt_cuda.library_path(logn).name for logn in built)}, in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain at the step's NTT shapes ----------------------------
    n = 1 << LOGN
    moduli = fring.find_fast_primes(n, NUM_Q + NUM_P)
    Q, P = moduli[:NUM_Q], moduli[NUM_Q:]
    shapes = [("rescale INTT", (NUM_Q,), Q), ("rescale NTT", (NUM_Q - 2,), Q[:-2]),
              ("decompose NTT q", (7, NUM_Q), Q), ("decompose NTT p", (7, NUM_P), P),
              ("mod_down INTT", (2, NUM_P), P), ("mod_down NTT", (2, NUM_Q), Q)]
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # per direction: max |kernel - plain| and the summed times over the shapes
    stats = {d: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0} for d in ("fwd", "bwd")}
    # per direction, summed over the shapes: device time queued back to
    # back, with L2 flushed, and the wrapper's host time a call
    extra = {d: {"device": 0.0, "flushed": 0.0, "host": 0.0} for d in ("fwd", "bwd")}
    for what, lead, mods in shapes:
        tab_cpu = ntt_cuda.build_tables(n, mods, "cpu")
        tab_dev = ntt_cuda.build_tables(n, mods, dev)
        hi = np.array(mods, dtype=np.int64)[:, None]
        x_cpu = torch.from_numpy(
            (rng.integers(0, 1 << 62, lead + (n,)) % hi).astype(np.int32))
        x = x_cpu.to(dev)
        f, b = ntt_cuda.ntt_fwd(x, tab_dev), ntt_cuda.ntt_bwd(x, tab_dev)
        rt = ntt_cuda.ntt_bwd(f, tab_dev)
        torch.cuda.synchronize()
        want_f = ntt_plain.ntt_fwd_plain(x_cpu, tab_cpu)
        want_b = ntt_plain.ntt_bwd_plain(x_cpu, tab_cpu)
        err = {"fwd": int((f.cpu().long() - want_f.long()).abs().max()),
               "bwd": int((b.cpu().long() - want_b.long()).abs().max())}
        assert err == {"fwd": 0, "bwd": 0}, f"{what} {lead}: kernel != plain {err}"
        assert torch.equal(rt.cpu(), x_cpu), f"{what}: inverse(forward(x)) != x"
        # the plain version on the card computes the same (float64 matmuls)
        assert torch.equal(ntt_plain.ntt_fwd_plain(x, tab_dev).cpu(), want_f)
        assert torch.equal(ntt_plain.ntt_bwd_plain(x, tab_dev).cpu(), want_b)
        k_f = _event_ms(lambda: ntt_cuda.ntt_fwd(x, tab_dev))
        k_b = _event_ms(lambda: ntt_cuda.ntt_bwd(x, tab_dev))
        p_f = _event_ms(lambda: ntt_plain.ntt_fwd_plain(x, tab_dev))
        p_b = _event_ms(lambda: ntt_plain.ntt_bwd_plain(x, tab_dev))
        for d, k, p in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err[d])
            stats[d]["ms"] += k
            stats[d]["plain_ms"] += p
        c = ntt_cuda.geometry(int(np.prod(lead)), n, 1, sms)
        more = {}
        for d, kern in (("fwd", ntt_cuda.ntt_fwd), ("bwd", ntt_cuda.ntt_bwd)):
            more[d] = {"device": _device_ms(lambda: kern(x, tab_dev)),
                       "flushed": _flushed_ms(lambda: kern(x, tab_dev), flush),
                       "host": _host_ms(lambda: kern(x, tab_dev))}
            for key, v in more[d].items():
                extra[d][key] += v
        print(f"phase kernel: {what:16s} {str(list(lead) + [n]):14s} C={c} "
              f"kernel fwd {k_f:.4f} ms bwd {k_b:.4f} ms | "
              f"plain fwd {p_f:.4f} ms bwd {p_b:.4f} ms | bit-identical")
        print("phase kernel:   fwd / bwd: device time queued {:.4f} / {:.4f} ms, "
              "L2 flushed {:.4f} / {:.4f} ms, wrapper host time {:.4f} / {:.4f} ms "
              "a call".format(*(more[d][key] for key in ("device", "flushed", "host")
                                for d in ("fwd", "bwd"))))
    print("phase kernel: six shapes summed, fwd / bwd: kernel {:.4f} / {:.4f} ms, "
          "device time queued {:.4f} / {:.4f} ms, L2 flushed {:.4f} / {:.4f} ms, "
          "wrapper host time {:.4f} / {:.4f} ms".format(
              stats["fwd"]["ms"], stats["bwd"]["ms"],
              *(extra[d][key] for key in ("device", "flushed", "host")
                for d in ("fwd", "bwd"))))
    del flush

    # -- 4. main path: three requests ------------------------------------------
    ctx, ops = fckks.make_synthetic_context(
        LOGN, NUM_Q, NUM_P, seed=SEED, num_rot=NUM_ROT, device=dev)
    ref_ctx, ref_ops = fckks.make_synthetic_context(
        LOGN, NUM_Q, NUM_P, seed=SEED, num_rot=NUM_ROT, device="cpu")
    orders = [(0, 1, 2, 3), (2, 3, 0, 1), (1, 0, 3, 2)]  # operands per request
    # NTT launches per request.  mul_relin_rescale: decompose_ks 1 INTT +
    # 2 NTT, mod_down 1 + 1, two rescales 1 + 1 each.  rotations_hoisted over
    # G elements: decompose_ks 1 INTT + 2 NTT, then mod_down 1 + 1 per element.
    G = len(ctx.gal_els)
    per_request = {"fwd": 5 + 2 + G, "bwd": 4 + 1 + G}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = ntt_cuda.launches = 0
    outs, lat = [], []
    for r, order in enumerate(orders):
        a = [ops[i] for i in order]
        t0 = time.perf_counter()
        step = fckks.mul_relin_rescale(ctx, *a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rots = fckks.rotations_hoisted(ctx, a[0], a[1], ctx.gal_els)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs.append((step, rots))
        lat.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        counts = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
        want = {d: c * (r + 1) for d, c in per_request.items()}
        assert counts == want, f"request {r}: NTT launches {counts}, expected {want}"
    launches = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
    assert ntt_cuda.launches == sum(launches.values())
    peak = torch.cuda.max_memory_allocated()
    for r, (m, rot) in enumerate(lat):
        print(f"phase main: request {r}: mul_relin_rescale {m:.3f} ms, "
              f"rotations_hoisted x{len(ctx.gal_els)} {rot:.3f} ms")
    print(f"phase main: NTT kernel launches {launches} ({per_request} per request), "
          f"peak device memory {peak / 2**20:.1f} MiB")

    # steady state: the same request repeated, host clock around a sync
    reps = {"mul_relin_rescale": [], "rotations_hoisted": []}
    for _ in range(10):
        t0 = time.perf_counter()
        fckks.mul_relin_rescale(ctx, *ops)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fckks.rotations_hoisted(ctx, ops[0], ops[1], ctx.gal_els)
        torch.cuda.synchronize()
        reps["mul_relin_rescale"].append((t1 - t0) * 1e3)
        reps["rotations_hoisted"].append((time.perf_counter() - t1) * 1e3)
    for k, v in reps.items():
        print(f"phase main: steady {k}: median {statistics.median(v):.3f} ms "
              f"(min {min(v):.3f}, max {max(v):.3f}, 10 runs)")

    # -- checks ---------------------------------------------------------------
    (o0, o1), rots = outs[0]
    assert _digest([o0, o1]) == MUL_RELIN_RESCALE_SHA256, "mul_relin_rescale digest"
    assert _digest([t for g in ctx.gal_els for t in rots[g]]) == \
        ROTATIONS_HOISTED_SHA256, "rotations_hoisted digest"
    q_out = torch.tensor(Q[: NUM_Q - 2], dtype=torch.int32, device=dev)[:, None]
    for r, ((o0, o1), rots) in enumerate(outs):
        a = [ref_ops[i] for i in orders[r]]
        w0, w1 = fckks.mul_relin_rescale(ref_ctx, *a)
        assert o0.shape == o1.shape == (NUM_Q - 2, n)
        assert bool(((o0 >= 0) & (o0 < q_out)).all()) and bool(((o1 >= 0) & (o1 < q_out)).all())
        assert torch.equal(o0.cpu(), w0) and torch.equal(o1.cpu(), w1), \
            f"request {r}: mul_relin_rescale on the card != CPU plain path"
        want = fckks.rotations_hoisted(ref_ctx, a[0], a[1], ref_ctx.gal_els)
        for g in ctx.gal_els:
            assert torch.equal(rots[g][0].cpu(), want[g][0]) and \
                torch.equal(rots[g][1].cpu(), want[g][1]), \
                f"request {r}: rotation {g} on the card != CPU plain path"
    print("phase check: digests equal the JAX package's; all requests equal "
          "the CPU plain path")

    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    int32_ops_per_s = INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    print(f"bound: {HBM_BYTES_PER_S / 1e12} TB/s, {sms} SMs x "
          f"{INT32_OPS_PER_CLOCK_PER_SM} int32 op/clock at {max_sm_mhz} MHz = "
          f"{int32_ops_per_s / 1e12:.3f} Tops/s")
    step_bounds = [_bound(int(np.prod(lead)), len(mods), n, 1, int32_ops_per_s)
                   for _, lead, mods in shapes]
    for (what, lead, _), (b_ms, o_ms) in zip(shapes, step_bounds):
        print(f"bound: {what:16s} {str(list(lead) + [n]):14s} bytes {b_ms * 1e3:.3f} us, "
              f"operations {o_ms * 1e3:.3f} us")
    for d in ("fwd", "bwd"):
        stats[d].update(_bound_entry(step_bounds))

    # -- 5. chain kernel vs plain ----------------------------------------------
    moduli = ntt_cuda.find_v2_primes(n, BENCH_LIMBS)
    tab_cpu = ntt_cuda.build_tables(n, moduli[:3], "cpu")
    tab_dev = ntt_cuda.build_tables(n, moduli[:3], dev)
    x_cpu = _operands(rng, (8, 3, n), moduli[:3])
    x = x_cpu.to(dev)
    for fwd, d in ((True, "chain_fwd"), (False, "chain_bwd")):
        got = ntt_cuda.ntt_chain(x, tab_dev, 3, fwd=fwd)
        torch.cuda.synchronize()
        want = ntt_plain.ntt_chain_plain(x_cpu, tab_cpu, 3, fwd)
        err = int((got.cpu().long() - want.long()).abs().max())
        assert err == 0, f"chain {d} [8, 3, N] k=3: kernel != plain ({err})"
        if fwd:
            back = ntt_cuda.ntt_chain(got, tab_dev, 3, fwd=False)
            assert torch.equal(back.cpu(), x_cpu), "inverse-chain(forward-chain(x)) != x"
        k_ms = _event_ms(lambda: ntt_cuda.ntt_chain(x, tab_dev, 3, fwd=fwd))
        p_ms = _event_ms(lambda: ntt_plain.ntt_chain_plain(x, tab_dev, 3, fwd))
        stats[d] = {"max_abs_err": err}
        print(f"phase chain: {d:9s} [8, 3, {n}] k=3 kernel {k_ms:.4f} ms | "
              f"plain {p_ms:.4f} ms | bit-identical")

    # -- 6. NTT path at bench width --------------------------------------------
    tabs = ntt_cuda.build_tables(n, moduli, dev)
    brng = np.random.default_rng(0)  # bench.py:70-74, in its order
    xb = torch.from_numpy(brng.integers(
        0, min(moduli), (CHAIN_BATCH, BENCH_LIMBS, n), dtype=np.int64).astype(np.int32)).to(dev)
    xd = torch.from_numpy(brng.integers(
        0, min(moduli), (DISPATCH_BATCH, BENCH_LIMBS, n), dtype=np.int64).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    for name in ("fwd_launches", "bwd_launches", "chain_fwd_launches",
                 "chain_bwd_launches", "launches"):
        setattr(ntt_cuda, name, 0)
    f = ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=True)
    back = ntt_cuda.ntt_chain(f, tabs, CHAIN_K, fwd=False)
    fd = ntt_cuda.ntt_fwd(xd, tabs)
    torch.cuda.synchronize()
    path = {"chain_fwd": ntt_cuda.chain_fwd_launches,
            "chain_bwd": ntt_cuda.chain_bwd_launches, "dispatch": ntt_cuda.fwd_launches}
    assert path == {"chain_fwd": 1, "chain_bwd": 1, "dispatch": 1} and \
        ntt_cuda.launches == 3, f"NTT path launches {path}"
    assert torch.equal(back, xb), "500-step inverse chain of the forward chain != x"
    seq = xb
    for _ in range(CHAIN_K):
        seq = ntt_cuda.ntt_fwd(seq, tabs)
    assert torch.equal(f, seq), "chain != 500 sequential ntt_fwd launches"
    # the plain version on the card equals the CPU's (phase 3)
    assert torch.equal(fd, ntt_plain.ntt_fwd_plain(xd, tabs)), "dispatch form: kernel != plain"
    for fwd, d in ((True, "chain_fwd"), (False, "chain_bwd")):
        got = f if fwd else ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=False)
        want = ntt_plain.ntt_chain_plain(xb, tabs, CHAIN_K, fwd)
        err = int((got.long() - want.long()).abs().max())
        assert err == 0, f"{d} at bench width: kernel != plain ({err})"
        stats[d]["max_abs_err"] = max(stats[d]["max_abs_err"], err)
        stats[d]["ms"] = _event_ms(
            lambda: ntt_cuda.ntt_chain(xb, tabs, CHAIN_K, fwd=fwd), iters=5, warmup=1)
        stats[d]["plain_ms"] = _event_ms(
            lambda: ntt_plain.ntt_chain_plain(xb, tabs, CHAIN_K, fwd), iters=2, warmup=0)
        stats[d].update(_bound_entry(
            [_bound(CHAIN_BATCH * BENCH_LIMBS, BENCH_LIMBS, n, CHAIN_K, int32_ops_per_s)]))
        rate = CHAIN_BATCH * BENCH_LIMBS * CHAIN_K / (stats[d]["ms"] / 1e3)
        print(f"phase ntt path: {d:9s} [{CHAIN_BATCH}, {BENCH_LIMBS}, {n}] k={CHAIN_K} "
              f"kernel {stats[d]['ms']:.3f} ms ({stats[d]['ms'] / CHAIN_K * 1e3:.3f} us a "
              f"step, {rate:.0f} NTT/s) | plain {stats[d]['plain_ms']:.1f} ms | "
              f"bound {stats[d]['bound_ms']:.3f} ms by {stats[d]['bound_by']} | {smi}")
    from tools import ntt_sass
    funcs = ntt_sass.parse(ntt_sass.disassemble([LOGN]))
    regs = ntt_sass.ptxas_report(ntt_sass.build_logs([LOGN]))
    for d in ("fwd", "bwd"):
        name = f"ntt_{d}_kernel<{LOGN}, 1>"
        instrs, flies = ntt_sass.hot_pass(funcs[name])
        assert flies == 32, f"{name}: hot pass of {flies} butterflies"
        step_us = stats[f"chain_{d}"]["ms"] / CHAIN_K * 1e3
        print(f"phase ntt path: {name} hot pass {instrs} instructions / {flies} "
              f"butterflies = {instrs / flies:.2f} a butterfly; {regs[name]['registers']} "
              f"registers, {regs[name]['spill_bytes']} spill bytes; {step_us:.3f} us a step")
    d_ms = _event_ms(lambda: ntt_cuda.ntt_fwd(xd, tabs))
    d_dev = _device_ms(lambda: ntt_cuda.ntt_fwd(xd, tabs))
    d_bytes, d_ops = _bound(DISPATCH_BATCH * BENCH_LIMBS, BENCH_LIMBS, n, 1, int32_ops_per_s)
    print(f"phase ntt path: dispatch  [{DISPATCH_BATCH}, {BENCH_LIMBS}, {n}] ntt_fwd "
          f"{d_ms:.4f} ms a launch ({DISPATCH_BATCH * BENCH_LIMBS / (d_ms / 1e3):.0f} NTT/s; "
          f"device time queued {d_dev:.4f} ms) | "
          f"bound {max(d_bytes, d_ops):.4f} ms by "
          f"{'operations' if d_ops >= d_bytes else 'bytes'} | {smi}")
    print(f"phase ntt path: launches {path}; forward chain == {CHAIN_K} sequential "
          f"ntt_fwd launches == plain; inverse chain returns x")

    # -- 7. w22 transform ---------------------------------------------------------
    w22_path, w22_shape = {}, W22_SHAPES[0]
    for shape in W22_SHAPES:
        wn = shape[-1]
        mods = ntt_w22.find_w22_primes(wn, shape[-2])
        wt_cpu = ntt_w22.build_tables(wn, mods, "cpu")
        wt_dev = ntt_w22.build_tables(wn, mods, dev)
        x_cpu = _operands(rng, shape, mods)
        x = x_cpu.to(dev)
        if shape == w22_shape:
            torch.cuda.synchronize()
            ntt_w22.w22_fwd_launches = ntt_w22.w22_bwd_launches = 0
            rt = ntt_w22.ntt_bwd(ntt_w22.ntt_fwd(x, wt_dev), wt_dev)
            torch.cuda.synchronize()
            w22_path = {"w22_fwd": ntt_w22.w22_fwd_launches,
                        "w22_bwd": ntt_w22.w22_bwd_launches}
            assert w22_path == {"w22_fwd": 1, "w22_bwd": 1}, f"w22 launches {w22_path}"
            assert torch.equal(rt, x), "w22: inverse(forward(x)) != x"
        line = []
        for fwd, d in ((True, "w22_fwd"), (False, "w22_bwd")):
            kern = ntt_w22.ntt_fwd if fwd else ntt_w22.ntt_bwd
            plain = ntt_plain.ntt_fwd_plain if fwd else ntt_plain.ntt_bwd_plain
            got = kern(x, wt_dev)
            torch.cuda.synchronize()
            err = int((got.cpu().long() - plain(x_cpu, wt_cpu).long()).abs().max())
            assert err == 0, f"{d} {shape}: kernel != plain ({err})"
            k_ms = _event_ms(lambda: kern(x, wt_dev))
            dev_ms = _device_ms(lambda: kern(x, wt_dev))
            p_ms = _event_ms(lambda: plain(x, wt_dev))
            entry = stats.setdefault(d, {"max_abs_err": 0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if shape == w22_shape:
                entry.update(ms=k_ms, plain_ms=p_ms, **_bound_entry(
                    [_bound(shape[0] * shape[1], shape[1], wn, 1, int32_ops_per_s)]))
            line.append(f"{d} kernel {k_ms:.4f} ms (device time queued {dev_ms:.4f} ms) "
                        f"plain {p_ms:.4f} ms")
        print(f"phase w22: {list(shape)} " + " | ".join(line) + " | bit-identical")
    print(f"phase w22: launches {w22_path}; inverse(forward(x)) == x")
    assert "jax" not in sys.modules

    launches.update(chain_fwd=path["chain_fwd"], chain_bwd=path["chain_bwd"], **w22_path)
    kernels = []
    for d in ("fwd", "bwd", "chain_fwd", "chain_bwd", "w22_fwd", "w22_bwd"):
        entry = {"name": f"ntt_{d}", "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[d], "launches": launches[d], **stats[d],
                 "library_ms": None}
        assert entry["launches"] > 0 and entry["max_abs_err"] == 0, entry
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The negacyclic NTT on the card: tables, build and wrappers of ``csrc/ntt.cu``.

Counterpart of ``matrix_fhe_tpu/ops/pallas_ntt2.py``: ``find_v2_primes``,
``build_tables``, ``ntt_fwd``/``ntt_bwd`` (its ``_transform``) and
``ntt_chain`` (its ``ntt_chain``, the transform applied k times in one
launch, bit-exact to k sequential calls).  They take int32 [..., L, N]
residues canonical in [0, q) and return the transform in the reference's
bit-reversed order, canonical:

  * a CUDA tensor goes through the hand-written kernel; if the kernel cannot
    be built or launched, the call raises;
  * a CPU tensor goes through the plain torch version (``ops/ntt_plain.py``).

The kernel is compiled by ``nvcc`` for sm_90a into plain C libraries, one
for each N, each at the first use of its N (``library(logn)``; ``build``
builds several at once), into ``matrix_fhe_tpu_torch/_build/`` under names
keyed by a hash of the source and flags, and bound with ctypes.  Nothing is
built or loaded when this module is imported.  Table constructors put their tables on the card
unless asked for another device.

A launch splits each row over a thread-block cluster of C CTAs, as
``geometry`` picks from the rows, N, the step count and the card's SMs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import ntt_plain, tables
from matrix_fhe_tpu_torch.utils import graphs
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import resolve_device

MAX_V2_MODULUS = 1 << 23
# The kernel holds one row of N uint32 in shared memory (<= 132 KB, padded).
MAX_KERNEL_N = 1 << 15
# Rows can be split over clusters of at most 8 CTAs (the portable size)
# from N = 2^10 on (csrc/ntt.cu: kMinClusterLogN); geometry splits them
# from N = 2^13 on.
MAX_CLUSTER = 8
MIN_CLUSTER_N = 1 << 10
MIN_SPLIT_N = 1 << 13

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the counts were last reset: by ntt_fwd, by ntt_bwd,
# by ntt_chain in each direction, and by all four together (a capture
# launches nothing; a graph's replays count in utils/graphs.py replays()).
fwd_launches = 0
bwd_launches = 0
chain_fwd_launches = 0
chain_bwd_launches = 0
launches = 0


def find_v2_primes(n: int, count: int) -> list[int]:
    """NTT-friendly primes < 2^23 for ring degree n (largest first)."""
    out: list[int] = []
    for bits in (23, 22, 21, 20, 19):
        g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
        try:
            while len(out) < count:
                p = (g.next_downstream_prime() if bits == 23
                     else g.next_alternating_prime())
                if p < MAX_V2_MODULUS and p not in out:
                    out.append(p)
        except ValueError:
            continue
        if len(out) >= count:
            return out
    raise ValueError(f"could not find {count} v2 primes for n={n}")


# ---------------------------------------------------------------------------
# Tables.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NTTTables:
    """Per-limb tables, stacked over the limb axis L, on one device.

    The kernel reads the psi-power tables; the plain version reads the
    four-step factors (``fs_*``)."""
    n: int
    rows: int
    cols: int
    moduli: torch.Tensor      # int32 [L]
    psi: torch.Tensor         # int32 [L, N]  psi^brv(k), plain
    psi_shoup: torch.Tensor   # int32 [L, N]  uint32 bits of floor(psi*2^32/q)
    ipsi: torch.Tensor        # int32 [L, N]  psi^-brv(k)
    ipsi_shoup: torch.Tensor  # int32 [L, N]
    ninv: torch.Tensor        # int32 [L]     N^-1 mod q
    ninv_shoup: torch.Tensor  # int32 [L]
    fs_a: torch.Tensor        # f64 [L, R, R]  A, centered
    fs_t: torch.Tensor        # i64 [L, R, C]  T
    fs_bt: torch.Tensor       # f64 [L, C, C]  B^T, centered
    fs_ainv: torch.Tensor     # f64 [L, R, R]  Ainv, centered
    fs_tinv: torch.Tensor     # i64 [L, R, C]  Tinv
    fs_binvt: torch.Tensor    # f64 [L, C, C]  Binv^T, centered

    @property
    def num_limbs(self) -> int:
        return int(self.moduli.shape[0])

    def sliced(self, s: slice) -> "NTTTables":
        """Tables of the limbs in ``s`` (views; contiguous for a step-1 slice)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[s] for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _limb_tables(n: int, q: int) -> dict[str, np.ndarray]:
    psi = tables.root_2n(n, q)
    fwd, bwd = tables.psi_tables(n, q, psi)
    ninv = np.array(pow(n, q - 2, q), dtype=np.int64)
    A, T, B, Ainv, Binv, Tinv = ntt_plain.four_step_factors(n, q, psi)

    def centered(m):
        return np.where(m > q // 2, m - q, m).astype(np.float64)

    return {
        "moduli": np.array(q, dtype=np.int32),
        "psi": fwd.astype(np.int32), "ipsi": bwd.astype(np.int32),
        "ninv": ninv.astype(np.int32),
        # uint32 quotients, handed to the kernel as the bits of int32 words
        "psi_shoup": tables.shoup(fwd, q).view(np.int32),
        "ipsi_shoup": tables.shoup(bwd, q).view(np.int32),
        "ninv_shoup": tables.shoup(ninv, q).view(np.int32),
        "fs_a": centered(A), "fs_t": T, "fs_bt": centered(B.T),
        "fs_ainv": centered(Ainv), "fs_tinv": Tinv, "fs_binvt": centered(Binv.T),
    }


def build_tables(n: int, moduli: list[int], device="cuda") -> NTTTables:
    return stacked_tables(NTTTables, n, moduli, MAX_V2_MODULUS, device)


def stacked_tables(cls, n: int, moduli: list[int], max_modulus: int, device):
    """Tables of class ``cls`` (``NTTTables`` or a subclass) for moduli
    below ``max_modulus``, stacked over the limbs, on ``device``."""
    device = resolve_device(device)
    if n < 16 or n & (n - 1):
        raise ValueError("N must be a power of two >= 16")
    for q in moduli:
        if q >= max_modulus:
            raise ValueError(f"modulus {q} too large: this NTT takes q < {max_modulus}")
    logn = n.bit_length() - 1
    R, C = 1 << (logn // 2), 1 << (logn - logn // 2)
    if C > ntt_plain.MAX_PLAIN_SPLIT:
        raise ValueError(f"N={n} too large for the exact float64 four-step")
    per_limb = [_limb_tables(n, q) for q in moduli]
    stacked = {name: torch.from_numpy(np.stack([t[name] for t in per_limb])).to(device)
               for name in per_limb[0]}
    return cls(n=n, rows=R, cols=C, **stacked)


# ---------------------------------------------------------------------------
# Build and bind.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the NTT kernel cannot be built")


# One library for each N: each holds that size's kernels, one a cluster size.
LOGNS = range(4, MAX_KERNEL_N.bit_length())


def library_path(logn: int, source: Path = SOURCE) -> Path:
    """The library of ``source`` (this module's ``csrc/ntt.cu`` or another
    kernel source built the same way, one library for each N) for
    N = 2^logn, named by a hash of the source and the flags."""
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{logn}-{key.hexdigest()[:16]}.so"


def build(logns=LOGNS, source: Path = SOURCE) -> list[int]:
    """Build the libraries of ``source`` for the sizes ``logns`` (log2 N)
    that are missing; ``build_all`` with one source.  Returns the sizes
    built."""
    return [logn for _, logn in build_all([(source, logn) for logn in logns])]


def build_all(jobs) -> list[tuple[Path, int]]:
    """Build the libraries of the (source, log2 N) pairs ``jobs`` that are
    missing (once per source hash), one ``nvcc`` for each, all started
    together, with ``-DMFHE_NTT_LOGN=<log2 N>``.  The compiler's output,
    ptxas's register and spill report included, is kept beside each library
    as ``<name>.log``.  Returns the pairs built."""
    todo = [(src, logn) for src, logn in jobs if not library_path(logn, src).exists()]
    if not todo:
        return todo
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for src, logn in todo:
            so = library_path(logn, src)
            with open(so.with_suffix(".log"), "w") as log:
                procs[src, logn] = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, f"-DMFHE_NTT_LOGN={logn}",
                     "-o", str(Path(tmp) / so.name), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)
        failed = [job for job, proc in procs.items() if proc.wait() != 0]
        if failed:
            src, logn = failed[0]
            log = library_path(logn, src).with_suffix(".log").read_text()
            raise RuntimeError(f"nvcc failed for {[(s.name, n) for s, n in failed]}:\n{log}")
        for src, logn in todo:
            so = library_path(logn, src)
            os.replace(Path(tmp) / so.name, so)
    return todo


@functools.lru_cache(maxsize=None)
def library(logn: int) -> ctypes.CDLL:
    """The kernel library of N = 2^logn, built (that size alone) at first
    use."""
    if logn not in LOGNS:
        raise NotImplementedError(f"no NTT kernel for N = 2^{logn}")
    build([logn])
    lib = ctypes.CDLL(str(library_path(logn)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt_chain_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mfhe_ntt_chain_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mfhe_ntt_chain_fwd.restype = lib.mfhe_ntt_chain_bwd.restype = i
    return lib


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def ntt_fwd(x: torch.Tensor, tabs: NTTTables) -> torch.Tensor:
    global fwd_launches
    check_input(x, tabs)
    if not x.is_cuda:
        return ntt_plain.ntt_fwd_plain(x, tabs)
    out = launch(x, tabs, fwd=True)
    fwd_launches += graphs.launched(f"{__name__}.ntt_fwd", x, tabs)
    return out


def ntt_bwd(x: torch.Tensor, tabs: NTTTables) -> torch.Tensor:
    global bwd_launches
    check_input(x, tabs)
    if not x.is_cuda:
        return ntt_plain.ntt_bwd_plain(x, tabs)
    out = launch(x, tabs, fwd=False)
    bwd_launches += graphs.launched(f"{__name__}.ntt_bwd", x, tabs)
    return out


def ntt_chain(x: torch.Tensor, tabs: NTTTables, k: int,
              fwd: bool = True) -> torch.Tensor:
    """The forward (``fwd``) or inverse transform applied ``k`` >= 1 times,
    on the card in one launch: each row is loaded once, transformed k times
    in shared memory and stored once.  Equal to k sequential
    ``ntt_fwd``/``ntt_bwd`` calls."""
    global chain_fwd_launches, chain_bwd_launches
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k must be an int >= 1, got {k!r}")
    check_input(x, tabs)
    if not x.is_cuda:
        return ntt_plain.ntt_chain_plain(x, tabs, k, fwd)
    out = launch(x, tabs, fwd, k)
    if fwd:
        chain_fwd_launches += graphs.launched(f"{__name__}.ntt_chain_fwd", x, tabs)
    else:
        chain_bwd_launches += graphs.launched(f"{__name__}.ntt_chain_bwd", x, tabs)
    return out


def check_input(x: torch.Tensor, tabs: NTTTables) -> None:
    """Raise unless ``x`` is int32 [..., L, N] for these tables, on the CPU
    or on a CUDA device."""
    n, L = tabs.n, tabs.num_limbs
    if x.dtype != torch.int32:
        raise TypeError(f"the NTT takes int32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., {L}, {n}]")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")


def geometry(rows: int, n: int, k: int, sms: int) -> int:
    """CTAs a row of N words is split over (the cluster size C) in a launch
    of k transforms of ``rows`` rows on a card of ``sms`` SMs.  The rule
    follows ``tools/ntt_cluster_sweep.py`` on an H100 (``PERF.md``: one
    transform over 6 to 640 rows and a chain over 24 and 240, N = 2^10 to
    2^15):
      * C = 1 below N = 2^13, where one CTA transforms a row about as fast
        as a cluster (within 0.4 us at 6-10 rows, the fastest from 40 rows
        on, and for a chain);
      * C = 8, the largest portable cluster, for a launch of few rows
        (rows * 8 <= 3 * sms: the fastest at 6-40 rows, and for a chain
        over 24 within 3% of it) and for one transform from N = 2^14 on
        (the fastest or within 12% of it at every row count; at 133 rows
        and C = 1 one SM holds two of the 512-thread CTAs, and the launch
        took 1.4-1.5x C = 8's time);
      * otherwise the smallest power of two C <= 8 with rows * C >= sms: a
        launch that covers the card gains little from a split row, which
        pays a pass through distributed shared memory and two cluster
        barriers (a chain over 240 rows: C = 1 the fastest)."""
    if n > MAX_KERNEL_N:
        raise NotImplementedError(
            f"N={n}: the NTT kernel holds a row in shared memory, N <= {MAX_KERNEL_N}")
    if n < MIN_SPLIT_N:
        return 1
    if rows * MAX_CLUSTER <= 3 * sms or (k == 1 and n >= 1 << 14):
        return MAX_CLUSTER
    c = 1
    while c < MAX_CLUSTER and rows * c < sms:
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(x: torch.Tensor, tabs: NTTTables, fwd: bool, k: int = 1,
           cluster: int | None = None) -> torch.Tensor:
    """Launch the kernel (``mfhe_ntt_chain_fwd``/``_bwd``) for k chained
    transforms on a CUDA tensor that passed ``check_input``, each row split
    over ``cluster`` CTAs (by default ``geometry``'s choice).  Counts in
    ``launches``; the caller counts in its own counter."""
    global launches
    n, L = tabs.n, tabs.num_limbs
    if not x.is_contiguous():
        raise ValueError("NTT kernel takes a contiguous tensor")
    rows = x.numel() // n
    dev = x.get_device()
    if cluster is None:
        cluster = geometry(rows, n, k, _sm_count(dev))
    if fwd:
        tabs_used = (tabs.psi, tabs.psi_shoup, tabs.moduli)
    else:
        tabs_used = (tabs.ipsi, tabs.ipsi_shoup, tabs.moduli, tabs.ninv,
                     tabs.ninv_shoup)
    # Device indices (ints), not torch.device objects: the step launches
    # the kernel ~30 times a request and is bound by the host.
    for t in tabs_used:
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(
                f"NTT tables must be contiguous on {x.device}, found {t.device}")
    ptrs = [t.data_ptr() for t in tabs_used]
    if ptrs[0] % 16 or ptrs[1] % 16:
        raise ValueError("NTT twiddle tables must start on 16 bytes (vector loads)")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    logn = n.bit_length() - 1
    entry = library(logn).mfhe_ntt_chain_fwd if fwd else library(logn).mfhe_ntt_chain_bwd
    # The current stream of x's device as a raw handle (what
    # torch.cuda.current_stream(dev).cuda_stream gives, without building a
    # Stream object); the C entry makes dev current for the launch.
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = entry(x.data_ptr(), out.data_ptr(), *ptrs, rows, L, logn, k, cluster, dev, stream)
    if err:
        raise RuntimeError(f"NTT kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        launches += 1
    return out

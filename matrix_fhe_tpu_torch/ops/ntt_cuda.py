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

The kernel is compiled by ``nvcc`` for sm_90a into a plain C library at
first use (``library()``), into ``matrix_fhe_tpu_torch/_build/`` under a name
keyed by a hash of the source and flags, and bound with ctypes.  Nothing is
built or loaded when this module is imported.  Table constructors put their
tables on the card unless asked for another device.
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
from matrix_fhe_tpu_torch.utils import primes as pr
from matrix_fhe_tpu_torch.utils.device import resolve_device

MAX_V2_MODULUS = 1 << 23
# The kernel holds one row of N uint32 in shared memory (<= 128 KB).
MAX_KERNEL_N = 1 << 15

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the counts were last reset: by ntt_fwd, by ntt_bwd,
# by ntt_chain in each direction, and by all four together.
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


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"ntt-{key.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.  The
    compiler's output, ptxas's register and shared-memory report included,
    is kept beside the library as ``<name>.log``."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / so.name
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)],
                capture_output=True, text=True, check=False)
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(out, so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt_chain_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.mfhe_ntt_chain_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.mfhe_ntt_chain_fwd.restype = lib.mfhe_ntt_chain_bwd.restype = i
    return lib


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def ntt_fwd(x: torch.Tensor, tabs: NTTTables) -> torch.Tensor:
    global fwd_launches
    check_input(x, tabs)
    if x.device.type == "cpu":
        return ntt_plain.ntt_fwd_plain(x, tabs)
    out = launch(x, tabs, fwd=True)
    fwd_launches += 1
    return out


def ntt_bwd(x: torch.Tensor, tabs: NTTTables) -> torch.Tensor:
    global bwd_launches
    check_input(x, tabs)
    if x.device.type == "cpu":
        return ntt_plain.ntt_bwd_plain(x, tabs)
    out = launch(x, tabs, fwd=False)
    bwd_launches += 1
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
    if x.device.type == "cpu":
        return ntt_plain.ntt_chain_plain(x, tabs, k, fwd)
    out = launch(x, tabs, fwd, k)
    if fwd:
        chain_fwd_launches += 1
    else:
        chain_bwd_launches += 1
    return out


def check_input(x: torch.Tensor, tabs: NTTTables) -> None:
    """Raise unless ``x`` is int32 [..., L, N] for these tables, on the CPU
    or on a CUDA device."""
    n, L = tabs.n, tabs.num_limbs
    if x.dtype != torch.int32:
        raise TypeError(f"the NTT takes int32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., {L}, {n}]")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NTT for device {x.device}")


def launch(x: torch.Tensor, tabs: NTTTables, fwd: bool, k: int = 1) -> torch.Tensor:
    """Launch the kernel (``mfhe_ntt_chain_fwd``/``_bwd``) for k chained
    transforms on a CUDA tensor that passed ``check_input``.  Counts in
    ``launches``; the caller counts in its own counter."""
    global launches
    n, L = tabs.n, tabs.num_limbs
    if not x.is_contiguous():
        raise ValueError("NTT kernel takes a contiguous tensor")
    if n > MAX_KERNEL_N:
        raise NotImplementedError(
            f"N={n}: the NTT kernel holds a row in shared memory, N <= {MAX_KERNEL_N}")
    if fwd:
        tabs_used = (tabs.psi, tabs.psi_shoup, tabs.moduli)
    else:
        tabs_used = (tabs.ipsi, tabs.ipsi_shoup, tabs.moduli, tabs.ninv,
                     tabs.ninv_shoup)
    for t in tabs_used:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"NTT tables must be contiguous on {x.device}, found {t.device}")
    out = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return out
    lib = library()
    ptrs = [t.data_ptr() for t in tabs_used]
    logn = n.bit_length() - 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        entry = lib.mfhe_ntt_chain_fwd if fwd else lib.mfhe_ntt_chain_bwd
        err = entry(x.data_ptr(), out.data_ptr(), *ptrs, rows, L, logn, k, stream)
    if err:
        raise RuntimeError(f"NTT kernel launch failed: CUDA error {err}")
    launches += 1
    return out

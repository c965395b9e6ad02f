"""The 3N ring's factorized NTT on the card: kernel B5 (``csrc/ntt3n.cu``).

Counterpart of ``matrix_fhe_tpu/ops/ntt_3n.py``'s ``ntt_fwd``/``ntt_bwd``
(XLA u64 Montgomery mod-matmuls, the TPU's MXU form): the transform of a
polynomial of Z_q[X]/(X^N - X^{N/2} + 1) to its evaluations at the
E-sorted primitive 3N-th roots of unity, and back.  A residue is one 64-bit
word held in int64, canonical in [0, q), q < 2^61 (``ops/modmath.py``), and
the transform takes the factorized tables of an ``ops/rings.py:Ring`` of
type MATRIX:

  * a CUDA tensor goes through the hand-written kernel; if the kernel cannot
    be built or launched, or takes no such N, the call raises;
  * a CPU tensor goes through the plain version, ``ops/ntt_3n.py``.

``Ring.ntt``/``intt`` of a 3N ring with R >= 2 call ``ntt_fwd``/``ntt_bwd``.
The kernel takes every R, C at run time, so it is one library for all N
(built by ``ops/ntt_cuda.py``'s helper into ``matrix_fhe_tpu_torch/_build/``
at first use, under the size key 0); nothing is built or loaded when this
module is imported.  A CTA holds one branch's N/2 words twice: N is at most
27648 (``check_size``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matrix_fhe_tpu_torch.ops import ntt_3n, ntt_cuda

SOURCE = ntt_cuda._PKG / "csrc" / "ntt3n.cu"
BUILD_KEY = 0  # the library's size key in ntt_cuda.library_path: one for all N
# the dynamic shared memory a CTA may hold on sm_90
MAX_SMEM_BYTES = 227 * 1024

# Kernel launches since the counts were last reset, by direction.
fwd_launches = 0
bwd_launches = 0


def smem_bytes(n: int) -> int:
    """Shared memory a CTA of the kernel takes at degree N: 2 R C + C words
    (csrc/ntt3n.cu:smem_words)."""
    r, c = ntt_3n.split_rc(n // 2)
    return 8 * (2 * r * c + max(r, c))


def check_size(n: int) -> None:
    """Raise unless the kernel takes degree N (a factorized split, R >= 2,
    whose buffers fit a CTA)."""
    r, _ = ntt_3n.split_rc(n // 2)
    if n % 2 or r < 2:
        raise NotImplementedError(f"N={n}: no factorized 3N split for the kernel")
    if smem_bytes(n) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"N={n}: the 3N NTT kernel holds {smem_bytes(n)} bytes a CTA, more than "
            f"{MAX_SMEM_BYTES}; it takes N <= 27648")


def ntt_fwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the forward transform (any device)."""
    return ntt_3n.ntt_fwd(x, ring.ntt3n, ring.moduli, ring.qinv, ring.bhi)


def ntt_bwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the inverse transform (any device)."""
    return ntt_3n.ntt_bwd(x, ring.ntt3n, ring.moduli, ring.qinv, ring.bhi)


def ntt_fwd(x: torch.Tensor, ring) -> torch.Tensor:
    global fwd_launches
    check_input(x, ring)
    if not x.is_cuda:
        return ntt_fwd_plain(x, ring)
    out = launch(x, ring, fwd=True)
    fwd_launches += 1
    return out


def ntt_bwd(x: torch.Tensor, ring) -> torch.Tensor:
    global bwd_launches
    check_input(x, ring)
    if not x.is_cuda:
        return ntt_bwd_plain(x, ring)
    out = launch(x, ring, fwd=False)
    bwd_launches += 1
    return out


def check_input(x: torch.Tensor, ring) -> None:
    """Raise unless ``ring`` has factorized 3N tables and ``x`` is int64
    [..., L, N] for its L limbs of degree N, on the CPU or on a CUDA device."""
    if ring.ntt3n is None:
        raise ValueError("the factorized 3N NTT takes a 3N ring with R >= 2")
    n, L = ring.n, ring.num_limbs
    if x.dtype != torch.int64:
        raise TypeError(f"the 3N NTT takes int64 words, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., {L}, {n}]")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no 3N NTT for device {x.device}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    ntt_cuda.build([BUILD_KEY], SOURCE)
    lib = ctypes.CDLL(str(ntt_cuda.library_path(BUILD_KEY, SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt3n_fwd.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.mfhe_ntt3n_bwd.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.mfhe_ntt3n_fwd.restype = lib.mfhe_ntt3n_bwd.restype = i
    return lib


def launch(x: torch.Tensor, ring, fwd: bool) -> torch.Tensor:
    """Launch the kernel (``mfhe_ntt3n_fwd``/``_bwd``) on a contiguous CUDA
    tensor that passed ``check_input``.  The caller counts the launch."""
    t = ring.ntt3n
    n, L = ring.n, ring.num_limbs
    check_size(n)
    if not x.is_contiguous():
        raise ValueError("the 3N NTT kernel takes a contiguous tensor")
    rows = x.numel() // n
    dev = x.get_device()
    common = (ring.moduli, ring.qinv, t.z_pow)
    if fwd:
        tabs = common + (t.tw1, t.tw2, t.wr, t.wc, t.twid, t.perm)
    else:
        tabs = common + (t.untw1, t.untw2, t.wci, t.wri, t.twidi, t.inv_diff, t.perm)
    for tab in tabs:
        if tab.get_device() != dev or not tab.is_contiguous() or tab.dtype != torch.int64:
            raise ValueError(f"3N NTT tables must be contiguous int64 on {x.device}, "
                             f"found {tab.dtype} on {tab.device}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = library()
    entry = lib.mfhe_ntt3n_fwd if fwd else lib.mfhe_ntt3n_bwd
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = entry(x.data_ptr(), out.data_ptr(), *(tab.data_ptr() for tab in tabs),
                rows, L, n, t.rows, t.cols, dev, stream)
    if err:
        raise RuntimeError(f"3N NTT kernel launch failed: CUDA error {err}")
    return out

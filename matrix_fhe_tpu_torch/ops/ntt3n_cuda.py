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
The kernel computes each branch's DFT_M as a mixed-radix FFT on the tables
``ntt_3n.build_tables`` makes for it (``kfwd``/``kbwd``/``kidx``), one CTA
holding both branches of a row or, split over a thread-block cluster of C
CTAs, M/C words of each (``geometry`` picks C); it takes every N at run
time, so it is one library for all N (built by ``ops/ntt_cuda.py``'s helper
into ``matrix_fhe_tpu_torch/_build/`` at first use, under the size key 0);
nothing is built or loaded when this module is imported.  A CTA holds at
most 227 KB: N = 27648 fits one CTA, larger N need a cluster
(``check_size``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matrix_fhe_tpu_torch.ops import ntt_3n, ntt_cuda
from matrix_fhe_tpu_torch.utils import graphs

SOURCE = ntt_cuda._PKG / "csrc" / "ntt3n.cu"
BUILD_KEY = 0  # the library's size key in ntt_cuda.library_path: one for all N
# the dynamic shared memory a CTA may hold on sm_90
MAX_SMEM_BYTES = 227 * 1024
CLUSTERS = (1, 2, 4, 8)

# Kernel launches since the counts were last reset, by direction (a capture
# launches nothing; a graph's replays count in utils/graphs.py replays()).
fwd_launches = 0
bwd_launches = 0


def smem_bytes(n: int, cluster: int) -> int:
    """Shared memory a CTA of the kernel takes at degree N split over
    ``cluster`` CTAs: both branches' M/C words, padded by a word every 32
    (csrc/ntt3n.cu:branch_stride)."""
    q_local = n // 2 // cluster
    return 8 * 2 * ((q_local + (q_local >> 5)) | 1)


@functools.lru_cache(maxsize=None)
def clusters(n: int) -> tuple[int, ...]:
    """The cluster sizes the kernel takes at degree N: C divides 2^p
    (M = 2^p 3^b) and a CTA's share fits its shared memory.  Empty if the
    kernel takes no such N."""
    m = n // 2
    if n % 2 or m < 4 or ntt_3n.split_rc(m)[0] < 2:
        return ()
    try:
        p, _ = ntt_3n.radix_counts(m)
    except ValueError:
        return ()
    return tuple(c for c in CLUSTERS if c <= 1 << p and smem_bytes(n, c) <= MAX_SMEM_BYTES)


def check_size(n: int) -> None:
    """Raise unless the kernel takes degree N (M = N/2 = 2^p 3^b with a
    factorized split, and a cluster size whose share fits a CTA)."""
    if not clusters(n):
        raise NotImplementedError(
            f"N={n}: the 3N NTT kernel takes N = 2^a 3^b with N/2 composite whose two "
            f"branches fit the 227 KB a CTA holds over at most {CLUSTERS[-1]} CTAs "
            f"(N/2 = 2^p 3^b split over C | 2^p CTAs)")


# a CTA of a split row keeps at least this many words of each branch
MIN_SPLIT_WORDS = 128


@functools.lru_cache(maxsize=None)
def geometry(rows: int, n: int, sms: int) -> int:
    """CTAs a row of degree N is split over (the cluster size C) in a launch
    of ``rows`` rows on a card of ``sms`` SMs, among ``clusters(n)``: the
    largest C whose CTAs keep >= 128 words of each branch.  The rule
    follows ``tools/ntt_cluster_sweep.py --b5`` on an H100 (PERF.md), which
    timed one to seven rows: C = 8 at N = 12288 (12.0-12.8 us, against
    47.7-54.2 us at C = 1, 2-4x faster than C = 2) and at 24576 and 27648,
    C = 4 at 1152 (the fastest, by 0.2-0.7 us).  ``rows`` and ``sms`` are
    not read yet: a launch of many rows was not timed."""
    cs = clusters(n)
    if not cs:
        check_size(n)
    fit = [c for c in cs if n // 2 // c >= MIN_SPLIT_WORDS]
    return fit[-1] if fit else cs[0]


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
    fwd_launches += graphs.launched(f"{__name__}.ntt_fwd", x, ring)
    return out


def ntt_bwd(x: torch.Tensor, ring) -> torch.Tensor:
    global bwd_launches
    check_input(x, ring)
    if not x.is_cuda:
        return ntt_bwd_plain(x, ring)
    out = launch(x, ring, fwd=False)
    bwd_launches += graphs.launched(f"{__name__}.ntt_bwd", x, ring)
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
    lib.mfhe_ntt3n_fwd.argtypes = lib.mfhe_ntt3n_bwd.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.mfhe_ntt3n_fwd.restype = lib.mfhe_ntt3n_bwd.restype = i
    return lib


def launch(x: torch.Tensor, ring, fwd: bool, cluster: int | None = None) -> torch.Tensor:
    """Launch the kernel (``mfhe_ntt3n_fwd``/``_bwd``) on a contiguous CUDA
    tensor that passed ``check_input``, each row split over ``cluster``
    CTAs (by default ``geometry``'s choice; it must be one of
    ``clusters(N)``).  The caller counts the launch."""
    t = ring.ntt3n
    n = ring.n
    if not x.is_contiguous():
        raise ValueError("the 3N NTT kernel takes a contiguous tensor")
    rows = x.numel() // n
    dev = x.get_device()
    tab, idx = (t.kfwd if fwd else t.kbwd), t.kidx
    if tab.get_device() != dev or idx.get_device() != dev or not tab.is_contiguous():
        raise ValueError(f"3N NTT tables must be contiguous on {x.device}, found {tab.device}")
    if cluster is None:
        cluster = geometry(rows, n, ntt_cuda._sm_count(dev))
    elif cluster not in clusters(n):
        raise ValueError(f"N={n}: no 3N NTT kernel with a cluster of {cluster}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    p, b = ntt_3n.radix_counts(n // 2)
    entry = library().mfhe_ntt3n_fwd if fwd else library().mfhe_ntt3n_bwd
    err = entry(x.data_ptr(), out.data_ptr(), tab.data_ptr(), idx.data_ptr(), rows,
                ring.num_limbs, n, p, b, cluster, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"3N NTT kernel launch failed: CUDA error {err}")
    return out

"""The negacyclic NTT of 64-bit words on the card: kernel B4 (``csrc/ntt64.cu``).

Counterpart of ``matrix_fhe_tpu/ops/wide_ntt.py``'s ``ntt_fwd``/``ntt_bwd``
(its ``_transform``, XLA int8 matmuls over 7 digit planes of the TPU's
centered int32 pairs) and of the u64 ring's NTT of the JAX package: both
compute the same function, the negacyclic NTT mod q of the reference
(ring/ntt.go) with the output in bit-reversed order.  Here a residue is one
64-bit word held in int64, canonical in [0, q), q < 2^61 + 2^55 (the wide
path's range, ``ops/wide.py``; the u64 rings stop at 2^61), and the
transform takes the tables of an
``ops/rings.py:Ring`` (its plain psi powers, each beside its Shoup
quotient, ``psi2`` / ``ipsi2``):

  * a CUDA tensor goes through the hand-written kernel; if the kernel cannot
    be built or launched, the call raises;
  * a CPU tensor goes through the plain version, ``ntt_fwd_plain`` /
    ``ntt_bwd_plain`` (``rings._ntt_standard`` / ``_intt_standard``, the
    torch-op butterfly NTT over the ring's Montgomery tables).

``Ring.ntt``/``intt`` (and so the wide ring's, the keys', the encoder's and
the u64 evaluator's) call ``ntt_fwd``/``ntt_bwd``.

The conjugate-invariant ring's NTT (``ntt_ci_fwd``/``ntt_ci_bwd``) runs on
the same kernel in its CI mode (``mfhe_ntt64_ci_fwd``/``_bwd``), one launch
a call: its butterfly stages are the standard ones over a re-indexed table
of 4N-th roots (``rings._ci_kernel_tables``), and its fold by psi (before
the forward stages, after the inverse ones, with the (2N)^-1 scale) runs
in the kernel's load and store, from the ring's ``fold_row``; on a CPU
tensor the plain version runs (``rings._ntt_ci``/``_intt_ci``, with
``rings.ci_fold`` as torch ops).  The kernel is built by
``ops/ntt_cuda.py``'s helper into ``matrix_fhe_tpu_torch/_build/``, one
library for each N (2^4 to 2^16), each at the first use of its N; nothing
is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matrix_fhe_tpu_torch.ops import ntt_cuda
from matrix_fhe_tpu_torch.utils import graphs

SOURCE = ntt_cuda._PKG / "csrc" / "ntt64.cu"
MIN_N = 1 << 4
MAX_N = 1 << 16
# A CTA holds at most 2^14 words of a row (139 KB padded, csrc/ntt64.cu:
# kMaxLocalLogN): N = 2^15 needs a cluster of 2, N = 2^16 one of 4.  The
# cluster sizes the kernel is built for (16 is a non-portable cluster).
MAX_LOCAL_N = 1 << 14
CLUSTERS = (1, 2, 4, 8, 16)
MIN_CLUSTER_N = 1 << 10
LOGNS = range(MIN_N.bit_length() - 1, MAX_N.bit_length())

# Kernel launches since the counts were last reset, by direction, for the
# standard ring and for the CI ring (a capture launches nothing; a graph's
# replays count in utils/graphs.py replays()).
fwd_launches = 0
bwd_launches = 0
ci_fwd_launches = 0
ci_bwd_launches = 0


def ntt_fwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the forward transform (any device)."""
    from matrix_fhe_tpu_torch.ops.rings import _ntt_standard
    return _ntt_standard(x, ring.roots_fwd, ring.moduli, ring.qinv)


def ntt_bwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the inverse transform (any device)."""
    from matrix_fhe_tpu_torch.ops.rings import _intt_standard
    return _intt_standard(x, ring.roots_bwd, ring.ninv, ring.moduli, ring.qinv)


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


def ntt_ci_fwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the CI ring's forward transform (any device)."""
    from matrix_fhe_tpu_torch.ops.rings import _ntt_ci
    return _ntt_ci(x, ring)


def ntt_ci_bwd_plain(x: torch.Tensor, ring) -> torch.Tensor:
    """The plain version of the CI ring's inverse transform (any device)."""
    from matrix_fhe_tpu_torch.ops.rings import _intt_ci
    return _intt_ci(x, ring)


def ntt_ci_fwd(x: torch.Tensor, ring) -> torch.Tensor:
    """The CI ring's forward NTT: the fold on load, then the stages, in one
    launch."""
    global ci_fwd_launches
    check_input(x, ring, "conjugate_invariant")
    if not x.is_cuda:
        return ntt_ci_fwd_plain(x, ring)
    out = launch(x, ring, fwd=True, ci=True)
    ci_fwd_launches += graphs.launched(f"{__name__}.ntt_ci_fwd", x, ring)
    return out


def ntt_ci_bwd(x: torch.Tensor, ring) -> torch.Tensor:
    """The CI ring's inverse NTT: the stages, then the fold with its
    (2N)^-1 on store, in one launch."""
    global ci_bwd_launches
    check_input(x, ring, "conjugate_invariant")
    if not x.is_cuda:
        return ntt_ci_bwd_plain(x, ring)
    out = launch(x, ring, fwd=False, ci=True)
    ci_bwd_launches += graphs.launched(f"{__name__}.ntt_ci_bwd", x, ring)
    return out


def check_input(x: torch.Tensor, ring, ring_type: str = "standard") -> None:
    """Raise unless ``ring`` is of ``ring_type`` and ``x`` is int64
    [..., L, N] for its L limbs of degree N, on the CPU or on a CUDA device."""
    if ring.ring_type != ring_type:
        raise ValueError(f"a {ring.ring_type} ring in the {ring_type} ring's NTT")
    n, L = ring.n, ring.num_limbs
    if x.dtype != torch.int64:
        raise TypeError(f"the u64 NTT takes int64 words, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., {L}, {n}]")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")


def clusters(n: int) -> list[int]:
    """The cluster sizes the kernel is built for at N = n."""
    return [c for c in CLUSTERS if (c == 1 or n >= MIN_CLUSTER_N) and n // c <= MAX_LOCAL_N]


def geometry(rows: int, n: int, sms: int) -> int:
    """CTAs a row of N words is split over (the cluster size C) in a launch
    of ``rows`` rows on a card of ``sms`` SMs, the rule measured for this
    kernel by ``tools/ntt_cluster_sweep.py --b4`` on the H100 (132 SMs):
      * C = 1 below N = 2^13 (at 2^10, C = 1 is the fastest at 1-42 rows);
      * from N = 2^15 on, C = 16 for a launch of at most sms / 18 rows (1-4
        rows: 18-41% faster than C = 8; 5-7 rows: 14.6-17.1 us against
        24.4-24.9 us at 2^16, 10.0-11.7 us against 11.8-13.6 us at 2^15),
        else C = 8 (8 rows: 24.4-24.9 us against 26.8-30.9 us at C = 16 at
        2^16, 11.8-13.5 us against 17.6-20.2 us at 2^15; 9 and 42 rows: the
        fastest; 126 rows at 2^15: the fastest inverse, 10% behind C = 4
        forward);
      * at N = 2^13 and 2^14, C = 8 up to 3 sms / 8 rows (1-42 rows: the
        fastest or within 1%); beyond, C = 4 at 2^14 (45-190 rows: within
        15% of the fastest, which moves between C = 2, 4 and 8 with the
        rows) and C = 2 at 2^13 (126 rows: the fastest forward, within 1%
        of C = 1 inverse).
    A CTA holds at most 2^14 words, so C >= N / 2^14 in every branch."""
    if n > MAX_N:
        raise NotImplementedError(f"N={n}: the u64 NTT kernel takes N <= {MAX_N}")
    if n < 1 << 13:
        return 1
    if n >= 1 << 15:
        return 16 if rows * 18 <= sms else 8
    if rows * 8 <= 3 * sms:
        return 8
    return 2 if n == 1 << 13 else 4


@functools.lru_cache(maxsize=None)
def library(logn: int) -> ctypes.CDLL:
    """The kernel library of N = 2^logn, built (that size alone) at first use."""
    if logn not in LOGNS:
        raise NotImplementedError(f"no u64 NTT kernel for N = 2^{logn}")
    ntt_cuda.build([logn], SOURCE)
    lib = ctypes.CDLL(str(ntt_cuda.library_path(logn, SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt64_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mfhe_ntt64_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.mfhe_ntt64_ci_fwd.argtypes = lib.mfhe_ntt64_ci_bwd.argtypes = [p] * 5 + [i] * 5 + [p]
    for f in (lib.mfhe_ntt64_fwd, lib.mfhe_ntt64_bwd, lib.mfhe_ntt64_ci_fwd,
              lib.mfhe_ntt64_ci_bwd):
        f.restype = i
    return lib


def launch(x: torch.Tensor, ring, fwd: bool, cluster: int | None = None,
           ci: bool = False) -> torch.Tensor:
    """Launch the kernel (``mfhe_ntt64_fwd``/``_bwd``, or in the CI mode
    ``mfhe_ntt64_ci_fwd``/``_bwd``, the fold inside) on a contiguous CUDA
    tensor that passed ``check_input``, each row split over ``cluster``
    CTAs (by default ``geometry``'s choice).  The caller counts the launch."""
    n, L = ring.n, ring.num_limbs
    if not x.is_contiguous():
        raise ValueError("the u64 NTT kernel takes a contiguous tensor")
    rows = x.numel() // n
    dev = x.get_device()
    if cluster is None:
        cluster = geometry(rows, n, ntt_cuda._sm_count(dev))
    if ci:
        tabs = (ring.psi2 if fwd else ring.ipsi2, ring.moduli, ring.fold_row)
    elif fwd:
        tabs = (ring.psi2, ring.moduli)
    else:
        tabs = (ring.ipsi2, ring.moduli, ring.ninv_plain, ring.ninv_shoup)
    for t in tabs:
        if t.get_device() != dev or not t.is_contiguous() or t.dtype != torch.int64:
            raise ValueError(f"u64 NTT tables must be contiguous int64 on {x.device}, "
                             f"found {t.dtype} on {t.device}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    logn = n.bit_length() - 1
    lib = library(logn)
    if ci:
        entry = lib.mfhe_ntt64_ci_fwd if fwd else lib.mfhe_ntt64_ci_bwd
    else:
        entry = lib.mfhe_ntt64_fwd if fwd else lib.mfhe_ntt64_bwd
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = entry(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
                rows, L, logn, cluster, dev, stream)
    if err:
        raise RuntimeError(f"u64 NTT kernel launch failed: CUDA error {err}")
    return out

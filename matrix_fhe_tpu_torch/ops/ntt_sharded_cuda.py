"""The local step of the coefficient-sharded NTT on the card: kernel B6
(``csrc/ntt_sharded.cu``).

Counterpart of the shard-local body of
``matrix_fhe_tpu/parallel/ntt_sharded.py:ntt_sharded`` (XLA u64 Montgomery
mod-matmuls, not a Pallas kernel): for a rank's column block x
[.., L, R, c] starting at column ``col0`` of the [R, C] view, the partial
product ((A @ x) .* T_blk) @ BT_rows mod q, [.., L, R, C], canonical.

  * a CUDA tensor goes through the hand-written kernel; if the kernel cannot
    be built or launched, the call raises;
  * a CPU tensor goes through the plain version, ``local_step_plain``
    (torch ops over ``ops/modmath.py``).

The four-step tables (``ShardedNTTTables``, ``build_tables``) hold the JAX
package's words: MForm(A), MForm(B^T), MForm(T), q^-1 mod 2^64 and the
Barrett constant's high word, uint64 bits in int64.

The kernel is built by ``ops/ntt_cuda.py``'s helper (``nvcc`` for sm_90a,
one library for every N) into ``matrix_fhe_tpu_torch/_build/`` at first
use; nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import ntt_cuda, tables
from matrix_fhe_tpu_torch.utils import graphs
from matrix_fhe_tpu_torch.utils.device import resolve_device

SOURCE = ntt_cuda._PKG / "csrc" / "ntt_sharded.cu"
BUILD_KEY = 0  # the library's size key in ntt_cuda.library_path: one for all N
MAX_COLS = 512  # csrc/ntt_sharded.cu: kMaxCols (N <= 2^18)
# csrc/ntt_sharded.cu: the tiled kernel's CTA sizes, the terms a 128-bit sum
# holds between reductions (kChunk) and the words of a copy stage
# (kStageWords; a ring of two)
THREADS = (128, 256)
CHUNK = 64
STAGE_WORDS = 2048

# Kernel launches since the count was last reset (a capture launches nothing).
launches = 0


@dataclasses.dataclass(frozen=True)
class ShardedNTTTables:
    """Four-step tables in Montgomery form, 64-bit words in int64."""
    n: int
    rows: int
    cols: int
    a_mat: torch.Tensor   # [L, R, R]  MForm(A)
    bt_mat: torch.Tensor  # [L, C, C]  MForm(B^T)
    tw: torch.Tensor      # [L, R, C]  MForm(T)
    moduli: torch.Tensor  # [L]
    qinv: torch.Tensor    # [L]  q^-1 mod 2^64
    bhi: torch.Tensor     # [L]  floor(2^128 / q) >> 64

    @property
    def device(self) -> torch.device:
        return self.moduli.device


def build_tables(n: int, moduli: list[int], device="cuda") -> ShardedNTTTables:
    """The tables of ``matrix_fhe_tpu/parallel/ntt_sharded.py:build_tables``
    (same words), on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    if n < 4 or n & (n - 1):
        raise ValueError("N must be a power of two >= 4")
    logn = n.bit_length() - 1
    a_bits = logn // 2
    b_bits = logn - a_bits
    R, C = 1 << a_bits, 1 << b_bits
    e_hi = 2 * np.array([tables.bit_reverse(i, a_bits) for i in range(R)], dtype=np.int64) + 1
    brv_lo = np.array([tables.bit_reverse(i, b_bits) for i in range(C)], dtype=np.int64)
    jr, jc = np.arange(R, dtype=np.int64), np.arange(C, dtype=np.int64)
    # each table entry is psi^e for an exponent e mod 2N
    exps = {"a": (C * e_hi[:, None] * jr[None, :]) % (2 * n),
            "tw": (e_hi[:, None] * jc[None, :]) % (2 * n),
            "bt": (2 * R * brv_lo[None, :] * jc[:, None]) % (2 * n)}
    per = {k: [] for k in exps}
    for q in moduli:
        mm.check_modulus(q)
        pows = tables.psi_powers(n, q, tables.root_2n(n, q))
        mform = np.array([(int(v) << 64) % q for v in pows], dtype=np.int64)
        for k, e in exps.items():
            per[k].append(mform[e])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def consts(values):
        return put(np.array([mm.signed(v) for v in values], dtype=np.int64))

    return ShardedNTTTables(
        n=n, rows=R, cols=C, a_mat=put(np.stack(per["a"])), bt_mat=put(np.stack(per["bt"])),
        tw=put(np.stack(per["tw"])), moduli=consts(moduli),
        qinv=consts([mm.gen_mred_constant(q) for q in moduli]),
        bhi=consts([mm.gen_bred_constant(q)[0] for q in moduli]))


def _mod_matmul(mat: torch.Tensor, x: torch.Tensor, q, qinv, bhi) -> torch.Tensor:
    """out[.., L, i, j] = sum_m mat[.., L, i, m] * x[.., L, m, j] * 2^-64 mod
    q: a Montgomery product a term, canonical, summed mod q."""
    prod = mm.mred(mat[..., :, :, :, None], x[..., :, None, :, :], q[:, None, None, None],
                   qinv[:, None, None, None])
    return mm.modsum(prod, q[:, None, None], bhi[:, None, None], dim=-2)


def local_step_plain(x: torch.Tensor, tabs: ShardedNTTTables, col0: int) -> torch.Tensor:
    """The plain version of B6 (any device): the partial ((A @ x) .* T_blk) @ BT_rows mod
    q of the column block x [.., L, R, c] that starts at column ``col0``,
    [.., L, R, C], canonical (``_mod_matmul_left``, ``mred`` and
    ``_partial_matmul_right`` of the JAX module)."""
    c = x.shape[-1]
    q, qinv, bhi = tabs.moduli, tabs.qinv, tabs.bhi
    y = _mod_matmul(tabs.a_mat, x, q, qinv, bhi)
    w = mm.mred(y, tabs.tw[:, :, col0:col0 + c], q[:, None, None], qinv[:, None, None])
    return _mod_matmul(w, tabs.bt_mat[:, col0:col0 + c, :], q, qinv, bhi)


def local_step(x: torch.Tensor, tabs, col0: int) -> torch.Tensor:
    global launches
    check_input(x, tabs, col0)
    if not x.is_cuda:
        return local_step_plain(x, tabs, col0)
    out = launch(x.contiguous(), tabs, col0)
    launches += graphs.launched(f"{__name__}.local_step", x, tabs)
    return out


def check_input(x: torch.Tensor, tabs, col0: int) -> None:
    """Raise unless x is int64 [.., L, R, c] for the tables' L limbs and R
    rows, c dividing C, col0 a multiple of c inside C, on the tables'
    device (the CPU or a CUDA device)."""
    L, R, C = int(tabs.moduli.shape[0]), tabs.rows, tabs.cols
    if x.dtype != torch.int64:
        raise TypeError(f"the sharded NTT takes int64 words, got {x.dtype}")
    if x.dim() < 3 or x.shape[-3] != L or x.shape[-2] != R:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., {L}, {R}, c]")
    c = x.shape[-1]
    if c == 0 or C % c or col0 % c or not 0 <= col0 < C:
        raise ValueError(f"a block of {c} columns at column {col0} of {C}")
    if x.device != tabs.device:
        raise ValueError(f"block on {x.device}, tables on {tabs.device}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no sharded NTT for device {x.device}")


def geometry(rows: int, cols: int, c: int, threads: int | None = None, ti: int | None = None,
             cn: int | None = None) -> tuple[int, ...]:
    """(threads, ti, cn, kc1, s1, kc2), the tiled kernel's geometry for a
    block of c >= 2 columns of the [rows, cols] view
    (``mfhe_ntt_sharded_local`` states the limits).  ``threads``, ti and cn
    (the CTA size, its output rows and a thread's tile of 2 x cn outputs)
    are the rule's unless given, the fastest or within 6% of it at every
    block ``tools/ntt_sharded_ab.py --sweep`` timed (N = 2^10, 2^12, 2^14,
    2^16; k = 8, 2, 1): up to cols = 128, 128 threads, 2 x 2 tiles and 4
    rows (640 CTAs at phase 26's [2, 10] blocks, ~5 a SM); from 256 on,
    256 threads, 2 x 4 tiles where c allows and every thread one tile of
    step 2 (ti x cols = 2 cn threads).  The rest follows: kc1, the rows of
    the block a stage, as many as a stage holds (A's rows stay in shared
    memory whole); s1, the threads that share a step-1 tile, as many as the
    threads and kc1 allow; kc1 / s1 <= CHUNK terms a slice; kc2, the rows
    of B^T a stage, at most CHUNK."""
    wide = cols >= 256
    if cn is None:
        cn = 4 if wide and c % 4 == 0 else 2
    if threads is None:
        threads = THREADS[1] if wide else THREADS[0]
    if ti is None:
        ti = min(rows, 2 * cn * threads // cols, 4 if cols <= 128 else rows)
    kc1 = 1
    while 2 * kc1 <= rows and 2 * kc1 * c <= STAGE_WORDS:
        kc1 *= 2
    tiles1, s1 = (ti // 2) * max(1, c // cn), 1
    while 2 * s1 * tiles1 <= threads and 2 * s1 <= kc1:
        s1 *= 2
    while kc1 > CHUNK * s1:
        kc1 //= 2
    kc2 = 1
    while 2 * kc2 <= min(c, CHUNK) and 2 * kc2 * cols <= STAGE_WORDS:
        kc2 *= 2
    return threads, ti, cn, kc1, s1, kc2


def candidates(rows: int, cols: int, c: int) -> list[tuple[int, int, int]]:
    """Every (threads, ti, cn) the tiled kernel takes for a block of c
    columns of [rows, cols]: ti a power of two from 2 to rows with
    ti x cols <= 2 cn threads (below, threads idle in step 2), cn dividing
    c."""
    return [(t, 1 << e, cn) for cn in (2, 4) if c % cn == 0 for t in THREADS
            for e in range(1, rows.bit_length()) if (1 << e) * cols <= 2 * cn * t]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    ntt_cuda.build([BUILD_KEY], SOURCE)
    lib = ctypes.CDLL(str(ntt_cuda.library_path(BUILD_KEY, SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfhe_ntt_sharded_local.argtypes = [p] * 8 + [i] * 13 + [p]
    lib.mfhe_ntt_sharded_local.restype = i
    return lib


def launch(x: torch.Tensor, tabs, col0: int, geom: tuple[int, ...] | None = None) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor that passed
    ``check_input``, at ``geometry``'s rule, or with the (threads, ti, cn)
    of ``geom``.  The caller counts the launch."""
    L, R, C = int(tabs.moduli.shape[0]), tabs.rows, tabs.cols
    if C > MAX_COLS:
        raise NotImplementedError(f"N={tabs.n}: the sharded NTT kernel takes C <= {MAX_COLS}")
    if not x.is_contiguous():
        raise ValueError("the sharded NTT kernel takes a contiguous tensor")
    ts = (tabs.a_mat, tabs.tw, tabs.bt_mat, tabs.moduli, tabs.qinv, tabs.bhi)
    for t in ts:
        if not t.is_contiguous() or t.dtype != torch.int64:
            raise ValueError("the sharded NTT tables must be contiguous int64")
    lead = x.numel() // (L * R * x.shape[-1])
    out = x.new_empty(x.shape[:-1] + (C,))
    if lead == 0:
        return out
    dev = x.get_device()
    err = library().mfhe_ntt_sharded_local(
        x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ts), lead, L, R, C,
        x.shape[-1], col0, *geometry(R, C, x.shape[-1], *(geom or ())), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"sharded NTT kernel launch failed: CUDA error {err}")
    return out

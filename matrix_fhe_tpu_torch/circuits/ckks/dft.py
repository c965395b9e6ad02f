"""Homomorphic DFT: CoeffsToSlots / SlotsToCoeffs.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/dft.py`` (the reference's
circuits/ckks/dft/dft.go): the encoding matrix
(special IFFT) and decoding matrix (special FFT) are factorized into
``sum(levels)`` sparse layers, each a diagonal linear transformation with 3
non-zero diagonals (or more after merging), evaluated sequentially with a
rescale after each (dft.go:645-775 GenMatrices, :236-343 CoeffsToSlots /
SlotsToCoeffs).

Host-side matrix generation in float64/complex128 (PREC64 mode).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np

from matrix_fhe_tpu_torch.circuits import lintrans as lt
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.utils.fp import cmul

HOMOMORPHIC_ENCODE = "encode"   # CoeffsToSlots (IDFT)
HOMOMORPHIC_DECODE = "decode"   # SlotsToCoeffs (DFT)

STANDARD = "standard"
SPLIT_REAL_AND_IMAG = "split"
REPACK_IMAG_AS_REAL = "repack"


@dataclasses.dataclass
class MatrixLiteral:
    """dft.go:58-89 MatrixLiteral (PREC64: one modulus per matrix)."""
    type: str
    log_slots: int
    level_q: int
    level_p: int
    levels: list[int]           # factorization depths, one per consumed level
    format: str = STANDARD
    scaling: float | None = None
    log_bsgs_ratio: int = 0

    @property
    def depth(self) -> int:
        return sum(self.levels)


@dataclasses.dataclass
class Matrix:
    literal: MatrixLiteral
    matrices: list[lt.LinearTransformation]


# ---------------------------------------------------------------------------
# Plain FFT layer vectors (dft.go:365-489 fftPlainVec / ifftPlainVec).
# ---------------------------------------------------------------------------

def _fft_plain_vec(log_l: int, dslots: int, encode: bool):
    n = 1 << log_l
    m4 = n << 2
    roots = np.exp(2j * np.pi * np.arange(m4 + 1) / m4)
    pow5 = np.empty(2 * n + 1, dtype=np.int64)
    pow5[0] = 1
    for i in range(1, 2 * n + 1):
        pow5[i] = (pow5[i - 1] * 5) & (m4 - 1)

    size = 2 if 2 * n == dslots else 1
    a_l, b_l, c_l = [], [], []
    ms = [n >> i for i in range(log_l)] if encode else [2 << i for i in range(log_l)]
    for m in ms:
        am = np.zeros(dslots, dtype=np.complex128)
        bm = np.zeros(dslots, dtype=np.complex128)
        cm = np.zeros(dslots, dtype=np.complex128)
        tt = m >> 1
        gap = n // m
        mask = (m << 2) - 1
        for i in range(0, n, m):
            for j in range(m >> 1):
                if encode:
                    k = ((m << 2) - (pow5[j] & mask)) * gap
                else:
                    k = (pow5[j] & mask) * gap
                idx1, idx2 = i + j, i + j + tt
                for u in range(size):
                    am[idx1 + u * n] = 1
                    am[idx2 + u * n] = -roots[k]
                    if encode:
                        bm[idx1 + u * n] = 1
                        cm[idx2 + u * n] = roots[k]
                    else:
                        bm[idx1 + u * n] = roots[k]
                        cm[idx2 + u * n] = 1
        a_l.append(am)
        b_l.append(bm)
        c_l.append(cm)
    return a_l, b_l, c_l


def _add_diag(diags: dict, index: int, vec: np.ndarray) -> None:
    if index in diags:
        diags[index] = diags[index] + vec
    else:
        diags[index] = vec.copy()


def _gen_fft_diag_matrix(log_l, fft_level, a, b, c, encode: bool) -> dict:
    rot = 1 << (fft_level - 1) if encode else 1 << (log_l - fft_level)
    diags: dict[int, np.ndarray] = {}
    _add_diag(diags, 0, a)
    _add_diag(diags, rot, b)
    _add_diag(diags, (1 << log_l) - rot, c)
    return diags


def _gen_repack_matrix(log_l: int) -> dict:
    """dft.go:genRepackMatrix: [I | iI ; iI | I] repacking."""
    n = 1 << log_l
    a = np.concatenate([np.ones(n), 1j * np.ones(n)])
    b = np.concatenate([1j * np.ones(n), np.ones(n)])
    diags: dict[int, np.ndarray] = {}
    _add_diag(diags, 0, a)
    _add_diag(diags, n, b)
    return diags


def _merge_next_level(diags: dict, log_l, n_mod, next_level, a, b, c,
                      encode: bool) -> dict:
    rot = (1 << (next_level - 1)) & (n_mod - 1) if encode \
        else (1 << (log_l - next_level)) & (n_mod - 1)
    out: dict[int, np.ndarray] = {}
    mask = len(a) - 1
    for i, v in diags.items():
        idx = np.arange(len(v))
        _add_diag(out, i, cmul(a, v[(idx + 0) & mask]))
        _add_diag(out, (i + rot) & (n_mod - 1), cmul(b, v[(idx + rot) & mask]))
        _add_diag(out, (i - rot) & (n_mod - 1), cmul(c, v[(idx - rot) & mask]))
    return out


def gen_matrices(lit: MatrixLiteral, log_n: int) -> list[dict]:
    """GenMatrices (dft.go:645-775): the ordered diagonal factors."""
    log_slots = lit.log_slots
    slots = 1 << log_slots
    max_depth = lit.depth
    encode = lit.type == HOMOMORPHIC_ENCODE
    repack = lit.format == REPACK_IMAG_AS_REAL

    log_dslots = log_slots
    if log_dslots < log_n - 1 and repack:
        log_dslots += 1
    dslots = 1 << log_dslots

    a, b, c = _fft_plain_vec(log_slots, dslots, encode)

    merge = [0] * max_depth
    fft_level = log_slots
    for i in range(max_depth):
        depth = -(-fft_level // (max_depth - i))
        if encode:
            merge[i] = depth
        else:
            merge[max_depth - i - 1] = depth
        fft_level -= depth

    out = []
    fft_level = log_slots
    for i in range(max_depth):
        if log_slots != log_dslots and not encode and i == 0 and repack:
            diags = _gen_repack_matrix(log_slots)
            diags = _merge_next_level(diags, log_slots, 2 * slots, fft_level,
                                      a[log_slots - fft_level],
                                      b[log_slots - fft_level],
                                      c[log_slots - fft_level], encode)
            next_level = fft_level - 1
            for _ in range(merge[i] - 1):
                diags = _merge_next_level(diags, log_slots, 2 * slots, next_level,
                                          a[log_slots - next_level],
                                          b[log_slots - next_level],
                                          c[log_slots - next_level], encode)
                next_level -= 1
        else:
            diags = _gen_fft_diag_matrix(log_slots, fft_level,
                                         a[log_slots - fft_level],
                                         b[log_slots - fft_level],
                                         c[log_slots - fft_level], encode)
            next_level = fft_level - 1
            for _ in range(merge[i] - 1):
                diags = _merge_next_level(diags, log_slots, slots, next_level,
                                          a[log_slots - next_level],
                                          b[log_slots - next_level],
                                          c[log_slots - next_level], encode)
                next_level -= 1
        out.append(diags)
        fft_level -= merge[i]

    # Repacking after the IDFT: zero the top slots copy.
    if log_slots != log_dslots and encode and repack:
        for k in list(out[-1].keys()):
            v = out[-1][k]
            v[slots:2 * slots] = 0

    scaling = 1.0 if lit.scaling is None else float(lit.scaling)
    if encode:
        if lit.format in (REPACK_IMAG_AS_REAL, SPLIT_REAL_AND_IMAG):
            scaling /= 2 * slots
        else:
            scaling /= slots
    scaling = scaling ** (1.0 / max_depth)
    for diags in out:
        for k in diags:
            diags[k] = diags[k] * scaling
    return out


# ---------------------------------------------------------------------------
# Matrix encoding + Galois elements.
# ---------------------------------------------------------------------------

def new_matrix_from_literal(params, lit: MatrixLiteral, encoder) -> Matrix:
    """NewMatrixFromLiteral (dft.go:159-217): ``levels[i]`` matrices share
    the i-th rescaling prime — each is encoded at scale q^{1/levels[i]}
    (dft.go:183-188) so the group's accumulated scale is one prime, and
    evaluation rescales once per GROUP.  The fractional scale is carried
    as a high-precision Fraction (2^-96 relative error), so the exact
    scale bookkeeping absorbs the k-th-root approximation consistently
    (encode and decode use the same value); with levels[i] == 1 this
    degenerates to the one-modulus-per-matrix PREC64 form.
    """
    log_dslots = lit.log_slots
    if log_dslots < params.log_n - 1 and lit.format == REPACK_IMAG_AS_REAL:
        log_dslots += 1

    diag_factors = gen_matrices(lit, params.log_n)
    max_slots = params.max_slots

    def embed(values, level_q, level_p, scale):
        v = np.asarray(values)
        if len(v) < max_slots:
            v = np.tile(v, max_slots // len(v))
        return encoder.embed_qp(v, level_q, level_p, scale)

    # per-factor scales: group i (lit.levels[i] factors) shares prime
    # q[level - i]; k > 1 factors get the k-th root of that prime
    scales = []
    level = lit.level_q
    for k in lit.levels:
        q = params.q[level]
        if k == 1:
            scales.append(Fraction(q))
        else:
            import decimal
            with decimal.localcontext() as dctx:
                dctx.prec = 60
                root = decimal.Decimal(q) ** (decimal.Decimal(1) / k)
                num = int((root * (1 << 96)).to_integral_value())
            scales.extend([Fraction(num, 1 << 96)] * k)
        level -= 1

    matrices = []
    for diags, scale in zip(diag_factors, scales):
        ltp = lt.LinearTransformationParameters(
            diagonals_index_list=list(diags.keys()), level_q=lit.level_q,
            level_p=lit.level_p, scale=scale,
            log_dimensions=(0, log_dslots),
            log_bsgs_ratio=lit.log_bsgs_ratio)
        matrices.append(lt.encode(embed, diags, ltp))
    return Matrix(literal=lit, matrices=matrices)


def galois_elements(params, lit: MatrixLiteral) -> list[int]:
    """dft.go:103-127 GaloisElements."""
    els = set()
    log_dslots = lit.log_slots
    if log_dslots < params.log_n - 1 and lit.format == REPACK_IMAG_AS_REAL:
        log_dslots += 1
        if lit.type == HOMOMORPHIC_ENCODE:
            els.add(params.galois_element(1 << lit.log_slots))
    for diags in gen_matrices(lit, params.log_n):
        els.update(lt.galois_elements(params, list(diags.keys()),
                                      1 << log_dslots, lit.log_bsgs_ratio))
    els.add(params.galois_element_inverse())  # conjugation in CoeffsToSlots
    els.discard(1)
    return sorted(els)


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------

def _dft(params, ev, ct: Ciphertext, matrices: list[lt.LinearTransformation],
         gks, levels: list[int] | None = None) -> Ciphertext:
    """EvaluateSequential (dft.go:345-363): rescale once per LEVEL GROUP
    (``levels[i]`` consecutive factors share one prime; default: one
    factor per group).  Routed through ``ev.evaluate_lintrans`` so
    backend-specific evaluators (the int32/wide fast paths) substitute
    their own matvec."""
    if levels is None:
        levels = [1] * len(matrices)
    out = ct
    idx = 0
    for k in levels:
        for _ in range(k):
            out = ev.evaluate_lintrans(out, matrices[idx], gks)
            idx += 1
        out = ev.rescale(out)
    return out


def coeffs_to_slots(params, ev, ct: Ciphertext, matrix: Matrix, gks):
    """CoeffsToSlots (dft.go:236-318): homomorphic encoding.

    Returns (ct_real, ct_imag); ct_imag is None for sparse packing
    (the imaginary part is repacked into the right slots of ct_real)."""
    lit = matrix.literal
    if lit.format in (SPLIT_REAL_AND_IMAG, REPACK_IMAG_AS_REAL):
        zv = _dft(params, ev, ct, matrix.matrices, gks,
                  lit.levels)
        ct_real = ev.conjugate(zv)
        ct_imag = ev.mul_const_complex(ev.sub(zv, ct_real), -1j, scale=Fraction(1))
        ct_real = ev.add(ct_real, zv)
        if lit.format == REPACK_IMAG_AS_REAL and lit.log_slots < params.log_n - 1:
            ct_imag = ev.rotate(ct_imag, 1 << lit.log_slots)
            return ev.add(ct_real, ct_imag), None
        return ct_real, ct_imag
    return _dft(params, ev, ct, matrix.matrices, gks,
                lit.levels), None


def slots_to_coeffs(params, ev, ct_real: Ciphertext,
                    ct_imag: Ciphertext | None, matrix: Matrix, gks) -> Ciphertext:
    """SlotsToCoeffs (dft.go:320-343): homomorphic decoding."""
    if ct_imag is not None:
        ct = ev.add(ev.mul_const_complex(ct_imag, 1j, scale=Fraction(1)), ct_real)
    else:
        ct = ct_real
    return _dft(params, ev, ct, matrix.matrices, gks,
                matrix.literal.levels)

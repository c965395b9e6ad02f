"""BGV / BFV scheme over Z_T.

Counterpart of ``matrix_fhe_tpu/schemes/bgv/scheme.py`` (the reference's
schemes/bgv):

  * Parameters (params.go:40-130): RLWE parameters + plaintext modulus T,
    the plaintext ring R_T, and the extended basis QMul (ceil((|Q|+logN)/61)
    61-bit downstream primes) for BFV tensoring;
  * Encoder (encoder.go): slots -> R_T via the 5^k permutation
    (permuteMatrix :98-122) + INTT_T; R_T -> R_Q spread with gap and the
    T^{-1} mod Q factor (KPZ-style full-RNS BGV, RingT2Q :357-388); decode by
    a centered exact Q -> T conversion (RingQ2T :391-440);
  * Evaluator (evaluator.go): add/sub with mod-T scale matching
    (matchScalesBinary :1620-1659), the BGV tensor with the T * 2^128
    Montgomery factor (tensorStandard :665-720), BGV rescale =
    DivRoundByLastModulusNTT with scale /= q_l mod T (:1415-1444); BFV = the
    scale-invariant tensor over (Q, QMul) with floor(T/Q *) quantization
    (tensorScaleInvariant :975-1124).

The mod-T "scale" is a Python int in MetaData.scale (exact, like the
reference's Scale mod T, core/rlwe/scale.go).  Every polynomial lives on
the parameters' device: the encoder's spread and its R_T transforms (kernel
B4 at degree n_t on the card) included; the per-limb scalars are built once
per (moduli, value) and kept there.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch import rlwe
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rings as rg
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.ops.tables import bit_reverse
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData, Plaintext
from matrix_fhe_tpu_torch.rlwe.keys import GaloisKey, RelinearizationKey
from matrix_fhe_tpu_torch.utils import primes as pr


@functools.lru_cache(maxsize=4096)
def mform_scalars(moduli: tuple[int, ...], c: int, device: torch.device,
                  factor: int = 1 << 64) -> torch.Tensor:
    """(c mod q) * factor mod q per limb (MForm(c) by default), on ``device``."""
    return torch.tensor([(c % q) * factor % q for q in moduli], dtype=torch.int64,
                        device=device)


@dataclasses.dataclass(frozen=True)
class BGVParametersLiteral:
    logn: int
    t: int                       # plaintext modulus (prime, = 1 mod 2N for SIMD)
    logq: tuple[int, ...] | None = None
    logp: tuple[int, ...] | None = None
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    xe: object = rlwe.params.DEFAULT_XE
    xs: object = rlwe.params.DEFAULT_XS


class BGVParameters(rlwe.Parameters):
    def __init__(self, lit: BGVParametersLiteral, device="cuda"):
        base = rlwe.new_parameters(rlwe.ParametersLiteral(
            logn=lit.logn, q=lit.q, p=lit.p, logq=lit.logq, logp=lit.logp,
            xe=lit.xe, xs=lit.xs, ring_type=rg.STANDARD, ntt_flag=True), device)
        self.__dict__.update(base.__dict__)
        self.t = lit.t
        # Largest power-of-two cyclotomic order enabled by T
        # (params.go:111-123): T = 1 mod 2N gives the full N slots; smaller
        # orders give a degree-(order/2) plaintext ring whose coefficients
        # spread into R_Q with gap N/(order/2) (encoder.go RingT2Q).
        order = 1 << self.t.bit_length()
        while order and (self.t & (order - 1)) != 1:
            order >>= 1
        self.n_t = min(self.n, order >> 1)
        if self.n_t < 16:
            raise ValueError(
                f"plaintext modulus {self.t} has cyclotomic order {order} "
                f"< 32: the ring backend needs a plaintext ring degree of "
                f"at least 16 (the reference's floor is 8)")
        self.ring_t = rg.new_ring(self.n_t, [lit.t], rg.STANDARD, self.device)
        # Extended tensoring basis QMul (params.go:98-106): 61-bit primes
        # taken downstream, so below 2^61, the limit of the port's words.
        nb = math.ceil((self.big_q().bit_length() + lit.logn) / 61.0)
        qmul = pr.NTTFriendlyPrimesGenerator(61, self.nth_root).next_downstream_primes(nb)
        for q in qmul:
            mm.check_modulus(q)
        self.ring_qmul = rg.new_ring(self.n, qmul, rg.STANDARD, self.device)
        self._qmul_bext: dict[int, tuple] = {}
        self._q2t: dict[int, rt.ModUpConstants] = {}

    def qmul_tools(self, level: int):
        """(ModUp Q->QMul consts, ModDown QP->P consts, ModUp QMul->Q consts)."""
        if level not in self._qmul_bext:
            Q = self.q[: level + 1]
            QM = list(self.ring_qmul.moduli_tuple)
            self._qmul_bext[level] = (
                rt.gen_modup_constants(Q, QM, self.device),
                rt.gen_moddown_constants(QM, Q, self.device),   # ModDownQPtoP (floor /Q)
                rt.gen_modup_constants(QM, Q, self.device),
            )
        return self._qmul_bext[level]

    def q_to_t(self, level: int) -> rt.ModUpConstants:
        """ModUp constants Q[:level+1] -> [T] (the decoder's RingQ2T)."""
        if level not in self._q2t:
            self._q2t[level] = rt.gen_modup_constants(self.q[: level + 1], [self.t], self.device)
        return self._q2t[level]


def new_parameters(lit: BGVParametersLiteral, device="cuda") -> BGVParameters:
    """Parameters of a literal, with the rings on ``device`` (the card
    unless told otherwise)."""
    return BGVParameters(lit, device)


def _permute_matrix(logn: int) -> np.ndarray:
    """permuteMatrix (encoder.go:98-122): slot i -> NTT-coefficient index."""
    n = 1 << logn
    mask = 2 * n - 1
    perm = np.zeros(n, dtype=np.int64)
    pow_ = 1
    halfn = n >> 1
    for i in range(halfn):
        pos = bit_reverse(pow_ >> 1, logn)
        perm[i] = pos
        perm[i + halfn] = n - pos - 1
        pow_ = (pow_ * 5) & mask
    return perm


class Encoder:
    def __init__(self, params: BGVParameters):
        self.params = params
        self.perm = _permute_matrix(params.n_t.bit_length() - 1)
        self._perm_dev = torch.from_numpy(self.perm).to(params.device)
        self.t = params.t

    def encode_ring_t(self, values, scale: int = 1) -> torch.Tensor:
        """EncodeRingT (:241-246): the slots permuted, INTT over R_T, times
        scale mod T: [1, n_t] on the device."""
        params, t = self.params, self.t
        arr = np.asarray(values)
        if len(arr) > params.n_t:
            raise ValueError(f"{len(arr)} values > {params.n_t} slots "
                             f"(plaintext ring degree for T={t})")
        vals = np.zeros(params.n_t, dtype=np.int64)
        vals[self.perm[: len(arr)]] = np.array([int(v) % t for v in arr.ravel()],
                                               dtype=np.int64)
        pt_t = params.ring_t.intt(torch.from_numpy(vals[None, :]).to(params.device))
        if scale != 1:
            pt_t = params.ring_t.mul_scalar_montgomery(
                pt_t, mform_scalars((t,), scale, params.device))
        return pt_t

    def spread(self, pt_t: torch.Tensor) -> torch.Tensor:
        """R_T coefficients at gap N/n_t in degree N, [N] (RingT2Q)."""
        params = self.params
        out = torch.zeros(params.n, dtype=torch.int64, device=pt_t.device)
        out[:: params.n // params.n_t] = pt_t[0]
        return out

    def encode(self, values, level: int | None = None, scale: int = 1) -> Plaintext:
        params = self.params
        level = params.max_level if level is None else level
        spread = self.spread(self.encode_ring_t(values, scale))
        ring = params.ring_q.at_level(level)
        # RingT2Q with scaleUp (encoder.go:357-382): multiply by T^{-1} mod Q
        limbs = spread[None, :] % ring.moduli[:, None]
        tinv = torch.tensor([pow(self.t, -1, q) * (1 << 64) % q for q in ring.moduli_tuple],
                            dtype=torch.int64, device=params.device)
        pq = ring.mul_scalar_montgomery(limbs, tinv)
        return Plaintext(value=ring.ntt(pq),
                         metadata=MetaData(scale=Fraction(scale), is_ntt=True))

    def decode(self, pt: Plaintext) -> np.ndarray:
        params = self.params
        t = self.t
        level = pt.level
        ring = params.ring_q.at_level(level)
        v = pt.value
        if pt.metadata.is_ntt:
            v = ring.intt(v)
        # RingQ2T with scaleDown: multiply by T mod Q, centered exact Q -> T
        v = ring.mul_scalar_montgomery(v, mform_scalars(ring.moduli_tuple, t, params.device))
        vt = rt.mod_up(v, params.q_to_t(level), ring, params.ring_t, centered=True)
        # gather the gap-spread coefficients (RingQ2T for n_t < N), then NTT
        # over R_T, un-permute, divide by scale mod T
        vt = params.ring_t.ntt(vt[..., :: params.n // params.n_t].contiguous())
        scale = int(pt.metadata.scale)
        if scale != 1:
            vt = params.ring_t.mul_scalar_montgomery(
                vt, mform_scalars((t,), pow(scale, -1, t), params.device))
        return vt[0][self._perm_dev].cpu().numpy().astype(np.uint64)


class Evaluator:
    def __init__(self, params: BGVParameters,
                 rlk: RelinearizationKey | None = None,
                 galois_keys: dict[int, GaloisKey] | None = None,
                 scale_invariant: bool = False):
        self.params = params
        self.rlk = rlk
        self.gks = galois_keys or {}
        self.scale_invariant = scale_invariant  # True => BFV semantics

    def _ring(self, level):
        return self.params.ring_q.at_level(level)

    # -- scale matching (mod T) ------------------------------------------
    def _match_scales(self, s0: int, s1: int) -> tuple[int, int]:
        """matchScalesBinary (evaluator.go:1620): minimal centered (r0, r1)
        with s0 r0 = s1 r1 mod T."""
        t = self.params.t
        th = t >> 1

        def center(x):
            return t - x if x >= th else x

        a, b = t, 0
        A, B = pow(s0, -1, t) * s1 % t, 1
        r0, r1 = A, B
        e = center(A) + 1
        while A != 0:
            q = a // A
            a, A = A, a % A
            b, B = B, (t + b - B * q) % t
            if A != 0 and math.gcd(A, t) == 1:
                tmp = center(A) + center(B)
                if tmp < e:
                    e, r0, r1 = tmp, A, B
        return r0, r1

    def _mul_int(self, ct: Ciphertext, c: int) -> Ciphertext:
        ring = self._ring(ct.level)
        sc = mform_scalars(ring.moduli_tuple, c, ring.device)
        return ct.with_value(tuple(ring.mul_scalar_montgomery(v, sc) for v in ct.value))

    def _drop(self, ct: Ciphertext, level: int) -> Ciphertext:
        if ct.level == level:
            return ct
        return ct.with_value(tuple(v[..., : level + 1, :] for v in ct.value))

    def _align(self, a: Ciphertext, b: Ciphertext):
        level = min(a.level, b.level)
        a, b = self._drop(a, level), self._drop(b, level)
        s0, s1 = int(a.scale), int(b.scale)
        if s0 == s1:
            return a, b
        r0, r1 = self._match_scales(s0, s1)
        a = self._mul_int(a, r0).with_metadata(scale=Fraction(s0 * r0 % self.params.t))
        b = self._mul_int(b, r1).with_metadata(scale=a.scale)
        return a, b

    # -- linear ----------------------------------------------------------
    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            b = Ciphertext(value=(b.value,), metadata=b.metadata)
        a, b = self._align(a, b)
        ring = self._ring(a.level)
        d = max(a.degree, b.degree)
        va = list(a.value) + [None] * (d - a.degree)
        vb = list(b.value) + [None] * (d - b.degree)
        out = tuple(x if y is None else (y if x is None else ring.add(x, y))
                    for x, y in zip(va, vb))
        return a.with_value(out)

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            b = Ciphertext(value=(b.value,), metadata=b.metadata)
        ring = self._ring(b.level)
        return self.add(a, b.with_value(tuple(ring.neg(v) for v in b.value)))

    # -- multiplication -----------------------------------------------------
    def mul(self, a: Ciphertext, b, relin: bool = False) -> Ciphertext:
        if isinstance(b, Plaintext):
            return self._mul_plain(a, b)
        if self.scale_invariant:
            return self._tensor_scale_invariant(a, b, relin)
        return self._tensor_standard(a, b, relin)

    def mul_relin(self, a: Ciphertext, b) -> Ciphertext:
        return self.mul(a, b, relin=True)

    def _mul_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        level = min(a.level, pt.level)
        a = self._drop(a, level)
        ring = self._ring(level)
        # the plaintext carries T^{-1}; multiply by T * pt to keep one T^{-1}
        t = self.params.t
        tm = mform_scalars(ring.moduli_tuple, t, ring.device)
        ptm = ring.mform(ring.mul_scalar_montgomery(pt.value[..., : level + 1, :], tm))
        out = tuple(ring.mul_coeffs_montgomery(v, ptm) for v in a.value)
        return a.with_value(out).with_metadata(scale=Fraction(int(a.scale) * int(pt.scale) % t))

    def _tensor_standard(self, a: Ciphertext, b: Ciphertext, relin: bool) -> Ciphertext:
        """tensorStandard (evaluator.go:665-720): multiply one operand by
        T * 2^128 so the tensor result keeps a single T^{-1} factor."""
        level = min(a.level, b.level)
        a, b = self._drop(a, level), self._drop(b, level)
        ring = self._ring(level)
        t = self.params.t
        # T in double Montgomery form: T * 2^128 mod q (tMontgomery)
        t2 = mform_scalars(ring.moduli_tuple, t, ring.device, 1 << 128)
        c00 = ring.mul_scalar_montgomery(a.value[0], t2)  # = MForm(T * a0)
        c01 = ring.mul_scalar_montgomery(a.value[1], t2)
        c0 = ring.mul_coeffs_montgomery(c00, b.value[0])
        c1 = ring.add(ring.mul_coeffs_montgomery(c00, b.value[1]),
                      ring.mul_coeffs_montgomery(c01, b.value[0]))
        c2 = ring.mul_coeffs_montgomery(c01, b.value[1])
        scale = Fraction(int(a.scale) * int(b.scale) % t)
        ct = Ciphertext(value=(c0, c1, c2), metadata=a.metadata).with_metadata(scale=scale)
        if relin:
            ct = rlwe_eval.relinearize(self.params, ct, self.rlk)
        return ct

    def _tensor_scale_invariant(self, a: Ciphertext, b: Ciphertext,
                                relin: bool) -> Ciphertext:
        """tensorScaleInvariant (evaluator.go:975-1124): the BFV tensor over
        the extended basis (Q, QMul), then quantize by T/Q."""
        level = min(a.level, b.level)
        a, b = self._drop(a, level), self._drop(b, level)
        ring = self._ring(level)
        ring_m = self.params.ring_qmul
        up, down, back = self.params.qmul_tools(level)

        def mod_up_ntt(ct):
            return [ring_m.ntt(rt.mod_up(ring.intt(v), up, ring, ring_m, centered=True))
                    for v in ct.value]

        am, bm = mod_up_ntt(a), mod_up_ntt(b)

        def tensor(r, x, y):
            x0, x1 = r.mform(x[0]), r.mform(x[1])
            return (r.mul_coeffs_montgomery(x0, y[0]),
                    r.add(r.mul_coeffs_montgomery(x0, y[1]), r.mul_coeffs_montgomery(x1, y[0])),
                    r.mul_coeffs_montgomery(x1, y[1]))

        cq = tensor(ring, [a.value[0], a.value[1]], [b.value[0], b.value[1]])
        cm = tensor(ring_m, am, bm)

        t = self.params.t
        tm = mform_scalars(ring.moduli_tuple, t, ring.device)
        outs = []
        for xq, xm in zip(cq, cm):
            xq_c, xm_c = ring.intt(xq), ring_m.intt(xm)
            # floor((Q,QMul) / Q) -> QMul (ModDownQPtoP, floored)
            floored = rt.mod_down(xm_c, xq_c, down, ring_m, ring, ntt=False)
            # back to Q (centered) and multiply by T
            backq = rt.mod_up(floored, back, ring_m, ring, centered=True)
            outs.append(ring.ntt(ring.mul_scalar_montgomery(backq, tm)))

        q_mod_t = self.params.big_q(level) % t
        scale = Fraction(int(a.scale) * int(b.scale) * pow(t - q_mod_t, -1, t) % t)
        ct = Ciphertext(value=tuple(outs), metadata=a.metadata).with_metadata(scale=scale)
        if relin:
            ct = rlwe_eval.relinearize(self.params, ct, self.rlk)
        return ct

    # -- rescale (BGV modulus switching) ----------------------------------
    def rescale(self, a: Ciphertext) -> Ciphertext:
        if self.scale_invariant:
            return a
        level = a.level
        ring = self._ring(level)
        out = tuple(rt.div_round_by_last_modulus_ntt(ring, v) for v in a.value)
        ql = self.params.q[level]
        scale = Fraction(int(a.scale) * pow(ql, -1, self.params.t) % self.params.t)
        return a.with_value(out).with_metadata(scale=scale)

    # -- rotations ----------------------------------------------------------
    def rotate_columns(self, a: Ciphertext, k: int) -> Ciphertext:
        gal_el = self.params.galois_element(k)
        gk = self.gks.get(gal_el)
        if gk is None:
            raise ValueError(f"missing Galois key {gal_el}")
        return rlwe_eval.automorphism(self.params, a, gk)

    def rotate_rows(self, a: Ciphertext) -> Ciphertext:
        gal_el = self.params.galois_element_inverse()
        gk = self.gks.get(gal_el)
        if gk is None:
            raise ValueError(f"missing Galois key {gal_el}")
        return rlwe_eval.automorphism(self.params, a, gk)

"""CKKS encoder: canonical embedding <-> RNS polynomials.

Counterpart of ``matrix_fhe_tpu/schemes/ckks/encoder.py`` (the reference's
schemes/ckks/encoder.go and ckks_vector_ops.go).  The special (I)FFT uses
the 5^j rotation-group index, so slot j holds the evaluation at zeta^{5^j}
(rotations are slot shifts, conjugation is complex conjugation).  The
embedding is host numpy float64 (PREC64) for scales up to 2^50 and Python
Decimal with exact big-int rounding (PREC128, encoder.go:325
embedArbitrary) above; the only device work is one ring NTT / INTT.  The
FFTs' complex products are ``utils/fp.py:cmul``'s, the same on every host.

Layout (full slots): real parts -> coefficients [0, N/2), imaginary parts
-> [N/2, N) (schemes/ckks/utils.go:128-147), then the forward NTT.  On the
conjugate-invariant ring the N slots are real and the special IFFT's real
parts are the N coefficients (encoder.go:940-946).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from matrix_fhe_tpu_torch.rlwe.elements import MetaData, Plaintext
from matrix_fhe_tpu_torch.schemes.ckks.params import CKKSParameters
from matrix_fhe_tpu_torch.utils.fp import cmul


class Encoder:
    def __init__(self, params: CKKSParameters):
        self.params = params
        m = params.nth_root
        self.m = m
        n_group = m >> 2
        rot = np.empty(n_group, dtype=np.int64)
        five = 1
        for i in range(n_group):
            rot[i] = five
            five = (five * 5) & (m - 1)
        self.rot_group = rot
        self.roots = np.exp(2j * np.pi * np.arange(m + 1) / m)

    # -- special FFTs (ckks_vector_ops.go:18-77) ---------------------------
    def special_ifft(self, values: np.ndarray) -> np.ndarray:
        v = values.astype(np.complex128).copy()
        n = len(v)
        logn = (n - 1).bit_length()
        logm = (self.m - 1).bit_length()
        for loglen in range(logn, 0, -1):
            ln = 1 << loglen
            lenh, lenq = ln >> 1, ln << 2
            log_gap = logm - 2 - loglen
            idx = (lenq - (self.rot_group[:lenh] & (lenq - 1))) << log_gap
            w = self.roots[idx]
            blocks = v.reshape(-1, ln)
            a, b = blocks[:, :lenh], blocks[:, lenh:]
            blocks[:, :lenh], blocks[:, lenh:] = a + b, cmul(a - b, w[None, :])
        v /= n
        return v[_bit_reverse_perm(n)]

    def special_fft(self, values: np.ndarray) -> np.ndarray:
        v = values.astype(np.complex128)[_bit_reverse_perm(len(values))]
        n = len(v)
        logn = (n - 1).bit_length()
        logm = (self.m - 1).bit_length()
        for loglen in range(1, logn + 1):
            ln = 1 << loglen
            lenh, lenq = ln >> 1, ln << 2
            log_gap = logm - 2 - loglen
            w = self.roots[(self.rot_group[:lenh] & (lenq - 1)) << log_gap]
            blocks = v.reshape(-1, ln)
            a, b = blocks[:, :lenh], cmul(blocks[:, lenh:], w[None, :])
            blocks[:, :lenh], blocks[:, lenh:] = a + b, a - b
        return v

    def _special_ifft_arbitrary(self, values, digits: int):
        """embedArbitrary's special IFFT (encoder.go:325): special_ifft's
        butterfly schedule in Decimal arithmetic at ``digits`` digits."""
        from decimal import Decimal, localcontext
        from matrix_fhe_tpu_torch.utils import bignum as bn
        with localcontext() as ctx:
            ctx.prec = digits
            m = self.m
            pi2 = 2 * bn.pi(digits)
            roots = [(bn.cos(pi2 * k / m, digits), bn.sin(pi2 * k / m, digits))
                     for k in range(m + 1)]
            vr = [Decimal(complex(v).real) for v in values]
            vi = [Decimal(complex(v).imag) for v in values]
            n = len(vr)
            logn = (n - 1).bit_length()
            logm = (m - 1).bit_length()
            for loglen in range(logn, 0, -1):
                ln = 1 << loglen
                lenh, lenq = ln >> 1, ln << 2
                log_gap = logm - 2 - loglen
                for blk in range(0, n, ln):
                    for j in range(lenh):
                        idx = (lenq - (int(self.rot_group[j]) & (lenq - 1))) << log_gap
                        wr, wi = roots[idx]
                        a_r, a_i = vr[blk + j], vi[blk + j]
                        b_r, b_i = vr[blk + j + lenh], vi[blk + j + lenh]
                        dr, di = a_r - b_r, a_i - b_i
                        vr[blk + j], vi[blk + j] = a_r + b_r, a_i + b_i
                        vr[blk + j + lenh] = dr * wr - di * wi
                        vi[blk + j + lenh] = dr * wi + di * wr
            ninv = Decimal(1) / n
            perm = _bit_reverse_perm(n)
            return [vr[p] * ninv for p in perm], [vi[p] * ninv for p in perm]

    # -- encode / decode ----------------------------------------------------
    def _slots(self, values) -> np.ndarray:
        """``values`` in the full slot vector (real parts on the CI ring)."""
        vals = np.zeros(self.params.max_slots, dtype=np.complex128)
        values = np.asarray(values)
        vals[: len(values)] = np.real(values) if self._ci else values
        return vals

    @property
    def _ci(self) -> bool:
        return self.params.ring_type == "conjugate_invariant"

    def _reals(self, w) -> list:
        """The coefficients of the special IFFT's output ``w`` (a complex
        array, or PREC128's pair of lists of Decimals): its real parts, then
        its imaginary parts except on the CI ring."""
        re, im = w if isinstance(w, tuple) else (list(np.real(w)), list(np.imag(w)))
        return re if self._ci else re + im

    def _rounded(self, w, sf: float):
        """round(x * sf) of each real of ``w`` (a complex array): int64 words
        when all fit, else Python integers (np.rint rounds half to even,
        as round does)."""
        re = np.real(w) if self._ci else np.concatenate([np.real(w), np.imag(w)])
        v = np.rint(re * sf)
        if np.all(np.abs(v) < 2.0 ** 63):
            return v.astype(np.int64)
        return [round(x * sf) for x in self._reals(w)]

    def _coeffs(self, values, scale: Fraction):
        """The rounded integer coefficients of ``values`` at ``scale``."""
        vals = self._slots(values)
        if scale > (1 << 50):
            # PREC128: high-precision embed, exact big-int rounding
            from decimal import Decimal
            digits = max(40, int(np.log10(float(scale))) + 25)
            w = self._special_ifft_arbitrary(vals, digits)
            sd = Decimal(scale.numerator) / Decimal(scale.denominator)
            return [int((x * sd).to_integral_value(rounding="ROUND_HALF_EVEN"))
                    for x in self._reals(w)]
        return self._rounded(self.special_ifft(vals), float(scale))

    def _limbs(self, coeffs, moduli) -> torch.Tensor:
        """The residues of ``coeffs`` (int64 words or Python integers) mod
        each modulus, [len(moduli), N]."""
        if isinstance(coeffs, np.ndarray):
            limbs = np.stack([coeffs % q for q in moduli]).astype(np.int64)
        else:
            limbs = np.array([[c % q for c in coeffs] for q in moduli], dtype=np.int64)
        return torch.from_numpy(limbs).to(self.params.device)

    def encode(self, values, level: int | None = None, scale=None,
               is_ntt: bool = True) -> Plaintext:
        """Encode -> Embed (encoder.go:141-323), full slots."""
        params = self.params
        level = params.max_level if level is None else level
        scale = Fraction(params.default_scale if scale is None else scale)
        p = self._limbs(self._coeffs(values, scale), params.q[: level + 1])
        if is_ntt:
            p = params.ring_q.at_level(level).ntt(p)
        md = MetaData(scale=scale, is_ntt=is_ntt, log_dimensions=(0, params.log_max_slots))
        return Plaintext(value=p, metadata=md)

    def embed_qp(self, values, level_q: int, level_p: int | None = None, scale=None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Embed values into a (Q, P) polynomial in NTT + Montgomery form, the
        plaintext format of linear-transformation diagonals
        (schemes/ckks/encoder.go:193 Embed with a ringqp output)."""
        params = self.params
        scale = Fraction(params.default_scale if scale is None else scale)
        coeffs = self._rounded(self.special_ifft(self._slots(values)), float(scale))
        rq = params.ring_q.at_level(level_q)
        ptq = rq.mform(rq.ntt(self._limbs(coeffs, params.q[: level_q + 1])))
        ptp = None
        if level_p is not None and level_p >= 0 and params.ring_p is not None:
            rp = params.ring_p.at_level(level_p)
            ptp = rp.mform(rp.ntt(self._limbs(coeffs, params.p[: level_p + 1])))
        return ptq, ptp

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Decode (encoder.go:177): INTT, centered CRT reconstruction, divide
        by the scale, special FFT."""
        params = self.params
        level = pt.level
        v = pt.value
        if pt.metadata.is_ntt:
            v = params.ring_q.at_level(level).intt(v)
        coeffs = crt_reconstruct_centered(v.cpu().numpy(), params.q[: level + 1])
        sf = float(pt.metadata.scale)
        slots = params.max_slots
        re = np.array([float(c) / sf for c in coeffs[:slots]])
        if self._ci:
            # [X]/(X^N+1) -> [X+X^-1]/(X^N+1) (encoder.go:940-946)
            w = re.astype(np.complex128)
            w[1:] -= 1j * re[slots - 1:0:-1]
            return self.special_fft(w)
        im = np.array([float(c) / sf for c in coeffs[slots: 2 * slots]])
        return self.special_fft(re + 1j * im)


def crt_reconstruct_centered(limbs: np.ndarray, moduli: list[int]) -> list[int]:
    """Centered CRT reconstruction (ring/ring.go:503 PolyToBigintCentered)."""
    Q = 1
    for q in moduli:
        Q *= q
    basis = []
    for q in moduli:
        qs = Q // q
        basis.append(qs * pow(qs % q, q - 2, q))
    half = Q >> 1
    rows = [limbs[i].tolist() for i in range(len(moduli))]
    out = []
    for j in range(limbs.shape[-1]):
        acc = 0
        for i in range(len(moduli)):
            acc += rows[i][j] * basis[i]
        acc %= Q
        out.append(acc - Q if acc > half else acc)
    return out


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = (n - 1).bit_length()
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(logn):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out

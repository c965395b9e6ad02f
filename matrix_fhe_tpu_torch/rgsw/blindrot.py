"""Blind rotation (LMKCDEY, eprint 2022/198): the LWE -> RLWE functional
bootstrapping core.

Counterpart of ``matrix_fhe_tpu/rgsw/blindrot.py`` (the reference's
core/rgsw/blindrot/):

  * ``init_test_polynomial`` (blindrot.go:12-39): g over [a, b] encoded into
    the negacyclic test polynomial;
  * ``gen_evaluation_key`` (keys.go:46-120): RGSW(X^{s_j}) for each LWE
    secret coefficient, and the automorphism keys of GaloisGen^v
    (v <= WINDOW_SIZE) and X^{-g}; split into ``sample_evaluation_key``
    (the draws) and ``evaluation_key_from_samples``;
  * ``Evaluator.evaluate`` (evaluator.go:46-135): the LWE samples of the
    RLWE ciphertext's coefficients switched to mod 2N, then Algorithm 3
    (discrete-log scheduled automorphisms between external products) for
    each requested slot.

The discrete-log map, the mod switch, the LWE mask's rotations and the
schedule are host work in numpy and Python integers, done before the
device loop; each polynomial made on the host moves to the device once.
The loop itself runs only device work: it reads nothing back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.rgsw import rgsw
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData
from matrix_fhe_tpu_torch.rlwe.params import GALOIS_GEN, Parameters
from matrix_fhe_tpu_torch.schemes.ckks.encoder import crt_reconstruct_centered

WINDOW_SIZE = 10  # parameter w of Algorithm 3 (keys.go:14)


def init_test_polynomial(g, scale: float, params_br: Parameters, a: float, b: float
                         ) -> torch.Tensor:
    """InitTestPolynomial (blindrot.go:12-39): the NTT-domain [L, N]
    polynomial, built on the host and moved to the ring's device once."""
    n = params_br.n
    interval = 2.0 / n

    def norm_inv(x):
        return (x * (b - a) + b + a) / 2.0

    def scale_up(v, q):
        r = int(abs(v) * scale + 0.5) % q
        return (q - r) % q if v < 0 else r

    arr = np.zeros((len(params_br.q), n), dtype=np.int64)
    for j, q in enumerate(params_br.q):
        for i in range(n // 2 + 1):
            arr[j, i] = scale_up(g(norm_inv(-interval * i)), q)
        for i in range(n // 2 + 1, n):
            arr[j, i] = scale_up(-g(norm_inv(interval * (n - i))), q)
    return params_br.ring_q.ntt(torch.from_numpy(arr).to(params_br.device))


@dataclasses.dataclass
class BlindRotationKeys:
    """MemBlindRotationEvaluationKeySet (keys.go:31-44)."""
    brks: list                     # RGSW(X^{s_j}), one a LWE secret coefficient
    gks: dict[int, K.GaloisKey]


@dataclasses.dataclass(frozen=True)
class BlindRotationSamples:
    """The draws of ``gen_evaluation_key``: one RGSW encryption's a LWE
    secret coefficient, then one galois key's a galois element."""
    brks: list[rgsw.RGSWSample]
    gks: dict[int, list[K.ZeroSample]]


def galois_elements(params_br: Parameters) -> list[int]:
    """GaloisGen^v for v = 1..WINDOW_SIZE, then X^{-g}'s element 2N - g."""
    return [params_br.galois_element(v) for v in range(1, WINDOW_SIZE + 1)] + [
        params_br.nth_root - GALOIS_GEN]


def sample_evaluation_key(gen: torch.Generator, params_br: Parameters, params_lwe: Parameters
                          ) -> BlindRotationSamples:
    brks = [rgsw.sample_rgsw(gen, params_br) for _ in range(params_lwe.n)]
    return BlindRotationSamples(brks=brks, gks={
        g: K.sample_evaluation_key(gen, params_br) for g in galois_elements(params_br)})


def _lwe_secret(params_lwe: Parameters, sk_lwe: K.SecretKey) -> list[int]:
    """The LWE secret's centered coefficients (its first limb)."""
    rq = params_lwe.ring_q.at_level(0)
    s_coeff = rq.intt(rq.imform(sk_lwe.value.q[:1]))
    return crt_reconstruct_centered(s_coeff.cpu().numpy(), params_lwe.q[:1])


def _monomials(params: Parameters, ks) -> torch.Tensor:
    """X^k mod (X^N + 1) for each k of ``ks`` (mod 2N), on the host:
    int64 [len(ks), L, N]."""
    n = params.n
    out = np.zeros((len(ks), len(params.q), n), dtype=np.int64)
    for r, k in enumerate(ks):
        k %= 2 * n
        idx, sign = k % n, (k // n) & 1
        for j, q in enumerate(params.q):
            out[r, j, idx] = q - 1 if sign else 1
    return torch.from_numpy(out)


def evaluation_key_from_samples(params_br: Parameters, sk_br: K.SecretKey,
                                params_lwe: Parameters, sk_lwe: K.SecretKey,
                                samples: BlindRotationSamples) -> BlindRotationKeys:
    """GenEvaluationKeyNew (keys.go:46-120)."""
    s = _lwe_secret(params_lwe, sk_lwe)
    if len(samples.brks) != len(s):
        raise ValueError(f"{len(samples.brks)} RGSW samples for {len(s)} LWE coefficients")
    rq = params_br.ring_q
    pts = rq.mform(rq.ntt(_monomials(params_br, s).to(params_br.device)))
    brks = [rgsw.encrypt_from_samples(params_br, sk_br, pts[i], smp)
            for i, smp in enumerate(samples.brks)]
    gks = {g: K.galois_key_from_samples(params_br, sk_br, g, rows)
           for g, rows in samples.gks.items()}
    return BlindRotationKeys(brks=brks, gks=gks)


def gen_evaluation_key(gen: torch.Generator, params_br: Parameters, sk_br: K.SecretKey,
                       params_lwe: Parameters, sk_lwe: K.SecretKey) -> BlindRotationKeys:
    return evaluation_key_from_samples(params_br, sk_br, params_lwe, sk_lwe,
                                       sample_evaluation_key(gen, params_br, params_lwe))


class Evaluator:
    """blindrot.Evaluator (evaluator.go:14-257)."""

    def __init__(self, params_br: Parameters, params_lwe: Parameters):
        self.params_br = params_br
        self.params_lwe = params_lwe
        # map[(+/-) g^k mod 2N] = +/- k (getGaloisElementInverseMap :235)
        two_n = 2 * params_br.n
        self._dlog = {}
        pow_ = 1
        for i in range(params_br.n // 2):
            self._dlog[pow_] = i
            self._dlog[two_n - pow_] = -i
            pow_ = pow_ * GALOIS_GEN % two_n

    def _mod_switch_to_2n(self, level: int, pol: np.ndarray, make_odd: bool) -> np.ndarray:
        """round(x * 2N / Q) of the polynomial's representatives mod Q
        (evaluator.go:284-307), on the host."""
        params = self.params_lwe
        coeffs = crt_reconstruct_centered(pol, params.q[:level + 1])
        Q = params.ring_q.modulus_at_level(level)
        two_n = 2 * self.params_br.n
        out = np.zeros(params.n, dtype=np.int64)
        for i, c in enumerate(coeffs):
            c = c % Q
            v = (2 * c * two_n + Q) // (2 * Q)  # round(c * 2N / Q)
            v &= two_n - 1
            if make_odd and v & 1 == 0 and v != 0:
                v ^= 1
            out[i] = v
        return out

    def lwe_samples(self, ct: Ciphertext, indices) -> tuple[np.ndarray, dict[int, np.ndarray]]:
        """The LWE samples of the slots ``indices`` (sorted) of ``ct``, mod 2N:
        (b [N_lwe], {index: a rotated to that slot}) (evaluator.go:58-110)."""
        params_lwe = self.params_lwe
        rq_lwe = params_lwe.ring_q.at_level(ct.level)
        vals = ct.value
        if ct.metadata.is_ntt:
            vals = tuple(rq_lwe.intt(v) for v in vals)
        vals = [v.cpu().numpy() for v in vals]
        mask = 2 * self.params_br.n - 1
        a2n = self._mod_switch_to_2n(ct.level, vals[1], make_odd=True)
        # convolution -> dot product order: a0, -a_{N-1}, ..., -a_1
        a_cur = np.zeros(params_lwe.n, dtype=np.int64)
        a_cur[0] = a2n[0]
        for j in range(1, params_lwe.n):
            a_cur[j] = (-a2n[params_lwe.n - j]) & mask
        b2n = self._mod_switch_to_2n(ct.level, vals[0], make_odd=False)
        out, prev = {}, 0
        for index in indices:
            # multiply a by X^{index - prev} mod 2N (utils.go:11-20)
            sh = index - prev
            if sh:
                a_cur = np.concatenate([a_cur[-sh:], a_cur[:-sh]])
                a_cur[:sh] = (-a_cur[:sh]) & mask
            prev = index
            out[index] = a_cur.copy()
        return b2n, out

    def schedule(self, a: np.ndarray) -> list[tuple]:
        """Algorithm 3's steps for the mask ``a`` (evaluator.go:137-190), on
        the host: ("auto", galois element) and ("product", j) in order."""
        params = self.params_br
        n_half = params.n >> 1
        # map[+/-k] = [i...] (getDiscreteLogSets :258-280)
        sets: dict[int, list[int]] = {}
        for i, ai in enumerate(a.tolist()):
            if ai == 0:
                continue  # X^{0 * s_i} = 1: nothing to multiply
            if ai & 1 != 1:
                raise ValueError("a[i] not odd")
            sets.setdefault(self._dlog[ai], []).append(i)
        steps = []

        def auto(v):
            steps.append(("auto", params.galois_element(v)))

        def step(k, v):
            if k in sets:
                if v != 0:
                    auto(v)
                    v = 0
                steps.extend(("product", j) for j in sets[k])
            v += 1
            # flush pending automorphisms every window AND at the end of each
            # pass (|k| == 1), as the JAX package does; the reference's literal
            # condition is k == 1 (evaluator.go:219), which skips the negative
            # pass's tail
            if v == WINDOW_SIZE or abs(k) == 1:
                auto(v)
                v = 0
            return v

        v = 0
        for i in range(n_half - 1, 0, -1):
            v = step(-i, v)
        step(2 * params.n, 0)
        steps.append(("auto", params.nth_root - GALOIS_GEN))  # acc = acc(X^{-g})
        v = 0
        for i in range(n_half - 1, 0, -1):
            v = step(i, v)
        step(0, 0)
        return steps

    def evaluate(self, ct: Ciphertext, test_polys: dict[int, torch.Tensor],
                 brk: BlindRotationKeys) -> dict[int, Ciphertext]:
        """Evaluate (evaluator.go:46-135)."""
        params_br = self.params_br
        rq_br = params_br.ring_q
        indices = sorted(test_polys)
        b2n, masks = self.lwe_samples(ct, indices)
        # X^{b_index} for every slot, in one move and one transform
        xb = rq_br.mform(rq_br.ntt(_monomials(params_br, [int(b2n[i]) for i in indices])
                                   .to(params_br.device)))
        md = MetaData(is_ntt=True)
        res = {}
        for r, index in enumerate(indices):
            # Acc = (f(X^{-g}) X^{-g b}, 0): line 2 of Algorithm 7
            fb = rq_br.mul_coeffs_montgomery(test_polys[index], xb[r])
            c0 = am.automorphism_ntt(rq_br, fb, params_br.nth_root - GALOIS_GEN)
            acc = Ciphertext(value=(c0, torch.zeros_like(c0)), metadata=md)
            res[index] = self._blind_rotate_core(self.schedule(masks[index]), acc, brk)
        return res

    def _blind_rotate_core(self, steps: list[tuple], acc: Ciphertext,
                           brk: BlindRotationKeys) -> Ciphertext:
        """Algorithm 3 (evaluator.go:137-190) on the device, by ``schedule``."""
        params = self.params_br
        for kind, arg in steps:
            if kind == "auto":
                acc = rlwe_eval.automorphism(params, acc, brk.gks[arg])
            else:
                acc = rgsw.external_product(params, acc, brk.brks[arg])
        return acc

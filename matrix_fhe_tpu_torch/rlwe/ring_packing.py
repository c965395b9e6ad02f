"""Ring packing: Expand (coefficient extraction) and Pack (coefficient
repacking) via automorphism trees, and the cross-degree RingPackingEvaluator.

Counterpart of ``matrix_fhe_tpu/rlwe/ring_packing.py`` (the reference's
core/rlwe/ring_packing.go):

  * ``expand`` (:475-622): a ciphertext encrypting sum c_i X^i -> one
    ciphertext per (gap-strided) index i encrypting c_i in the constant
    coefficient, by logN rounds of even/odd splitting with phi_{N/n+1} and
    X^{-2^i};
  * ``pack`` (:623-795): the inverse, a map of ciphertexts each holding
    values in strided coefficients merged into one by the tree
    a + X^t b + phi(a - X^t b);
  * ``gen_x_pow2_ntt`` (:796-834): the NTT + MForm monomials X^{+-2^i};
  * ``RingPackingEvaluator`` (:74-430): Extract / Split / Merge / Repack
    across ring degrees N_min..N_max.

Standard (power-of-two) rings only, like the reference.  The monomials and
the scalars of the trees are built on the host once per parameter set (and
level) and kept on the ring's device.  The evaluator's secrets and keys are
drawn by ``sample_ring_packing_keys`` from a ``torch.Generator`` and made
from the draws by ``RingPackingEvaluator.from_samples``, as every key
generator of the port is split.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch

from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K, ring_switch as rs
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.utils.device import resolve_device

# gen_x_pow2_ntt's monomials of a parameter set, by ``div``
_MONOMIALS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _build_x_pow2_ntt(params: Parameters, div: bool) -> list[torch.Tensor]:
    rq = params.ring_q
    n = params.n
    out = []
    for i in range(params.log_n):
        k = (2 * n - (1 << i)) % (2 * n) if div else (1 << i)
        arr = np.zeros((len(params.q), n), dtype=np.int64)
        idx, sign = k % n, (k // n) & 1
        for j, q in enumerate(params.q):
            arr[j, idx] = q - 1 if sign else 1
        out.append(rq.mform(rq.ntt(torch.from_numpy(arr).to(params.device))))
    return out


def gen_x_pow2_ntt(params: Parameters, div: bool) -> list[torch.Tensor]:
    """X^{2^i} (or X^{-2^i} if div) for 0 <= i < logN, NTT + MForm [L, N],
    on the ring's device; built once per parameter set."""
    cached = _MONOMIALS.setdefault(params, {})
    if div not in cached:
        cached[div] = _build_x_pow2_ntt(params, div)
    return cached[div]


def galois_elements_for_expand(params: Parameters) -> list[int]:
    """ring_packing_keys.go:143-153."""
    return [params.nth_root // (2 << i) + 1 for i in range(params.log_n)]


def galois_elements_for_pack(params: Parameters, log_gap: int) -> list[int]:
    """ring_packing_keys.go:156-180."""
    els = [params.galois_element(1 << i) for i in range(log_gap)]
    if log_gap == params.log_n:
        els.append(params.nth_root - 1)
    return els


@functools.lru_cache(maxsize=4096)
def _scalar_big(moduli: tuple[int, ...], c: int, device: torch.device) -> torch.Tensor:
    """MForm(c mod q) per limb, on ``device``."""
    return torch.tensor([(c % q) * (1 << 64) % q for q in moduli], dtype=torch.int64,
                        device=device)


def _mul_scalar_big(rq, v, c: int):
    return rq.mul_scalar_montgomery(v, _scalar_big(rq.moduli_tuple, c, rq.device))


def _scaled(rq, ct: Ciphertext, c: int) -> Ciphertext:
    return ct.with_value(tuple(_mul_scalar_big(rq, v, c) for v in ct.value))


def _mul_mono(rq, ct: Ciphertext, mono: torch.Tensor) -> Ciphertext:
    return ct.with_value(tuple(rq.mul_coeffs_montgomery(v, mono) for v in ct.value))


def _zip(op, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    return a.with_value(tuple(op(x, y) for x, y in zip(a.value, b.value)))


def expand(params: Parameters, ct: Ciphertext, log_gap: int, gks, x_inv_pow2=None,
           num_stages: int | None = None) -> dict[int, Ciphertext]:
    """Expand (ring_packing.go:475-622): NTT-domain degree-1 input.

    ``num_stages`` < log_n stops the extraction tree early: the result is
    2^num_stages ciphertexts where ct_j (times X^{-j}) carries the
    coefficients with index = j mod 2^num_stages and zeros elsewhere, the
    inverse of a 2^num_stages-way coefficient interleave (the unpack step
    of the packed batch bootstrap, evaluator.go:1003-1065)."""
    if params.ring_type != "standard":
        raise ValueError("expand requires the standard ring")
    level = ct.level
    rq = params.ring_q.at_level(level)
    if num_stages is None:
        num_stages = params.log_n
    if x_inv_pow2 is None:
        x_inv_pow2 = gen_x_pow2_ntt(params, div=True)

    n_inv = pow(1 << num_stages, -1, rq.modulus_at_level(level))
    cts: dict[int, Ciphertext] = {0: _scaled(rq, ct, n_inv)}
    gap = 1 << log_gap
    for i in range(num_stages):
        n = 1 << i
        gal_el = params.n // n + 1
        for j in range(0, n, gap):
            c0 = cts[j]
            tmp = rlwe_eval.automorphism(params, c0, gks[gal_el])
            if j + n // gap > 0:
                cts[j + n] = _mul_mono(rq, _zip(rq.sub, c0, tmp), x_inv_pow2[i][:level + 1])
            cts[j] = _zip(rq.add, c0, tmp)
    return {k: v for k, v in cts.items() if k % gap == 0}


def pack(params: Parameters, cts: dict[int, Ciphertext], input_log_gap: int,
         zero_garbage_slots: bool, gks, x_pow2=None) -> Ciphertext:
    """Pack (ring_packing.go:623-795): NTT-domain degree-1 inputs."""
    if params.ring_type != "standard":
        raise ValueError("pack requires the standard ring")
    if not cts:
        raise ValueError("no ciphertexts to pack")
    keys = sorted(cts.keys())
    log_n = params.log_n
    level = cts[keys[0]].level
    rq = params.ring_q.at_level(level)
    if x_pow2 is None:
        x_pow2 = gen_x_pow2_ntt(params, div=False)

    if len(keys) > 1:
        gap = int(np.gcd.reduce(np.array(keys[1:] if keys[0] == 0 else keys, dtype=np.int64)))
        log_gap = gap.bit_length() - 1
        if gap != 1 << log_gap:
            raise ValueError("ciphertext indices must have power-of-two gaps")
    else:
        gap, log_gap = params.n, log_n

    log_start = log_n - input_log_gap
    log_end = log_n
    if not zero_garbage_slots and gap > 0:
        log_end -= log_gap
    if log_start >= log_end:
        raise ValueError("gap between ciphertexts smaller than input gap")

    n_inv = pow(1 << (log_end - log_start), -1, rq.modulus_at_level(level))
    work: dict[int, Ciphertext | None] = {k: _scaled(rq, v, n_inv) for k, v in cts.items()}

    for i in range(log_start, log_end):
        t = 1 << (log_n - 1 - i)
        xp = x_pow2[log_n - i - 1][:level + 1]
        gal_el = params.nth_root - 1 if i == 0 else params.galois_element(1 << (i - 1))
        for jx in range(t):
            jy = jx + t
            a = work.get(jx)
            b = work.get(jy)
            if b is not None:
                b = _mul_mono(rq, b, xp)
                if a is not None:
                    tmpa = rlwe_eval.automorphism(params, _zip(rq.sub, a, b), gks[gal_el])
                    work[jx] = _zip(rq.add, _zip(rq.add, a, b), tmpa)
                else:
                    # b*X^t - phi(b*X^t)
                    work[jx] = _zip(rq.sub, b, rlwe_eval.automorphism(params, b, gks[gal_el]))
                work[jy] = None
            elif a is not None:
                work[jx] = _zip(rq.add, a, rlwe_eval.automorphism(params, a, gks[gal_el]))
    return work[0]


# ---------------------------------------------------------------------------
# Cross-degree ring packing (ring_packing.go:74-430 RingPackingEvaluator).
# ---------------------------------------------------------------------------

def galois_elements_for_ring_packing(pmin: Parameters) -> list[int]:
    """The galois elements of the same-degree expand and pack trees at the
    minimum degree, sorted (the order their keys are drawn in)."""
    return sorted(set(galois_elements_for_expand(pmin))
                  | set(galois_elements_for_pack(pmin, pmin.log_n)))


@dataclasses.dataclass
class RingPackingSamples:
    """The random part of a RingPackingEvaluator's keys: the secret's
    coefficients a degree, the rows of the adjacent-degree ring-switching
    keys (each over the larger ring), and those of the galois keys at the
    minimum degree, by element."""
    sk: dict[int, torch.Tensor]
    evk_down: dict[int, list[K.ZeroSample]]
    evk_up: dict[int, list[K.ZeroSample]]
    gks_min: dict[int, list[K.ZeroSample]]


def sample_ring_packing_keys(gen: torch.Generator, params: dict[int, Parameters]
                             ) -> RingPackingSamples:
    """Draw from ``gen``: the secrets by ascending degree, then for each
    degree above the minimum its down and up key, then the galois keys at
    the minimum degree in ``galois_elements_for_ring_packing`` order."""
    lns = sorted(params)
    sk = {ln: K.sample_secret(gen, params[ln]) for ln in lns}
    down, up = {}, {}
    for ln in lns[1:]:
        down[ln] = K.sample_evaluation_key(gen, params[ln])
        up[ln] = K.sample_evaluation_key(gen, params[ln])
    pmin = params[lns[0]]
    gks = {g: K.sample_evaluation_key(gen, pmin) for g in galois_elements_for_ring_packing(pmin)}
    return RingPackingSamples(sk=sk, evk_down=down, evk_up=up, gks_min=gks)


def _keys_from_samples(params: dict[int, Parameters], s: RingPackingSamples):
    """(secrets, up keys, down keys, galois keys) of a RingPackingEvaluator,
    made from its draws: evk_down[ln] re-encrypts sk_ln to the embedded
    sk_{ln-1}, evk_up[ln] back, both in the degree-2^ln ring."""
    lns = sorted(params)
    sk = {ln: K.secret_key_from_sample(params[ln], s.sk[ln]) for ln in lns}
    evk_up, evk_down = {}, {}
    for ln in lns[1:]:
        pl, ps = params[ln], params[ln - 1]
        emb = rs.embed_secret_key(ps, pl, sk[ln - 1])
        evk_down[ln] = K.evaluation_key_from_samples(pl, sk[ln].value.q, emb, s.evk_down[ln])
        evk_up[ln] = K.evaluation_key_from_samples(pl, emb.value.q, sk[ln], s.evk_up[ln])
    gks = {g: K.galois_key_from_samples(params[lns[0]], sk[lns[0]], g, rows)
           for g, rows in s.gks_min.items()}
    return sk, evk_up, evk_down, gks


class RingPackingEvaluator:
    """Extract / Split / Merge / Repack across ring degrees N_min..N_max
    (core/rlwe/ring_packing.go:74-430).

    Holds one parameter set per log-degree (identical moduli chains), a
    fresh secret per degree, the adjacent-degree ring-switching keys
    (evk_down[ln]: sk_ln -> embed(sk_{ln-1}); evk_up[ln]: embed(sk_{ln-1})
    -> sk_ln, both living in the degree-2^ln ring) and the galois keys the
    same-degree expand and pack trees need at the minimum degree.

    ``split`` maps ctN[X] = even[Y] + X*odd[Y] (Y = X^2) to two degree-N/2
    ciphertexts; ``merge`` is its inverse; ``extract`` / ``repack`` compose
    them with the same-degree trees exactly like the reference (the naive
    variants skip the zeroing trees)."""

    def __init__(self, gen: torch.Generator, make_params, log_n_min: int, log_n_max: int,
                 device="cuda"):
        """``make_params(log_n, device) -> Parameters`` must produce sets
        sharing one moduli chain (the caller's parameter family), on
        ``device`` (the card unless told otherwise)."""
        device = resolve_device(device)
        params = {ln: make_params(ln, device) for ln in range(log_n_min, log_n_max + 1)}
        self._set(params, *_keys_from_samples(params, sample_ring_packing_keys(gen, params)))

    @classmethod
    def from_samples(cls, params: dict[int, Parameters], samples: RingPackingSamples
                     ) -> "RingPackingEvaluator":
        """The evaluator of ``params`` (by log-degree) whose secrets and keys
        are made from ``samples`` (``sample_ring_packing_keys``'s layout)."""
        return cls.from_keys(params, *_keys_from_samples(params, samples))

    @classmethod
    def from_keys(cls, params: dict[int, Parameters], sk: dict[int, K.SecretKey],
                  evk_up: dict[int, K.EvaluationKey], evk_down: dict[int, K.EvaluationKey],
                  gks_min: dict[int, K.GaloisKey], x_pow2=None, x_inv_pow2=None
                  ) -> "RingPackingEvaluator":
        """The evaluator holding these secrets and keys (and monomials, else
        ``gen_x_pow2_ntt``'s)."""
        out = cls.__new__(cls)
        out._set(params, sk, evk_up, evk_down, gks_min, x_pow2, x_inv_pow2)
        return out

    def _set(self, params, sk, evk_up, evk_down, gks_min, x_pow2=None, x_inv_pow2=None) -> None:
        self.log_n_min = min(params)
        self.log_n_max = max(params)
        self.params = dict(params)
        self.sk = sk
        self.evk_up = evk_up
        self.evk_down = evk_down
        self.gks_min = gks_min
        self.x_pow2 = x_pow2 or {ln: gen_x_pow2_ntt(p, div=False) for ln, p in params.items()}
        self.x_inv_pow2 = x_inv_pow2 or {ln: gen_x_pow2_ntt(p, div=True)
                                         for ln, p in params.items()}

    # -- degree changes ------------------------------------------------------
    def split(self, ct: Ciphertext, log_n: int) -> tuple[Ciphertext, Ciphertext]:
        """ctN[X] = even[Y] + X odd[Y], NTT-domain degree-1 input
        (ring_packing.go:191-247)."""
        pl, ps = self.params[log_n], self.params[log_n - 1]
        rq = pl.ring_q.at_level(ct.level)
        tmp = rlwe_eval.apply_evaluation_key(pl, ct, self.evk_down[log_n])

        def down(c):
            rs_q = ps.ring_q.at_level(c.level)
            return c.with_value(tuple(rs_q.ntt(rs.map_large_to_small_coeff(2, rq.intt(v)))
                                      for v in c.value))

        even = down(tmp)
        odd = down(_mul_mono(rq, tmp, self.x_inv_pow2[log_n][0][:ct.level + 1]))
        return even, odd

    def merge(self, even: Ciphertext | None, odd: Ciphertext | None,
              log_n: int) -> Ciphertext:
        """Inverse of split: (even, odd) at degree 2^{log_n-1} -> degree
        2^{log_n} (ring_packing.go:395-430)."""
        pl = self.params[log_n]
        ref = even if even is not None else odd
        rq = pl.ring_q.at_level(ref.level)

        def up(c):
            return c.with_value(tuple(rs.map_small_to_large_ntt(2, v) for v in c.value))

        acc = None
        if even is not None:
            acc = up(even)
        if odd is not None:
            o = _mul_mono(rq, up(odd), self.x_pow2[log_n][0][:ref.level + 1])
            acc = o if acc is None else _zip(rq.add, acc, o)
        return rlwe_eval.apply_evaluation_key(pl, acc, self.evk_up[log_n])

    # -- extract / repack ----------------------------------------------------
    def extract(self, ct: Ciphertext, idx, naive: bool = False) -> dict[int, Ciphertext]:
        """ct encrypting sum c_i X^i at degree N_max -> {i: ct_i} at degree
        N_min with c_i in the constant slot (ring_packing.go:74-190); the
        naive form skips zeroing the other coefficients (compose with
        repack)."""
        log_max, log_min = self.log_n_max, self.log_n_min
        factor_bits = log_max - log_min
        n_factor = 1 << factor_bits
        keys = sorted(idx)
        gap = keys[1] - keys[0] if len(keys) > 1 else self.params[log_max].n
        log_gap = max(0, int(gap).bit_length() - 1)

        tmp = {0: ct}
        for i in range(factor_bits):
            t = 1 << i
            log_gap = max(0, log_gap - 1)
            for j in list(tmp.keys()):
                even, odd = self.split(tmp[j], log_max - i)
                tmp[j] = even
                tmp[j + t] = odd

        buckets: dict[int, list[int]] = {}
        for i in keys:
            buckets.setdefault(i & (n_factor - 1), []).append(i // n_factor)

        pmin = self.params[log_min]
        rq = pmin.ring_q.at_level(ct.level)
        out: dict[int, Ciphertext] = {}
        for b, sub in buckets.items():
            if naive:
                small = {}
                for j in sub:
                    c = tmp[b]
                    for i in range(pmin.log_n):
                        if (j >> i) & 1:
                            c = _mul_mono(rq, c, self.x_inv_pow2[log_min][i][:ct.level + 1])
                    small[j] = c
            else:
                small = expand(pmin, tmp[b], log_gap, self.gks_min, self.x_inv_pow2[log_min])
            for j in sub:
                out[b + j * n_factor] = small[j]
        return out

    def repack(self, cts: dict[int, Ciphertext], naive: bool = False) -> Ciphertext:
        """{i: ct_i} at degree N_min (values in the constant slot) -> one
        degree-N_max ciphertext encrypting sum ct_i[0] X^i
        (ring_packing.go:262-392)."""
        log_max, log_min = self.log_n_max, self.log_n_min
        factor_bits = log_max - log_min
        n_factor = 1 << factor_bits
        keys = sorted(cts)
        level = cts[keys[0]].level
        pmin = self.params[log_min]
        rq = pmin.ring_q.at_level(level)

        small: list[dict[int, Ciphertext]] = [dict() for _ in range(n_factor)]
        for i in keys:
            small[i & (n_factor - 1)][i // n_factor] = cts[i]

        large: dict[int, Ciphertext | None] = {}
        for b in range(n_factor):
            if not small[b]:
                large[b] = None
                continue
            if naive:
                work = dict(small[b])
                for i in range(pmin.log_n):
                    t = 1 << (pmin.log_n - 1 - i)
                    for jx in range(t):
                        jy = jx + t
                        a, bb = work.get(jx), work.get(jy)
                        if bb is not None:
                            xp = self.x_pow2[log_min][pmin.log_n - 1 - i][:level + 1]
                            bb = _mul_mono(rq, bb, xp)
                            work[jx] = bb if a is None else _zip(rq.add, a, bb)
                            work[jy] = None
                large[b] = work[0]
            else:
                large[b] = pack(pmin, small[b], pmin.log_n, True, self.gks_min,
                                self.x_pow2[log_min])

        for i in range(factor_bits - 1, -1, -1):
            t = 1 << i
            for j in range(t):
                a, bb = large.get(j), large.get(j + t)
                if a is not None or bb is not None:
                    large[j] = self.merge(a, bb, log_max - i)
                    large[j + t] = None
        return large[0]

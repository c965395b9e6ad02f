"""CKKS bootstrapping: ScaleDown -> ModUp -> CoeffsToSlots -> EvalMod ->
SlotsToCoeffs.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/bootstrapping.py`` (the
reference's circuits/ckks/bootstrapping/: evaluator.go:548-795 bootstrap
pipeline, :100-246 matrix/scaling initialization; parameters.go chain
layout), for dense (log_slots = logN-1) and sparse (repack) packings, with
or without the sparse-secret encapsulation keys.  The pipeline programs
against the evaluator interface, so the int32 fast path runs it unchanged
(``fast/fboot.py``).  ``bootstrap_packed`` and ``bootstrap_sparse``
refresh several sparse ciphertexts through one pipeline pass, over ring
packing (``rlwe/ring_packing.py``) and ring switching
(``rlwe/ring_switch.py``) on the u64 path; the pipeline between them runs
on whatever evaluator was injected.

Key generation is split, as every key generator of the port is, into a
sampling part on an explicit ``torch.Generator``
(``sample_evaluation_keys``) and a deterministic part
(``evaluation_keys_from_samples``); ``gen_evaluation_keys`` runs both.

The modulus chain is laid out bottom-up as
  [q0 | residual levels | S2C levels | Mod1 levels | C2S levels]
so the pipeline consumes C2S at the top and lands back on the residual
levels (parameters_literal.go modulus budgeting, compacted: one modulus per
DFT matrix, PREC64).
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import torch

from matrix_fhe_tpu_torch.circuits.ckks import dft, mod1
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor
from matrix_fhe_tpu_torch.rlwe import evaluator as rlwe_eval, keys as K
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.schemes import ckks


@dataclasses.dataclass
class ParametersLiteral:
    """Compact analogue of bootstrapping.ParametersLiteral
    (parameters_literal.go): per-step modulus sizes + mod1 knobs."""
    log_n: int
    residual_log_q: tuple[int, ...]      # q0 + usable residual levels
    log_p: tuple[int, ...] = (61, 61)
    log_slots: int | None = None         # default: logN - 1 (dense)
    c2s_log_q: tuple[int, ...] = (56, 56, 56)
    s2c_log_q: tuple[int, ...] = (45, 45, 45)
    mod1_log_q: int = 60
    mod1_type: str = mod1.COS_DISCRETE
    mod1_k: int = 12
    mod1_degree: int = 30
    mod1_double_angle: int = 3
    mod1_inv_degree: int = 0
    log_message_ratio: int = 8
    log_default_scale: int = 45
    # Hamming weight of the ephemeral sparse secret used to encapsulate the
    # ModUp step (keys.go EvkDenseToSparse/EvkSparseToDense + the
    # CHANGELOG.md:11-12 security fix); 0 = dense-key path.
    ephemeral_secret_weight: int = 0
    # Explicit moduli overriding the bit-budget chain generation (the
    # reference's default sets list explicit primes too,
    # default_parameters.go:25-195).  When set, ``q`` must follow the
    # [residual | S2C | Mod1 | C2S] layout and match the literal's level
    # counts; the log_q/log_p budgets are then only documentation.
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None


class Parameters:
    """Assembled bootstrapping parameters: the extended-chain CKKS params
    (on ``device``, the card unless told otherwise) plus the three
    sub-circuit literals with budgeted levels."""

    def __init__(self, lit: ParametersLiteral, device="cuda"):
        self.lit = lit
        log_slots = lit.log_n - 1 if lit.log_slots is None else lit.log_slots
        self.log_slots = log_slots

        m1_depth = mod1.ParametersLiteral(
            level_q=0, log_scale=lit.mod1_log_q, mod1_type=lit.mod1_type,
            k=lit.mod1_k, mod1_degree=lit.mod1_degree,
            double_angle=lit.mod1_double_angle,
            mod1_inv_degree=lit.mod1_inv_degree).depth()

        logq = (tuple(lit.residual_log_q) + tuple(lit.s2c_log_q)
                + (lit.mod1_log_q,) * m1_depth + tuple(lit.c2s_log_q))
        if lit.q is not None:
            if len(lit.q) != len(logq):
                raise ValueError(
                    f"explicit q has {len(lit.q)} primes, chain layout "
                    f"needs {len(logq)}")
            self.params = ckks.new_parameters(ckks.CKKSParametersLiteral(
                logn=lit.log_n, q=tuple(lit.q), p=tuple(lit.p),
                log_default_scale=lit.log_default_scale), device)
        else:
            self.params = ckks.new_parameters(ckks.CKKSParametersLiteral(
                logn=lit.log_n, logq=logq, logp=lit.log_p,
                log_default_scale=lit.log_default_scale), device)

        L = self.params.max_level
        d_c2s = len(lit.c2s_log_q)
        d_s2c = len(lit.s2c_log_q)
        self.residual_level = len(lit.residual_log_q) - 1

        fmt = dft.SPLIT_REAL_AND_IMAG if log_slots == lit.log_n - 1 \
            else dft.REPACK_IMAG_AS_REAL
        self.c2s_lit = dft.MatrixLiteral(
            type=dft.HOMOMORPHIC_ENCODE, log_slots=log_slots, level_q=L,
            level_p=self.params.max_level_p, levels=[1] * d_c2s, format=fmt)
        self.mod1_lit = mod1.ParametersLiteral(
            level_q=L - d_c2s, log_scale=lit.mod1_log_q,
            mod1_type=lit.mod1_type, log_message_ratio=lit.log_message_ratio,
            k=lit.mod1_k, mod1_degree=lit.mod1_degree,
            double_angle=lit.mod1_double_angle,
            mod1_inv_degree=lit.mod1_inv_degree)
        self.s2c_lit = dft.MatrixLiteral(
            type=dft.HOMOMORPHIC_DECODE, log_slots=log_slots,
            level_q=L - d_c2s - m1_depth, level_p=self.params.max_level_p,
            levels=[1] * d_s2c, format=fmt)
        assert self.s2c_lit.level_q - d_s2c == self.residual_level, \
            (self.s2c_lit.level_q, d_s2c, self.residual_level)

    def galois_elements(self) -> list[int]:
        els = set(dft.galois_elements(self.params, self.c2s_lit))
        els |= set(dft.galois_elements(self.params, self.s2c_lit))
        els |= set(rlwe_eval.galois_elements_for_trace(self.params, self.log_slots))
        els.discard(1)
        return sorted(els)


def galois_elements_for_packed_bootstrap(params, k: int) -> list[int]:
    """Galois elements for the pack and partial-expand trees of
    :meth:`Evaluator.bootstrap_packed` (ring_packing_keys.go:143-180)."""
    from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk
    log_k = k.bit_length() - 1
    els = set(rpk.galois_elements_for_expand(params)[:log_k])
    # pack stages i in [log_n - log_k, log_n)
    for i in range(params.log_n - log_k, params.log_n):
        els.add(params.nth_root - 1 if i == 0 else params.galois_element(1 << (i - 1)))
    els.discard(1)
    return sorted(els)


@dataclasses.dataclass
class EvaluationKeys:
    rlk: K.RelinearizationKey
    gks: dict[int, K.GaloisKey]
    # Sparse-secret encapsulation keys (bootstrapping/keys.go:400
    # EvkDenseToSparse / EvkSparseToDense); None on the dense path.
    evk_dense_to_sparse: K.EvaluationKey | None = None
    evk_sparse_to_dense: K.EvaluationKey | None = None


@dataclasses.dataclass
class EvaluationKeySamples:
    """The random part of ``gen_evaluation_keys``: one zero-encryption
    sample a gadget row of each key, and the ephemeral sparse secret."""
    rlk: list[K.ZeroSample]
    gks: dict[int, list[K.ZeroSample]]
    sparse: torch.Tensor | None = None           # [LQ, N], Hamming weight h
    dense_to_sparse: list[K.ZeroSample] | None = None
    sparse_to_dense: list[K.ZeroSample] | None = None


def sample_evaluation_keys(gen: torch.Generator, p: Parameters) -> EvaluationKeySamples:
    """Draw every key's samples from ``gen``: the relinearization key, the
    galois keys in ``p.galois_elements()`` order, then (with an ephemeral
    weight) the sparse secret and the two encapsulation keys."""
    params = p.params
    out = EvaluationKeySamples(
        rlk=K.sample_evaluation_key(gen, params),
        gks={g: K.sample_evaluation_key(gen, params) for g in p.galois_elements()})
    if p.lit.ephemeral_secret_weight > 0:
        out.sparse = smp.sample(gen, params.ring_q,
                                smp.Ternary(h=p.lit.ephemeral_secret_weight))
        out.dense_to_sparse = K.sample_evaluation_key(gen, params)
        out.sparse_to_dense = K.sample_evaluation_key(gen, params)
    return out


def evaluation_keys_from_samples(p: Parameters, sk: K.SecretKey,
                                 s: EvaluationKeySamples) -> EvaluationKeys:
    """The deterministic part of ``gen_evaluation_keys`` (keys.go
    GenEvaluationKeys): with an ephemeral sparse secret s', EvkDenseToSparse
    re-encrypts from sk to s' and EvkSparseToDense back, so the ModUp
    raise's noise scales with s''s weight instead of the dense key's."""
    params = p.params
    rlk = K.relinearization_key_from_samples(params, sk, s.rlk)
    gks = {g: K.galois_key_from_samples(params, sk, g, rows) for g, rows in s.gks.items()}
    d2s = s2d = None
    if s.sparse is not None:
        sk_eph = K.SecretKey(value=K._to_qp_small(params, s.sparse))
        d2s = K.evaluation_key_from_samples(params, sk.value.q, sk_eph, s.dense_to_sparse)
        s2d = K.evaluation_key_from_samples(params, sk_eph.value.q, sk, s.sparse_to_dense)
    return EvaluationKeys(rlk=rlk, gks=gks, evk_dense_to_sparse=d2s, evk_sparse_to_dense=s2d)


def gen_evaluation_keys(gen: torch.Generator, p: Parameters,
                        sk: K.SecretKey) -> EvaluationKeys:
    return evaluation_keys_from_samples(p, sk, sample_evaluation_keys(gen, p))


class Evaluator:
    """bootstrapping.Evaluator (evaluator.go:100-246 init, :548 bootstrap)."""

    def __init__(self, p: Parameters, evk: EvaluationKeys,
                 ev=None, enc=None):
        """``ev``/``enc`` override the scheme evaluator/encoder — the int32
        fast path (fast/fboot.py) injects its FastEvaluator/FastEncoder here
        and the whole pipeline below runs on int32 arrays unchanged."""
        self.p = p
        params = p.params
        self.ev = ev if ev is not None else ckks.Evaluator(
            params, rlk=evk.rlk, galois_keys=evk.gks)
        self.enc = enc if enc is not None else ckks.Encoder(params)
        self.gks = evk.gks
        self.evk_dense_to_sparse = evk.evk_dense_to_sparse
        self.evk_sparse_to_dense = evk.evk_sparse_to_dense

        self.mod1_params = mod1.new_parameters_from_literal(params, p.mod1_lit)
        m1 = self.mod1_params

        # Scaling constants (evaluator.go:197-233)
        q_div = float(m1.scaling_factor) / math.exp2(round(math.log2(params.q[0])))
        q_div = min(q_div, 1.0)
        c2s_scaling = q_div / (m1.k * m1.q_diff)
        offset = float(m1.scaling_factor) / m1.message_ratio
        s2c_scaling = float(params.default_scale) / offset

        c2s_lit = dataclasses.replace(p.c2s_lit, scaling=c2s_scaling)
        s2c_lit = dataclasses.replace(p.s2c_lit, scaling=s2c_scaling)
        self.c2s_matrix = dft.new_matrix_from_literal(params, c2s_lit, self.enc)
        self.s2c_matrix = dft.new_matrix_from_literal(params, s2c_lit, self.enc)
        self.mod1_eval = mod1.Evaluator(self.ev, self.enc, self.mod1_params)

    # -- pipeline steps ----------------------------------------------------
    def scale_down(self, ct: Ciphertext) -> Ciphertext:
        """evaluator.go:598-645 ScaleDown: to level 0, scale q0/msgRatio."""
        params = self.p.params
        msg_ratio = self.mod1_params.message_ratio

        def ratio_ok(c):
            cur = Fraction(params.ring_q.modulus_at_level(c.level)) / c.scale
            return cur >= Fraction(params.q[c.level]) * Fraction(msg_ratio)

        while ct.level != 0 and ratio_ok(ct):
            ct = self.ev.drop_level(ct, 1)

        current = Fraction(params.ring_q.modulus_at_level(ct.level)) / ct.scale
        scale_up = current / Fraction(msg_ratio)
        if scale_up < Fraction(1, 2):
            raise ValueError("initial Q/scale < 0.5 * q0/msgRatio")
        factor = round(scale_up)
        if factor >= 1:
            ct = self.ev.scale_up(ct, factor)

        while ct.level != 0:
            ct = self.ev.rescale(ct)
        return ct

    def mod_up(self, ct: Ciphertext) -> Ciphertext:
        """evaluator.go:646-795 ModUp (dense-key path): centered lift
        q0 -> Q, NTT, message scale-up, Trace (SubSum).  The lift/trace are
        evaluator methods (ev.mod_raise / ev.trace_log_n) so backend-specific
        evaluators substitute their own kernels."""
        out = self.ev.mod_raise(ct)

        # sparse-secret encapsulation: return to the dense key right after
        # the raise (evaluator.go:745-756 SwitchKeys EvkSparseToDense)
        if self.evk_sparse_to_dense is not None:
            out = self.ev.apply_evaluation_key(out, self.evk_sparse_to_dense)

        m1 = self.mod1_params
        scale = (float(m1.scaling_factor) / m1.message_ratio) / float(ct.scale)
        if scale > 1:
            factor = round(scale)
            out = self.ev.scale_up(out, factor)

        return self.ev.trace_log_n(out, self.p.log_slots)

    def coeffs_to_slots(self, ct: Ciphertext):
        return dft.coeffs_to_slots(self.p.params, self.ev, ct,
                                   self.c2s_matrix, self.gks)

    def eval_mod(self, ct: Ciphertext) -> Ciphertext:
        out = self.mod1_eval.evaluate(ct)
        return out.with_metadata(scale=self.p.params.default_scale)

    def slots_to_coeffs(self, ct_real, ct_imag) -> Ciphertext:
        return dft.slots_to_coeffs(self.p.params, self.ev, ct_real, ct_imag,
                                   self.s2c_matrix, self.gks)

    # -- full pipeline -----------------------------------------------------
    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        """evaluator.go:548-588: refresh ct to the top residual level."""
        ct = self.scale_down(ct)
        # encapsulate under the ephemeral sparse key before the raise
        # (evaluator.go:646-660 SwitchKeys EvkDenseToSparse at q0)
        if self.evk_dense_to_sparse is not None:
            ct = self.ev.apply_evaluation_key(ct, self.evk_dense_to_sparse)
        ct = self.mod_up(ct)
        ct_real, ct_imag = self.coeffs_to_slots(ct)
        ct_real = self.eval_mod(ct_real)
        if ct_imag is not None:
            ct_imag = self.eval_mod(ct_imag)
        return self.slots_to_coeffs(ct_real, ct_imag)

    # -- batch bootstrapping (BootstrapMany, evaluator.go:263-344) ---------
    def _mul_i(self, ct: Ciphertext) -> Ciphertext:
        """Exact multiplication by the imaginary unit (double-RNS scalar at
        scale 1 — i is a 4th root of unity mod every NTT prime)."""
        return self.ev.mul_const_complex(ct, 1j, scale=1)

    def _split_real_imag(self, ct: Ciphertext):
        """Split a complex-packed ciphertext into (Re, Im) parts via the
        conjugation automorphism; the /2 is free in the declared scale."""
        cj = self.ev.conjugate(ct)
        re = self.ev.add(ct, cj).with_metadata(scale=ct.scale * 2)
        im = self._mul_i(self.ev.sub(cj, ct)).with_metadata(scale=ct.scale * 2)
        return re, im

    def bootstrap_many(self, cts: list[Ciphertext]) -> list[Ciphertext]:
        """Bootstrap a batch of real-payload ciphertexts, packing pairs as
        ct_a + i*ct_b so each pipeline invocation refreshes two ciphertexts
        (evaluator.go:263-344 BootstrapMany).  Outputs carry scale 2*S
        (exact in the Fraction bookkeeping) for the paired entries.

        Only valid when the payloads are real; complex-payload ciphertexts
        should go through :meth:`bootstrap` one by one.
        """
        out: list[Ciphertext] = []
        for i in range(0, len(cts) - 1, 2):
            a, b, _ = self.ev._match(cts[i], cts[i + 1])
            packed = self.ev.add(a, self._mul_i(b))
            re, im = self._split_real_imag(self.bootstrap(packed))
            out.extend((re, im))
        if len(cts) % 2:
            out.append(self.bootstrap(cts[-1]))
        return out

    # -- packed sparse batch bootstrap (evaluator.go:880-1065) -------------
    def bootstrap_packed(self, cts: list[Ciphertext],
                         pack_gks: dict | None = None) -> list[Ciphertext]:
        """Refresh k = 2^j sparse ciphertexts through ONE pipeline pass
        (the equal-ring-degree analogue of PackAndSwitchN1ToN2 /
        UnpackAndSwitch, bootstrapping/evaluator.go:880-1065).

        Requirement: each input's payload is k-fold replicated over the
        slots (e.g. ``np.tile(v, k)``), so its plaintext coefficients live
        on multiples of k.  The k inputs are interleaved into one dense
        ciphertext by coefficient packing (ring_packing.pack with the
        garbage positions zeroed), bootstrapped once, and split back by a
        partial expand tree.  ``pack_gks`` must hold the galois keys from
        :func:`galois_elements_for_packed_bootstrap` (defaults to the
        evaluator's key set)."""
        from matrix_fhe_tpu_torch.rlwe import ring_packing as rpk

        k = len(cts)
        log_k = k.bit_length() - 1
        if k < 2 or k != 1 << log_k:
            raise ValueError("bootstrap_packed needs a power-of-two batch >= 2")
        params = self.p.params
        if any(c.level != cts[0].level or c.scale != cts[0].scale for c in cts):
            raise ValueError("inputs must share level and scale")
        gks = pack_gks if pack_gks is not None else self.gks

        packed = rpk.pack(params, {j: c for j, c in enumerate(cts)},
                          input_log_gap=log_k, zero_garbage_slots=True, gks=gks)
        out = self.bootstrap(packed)
        outs = rpk.expand(params, out, log_gap=0, gks=gks, num_stages=log_k)
        return [outs[j] for j in range(k)]

    def bootstrap_sparse(self, cts_small: list[Ciphertext], params_small,
                         evk_up, evk_down, pack_gks: dict | None = None) -> list[Ciphertext]:
        """True PackAndSwitchN1ToN2/UnpackAndSwitch (evaluator.go:880-1065):
        refresh k = N2/N1 ciphertexts living at the SMALLER ring degree N1
        through ONE degree-N2 pipeline pass.

        Each small ciphertext ring-switches up (slot replication + key
        switch, rlwe/ring_switch.py), producing exactly the k-fold
        replicated payload ``bootstrap_packed`` interleaves; then the
        packed bootstrap runs once and each output switches back down to
        N1.  ``evk_up``/``evk_down`` are ring_switch.gen_ring_swap_keys
        between ``params_small`` and this evaluator's parameters (shared
        moduli chain)."""
        from matrix_fhe_tpu_torch.rlwe import ring_switch as rs

        params = self.p.params
        k = params.n // params_small.n
        if len(cts_small) != k:
            raise ValueError(f"need N2/N1 = {k} inputs, got {len(cts_small)}")
        big = [rs.switch_up(params_small, params, c, evk_up) for c in cts_small]
        outs = self.bootstrap_packed(big, pack_gks)
        return [rs.switch_down(params, params_small, o, evk_down) for o in outs]

    # -- iterative META-BTS (evaluator.go:345-493) -------------------------
    def evaluate(self, ct: Ciphertext, iterations: int = 1,
                 reserved_bits: int = 16) -> Ciphertext:
        """Bootstrap with META-BTS precision boosting (evaluator.go:374-487,
        eprint 2022/1167): each extra iteration bootstraps the *amplified*
        residual error e = ct - boot(ct) and folds the correction back in,
        gaining ~``reserved_bits`` bits of precision per round.  Each extra
        iteration consumes one residual level (the reference's reserved
        prime, parameters_literal.go ReservedPrimeBitSize).
        """
        out = self.bootstrap(ct)
        amp = 1 << reserved_bits
        for _ in range(iterations - 1):
            # residual error at the input's level/scale
            err = self.ev.sub(ct, out)
            # amplify the *message* by 2^d: multiply coeffs, keep the scale
            err = self.ev.scale_up(err, amp).with_metadata(scale=err.scale)
            boot_err = self.bootstrap(err)
            # de-amplify in the declared scale, align, and correct
            corr = boot_err.with_metadata(scale=boot_err.scale * amp)
            out = self.ev.add(self.ev.scale_up(out, amp), corr)
            # burn one residual level (the reference's reserved prime) to
            # return to exactly the default scale
            out = self.ev.set_scale(out, self.p.params.default_scale)
        return out


class SecretKeyBootstrapper:
    """Debug stand-in emulating an ideal bootstrap by decrypt-reencode-
    reencrypt with the secret key (sk_bootstrapper.go:11-69) — the
    reference's only 'mock backend', used to prototype circuits that
    interleave bootstraps without paying for the real pipeline."""

    def __init__(self, params, sk, gen: torch.Generator | None = None):
        self.params = params
        self.sk = sk
        self.enc = ckks.Encoder(params)
        self.gen = torch.Generator().manual_seed(0) if gen is None else gen
        self.counter = 0  # sk_bootstrapper.go:23 bootstrap invocation count

    def minimum_input_level(self) -> int:
        return 0

    def output_level(self) -> int:
        return self.params.max_level

    def depth(self) -> int:
        return 0

    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        values = self.enc.decode(decryptor.decrypt(self.params, self.sk, ct))
        pt = self.enc.encode(values, level=self.params.max_level)
        self.counter += 1
        return encryptor.encrypt(self.gen, self.params, self.sk, pt)

    def bootstrap_many(self, cts: list[Ciphertext]) -> list[Ciphertext]:
        return [self.bootstrap(ct) for ct in cts]


# -- curated presets (default_parameters.go:20-195) ---------------------------
# Budget shapes mirroring the reference's default sets (full 128-bit-secure
# N=2^16 chain and smaller dev/test chains); values are this framework's own
# chain layouts, not copies — the reference encodes its chains as explicit
# prime lists, we regenerate from bit budgets.
N16_DENSE = ParametersLiteral(
    log_n=16,
    residual_log_q=(60, 45, 45, 45, 45, 45, 45, 45, 45, 45),
    log_p=(61, 61, 61, 61),
    c2s_log_q=(56, 56, 56, 56),
    s2c_log_q=(45, 45, 45),
    mod1_log_q=60, mod1_k=16, mod1_degree=30, mod1_double_angle=3,
    log_message_ratio=10, log_default_scale=45,
)
N15_TEST = ParametersLiteral(
    log_n=15,
    residual_log_q=(60, 45, 45, 45),
    log_p=(61, 61),
    c2s_log_q=(56, 56, 56),
    s2c_log_q=(45, 45, 45),
    mod1_log_q=60, log_message_ratio=8, log_default_scale=45,
)
N12_TEST = ParametersLiteral(
    log_n=12,
    residual_log_q=(55, 45, 45),
    log_p=(61, 61),
    c2s_log_q=(56, 56, 56),
    s2c_log_q=(45, 45, 45),
    mod1_log_q=60, log_message_ratio=8, log_default_scale=45,
)
DEFAULT_PARAMETERS = {
    "N16_DENSE": N16_DENSE,
    "N15_TEST": N15_TEST,
    "N12_TEST": N12_TEST,
}

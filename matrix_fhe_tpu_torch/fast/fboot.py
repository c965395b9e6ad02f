"""Fast-path CKKS bootstrapping: the full pipeline on int32 kernels.

Counterpart of ``matrix_fhe_tpu/fast/fboot.py``: the fast presets and
``make_fast_bootstrapper`` (int32, B1), and the wide presets and
``make_wide_bootstrapper`` (64-bit words over 41-61-bit primes, B4; at the
end of this module).  The bootstrap circuit (``circuits/ckks/bootstrapping.py``, the reference's
circuits/ckks/bootstrapping/evaluator.go:548-795) programs
against the evaluator interface, so the whole pipeline — ScaleDown, ModUp,
CoeffsToSlots, EvalMod, SlotsToCoeffs, META-BTS — runs on the int32 fast
path by injecting a :class:`fast.feval.FastEvaluator`.

Word-size-reduced chains (SURVEY.md §7.1): every modulus is a <2^23
NTT-friendly prime, so q0 (the bootstrap base modulus) is itself small and
the base precision is bounded by log2(q0 / messageRatio) minus evaluation
noise.  The intended production use is therefore META-BTS iteration
(``Evaluator.evaluate(ct, iterations=k)``, eprint 2022/1167): each cheap
fast-path pass adds ~``reserved_bits`` bits, recovering the precision the
reference gets from a single 60-bit-q0 pass (default_parameters.go:25-40)
at a fraction of the per-pass cost on 32-bit hardware.
"""

from __future__ import annotations

import dataclasses

from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
from matrix_fhe_tpu_torch.circuits.ckks import mod1
from matrix_fhe_tpu_torch.fast import feval, fring
from matrix_fhe_tpu_torch.utils import primes as pr

# re-exported conversion helpers (u64 <-> int32 ciphertexts)
ct_to_fast = feval.ct_to_fast
ct_to_u64 = feval.ct_to_u64


class FastBootstrapEncoder(feval.FastEncoder):
    """FastEncoder + the (u64) embed_qp used for DFT-matrix generation: the
    diagonal plaintexts stay in u64 LinearTransformation form and are
    converted to int32 lazily by FastEvaluator.evaluate_lintrans."""

    def embed_qp(self, values, level_q, level_p=None, scale=None):
        return self._u64.embed_qp(values, level_q, level_p, scale)


def check_fast_chain(params) -> None:
    for q in list(params.q) + list(params.p or ()):
        if q >= fring.MAX_FAST_MODULUS:
            raise ValueError(
                f"modulus {q} >= 2^23: chain is not fast-path compatible "
                f"(use a fast_parameters_literal preset)")


def make_fast_bootstrapper(p: btp.Parameters,
                           evk: btp.EvaluationKeys) -> btp.Evaluator:
    """Bootstrapping evaluator whose pipeline runs on the int32 fast path.

    ``p`` must be built from a fast (all-moduli < 2^23) literal; ``evk`` are
    ordinary u64-path keys (converted once at context build).  Ciphertexts
    in/out are int32 fast-path ciphertexts (convert with ct_to_fast /
    ct_to_u64).  The DFT matrices' int32 forms and the encapsulation keys'
    int32 stacks are made here, so that a bootstrap makes none.
    """
    params = p.params
    check_fast_chain(params)
    fev = feval.make_fast_evaluator(params, evk.rlk, evk.gks)
    fenc = FastBootstrapEncoder(params)
    bts = btp.Evaluator(p, evk, ev=fev, enc=fenc)
    for m in list(bts.c2s_matrix.matrices) + list(bts.s2c_matrix.matrices):
        fev.fast_lintrans(m)
    for e in (evk.evk_dense_to_sparse, evk.evk_sparse_to_dense):
        if e is not None:
            fev._evk32(e, params.max_level)
    return bts


# -- word-size-reduced presets ------------------------------------------------
# Chain layouts mirroring the reference's default sets' *shape*
# (default_parameters.go) under the <2^23 constraint: every logical level is
# one ~22-bit prime; precision is recovered via META-BTS iterations.

def fast_parameters_literal(log_n: int, residual_levels: int = 3,
                            sparse_weight: int = 32) -> btp.ParametersLiteral:
    """A fast-path bootstrapping literal for degree 2^log_n.

    q0 ~ 2^22-2^23, message ratio 2^7 (bottom scale ~2^15), default scale
    2^15, CosDiscrete degree 30 / K=16 with 3 double-angle rounds over a
    sparse-encapsulated secret of weight ``sparse_weight`` (keys.go:400);
    pass sparse_weight=0 for the dense-key path (toy/test sizes only — the
    dense secret's larger ||I(X)|| needs K beyond this preset's budget at
    production degrees).

    Prime availability: NTT-friendly primes < 2^23 come at spacing 2N, so
    the pool thins as the degree grows (at logN=14 there are only ~12
    23-bit and ~9 22-bit candidates).  At logN >= 13 the preset therefore
    splits the chain across the 23/22-bit pools (exact Fraction scale
    tracking absorbs the nonuniform prime sizes); logN >= 15 exceeds the
    total <2^23 pool and needs the wide-modulus path."""
    if log_n >= 13:
        # 23-bit pool (12 downstream at logN=14): q0 + mod1 x depth(8) + c2s x3
        # 22-bit pool (9 at logN=14): residual x3 + s2c x3 + P x3
        if residual_levels > 3:
            raise ValueError("logN>=13 fast preset budgets 3 residual levels")
        q0, mod1_b, c2s_b, other = 23, 23, 23, 22
    else:
        q0, mod1_b, c2s_b, other = 22, 22, 22, 22
    lit = btp.ParametersLiteral(
        log_n=log_n,
        residual_log_q=(q0,) + (other,) * (residual_levels - 1),
        log_p=(other,) * 3,
        log_slots=None,
        c2s_log_q=(c2s_b,) * 3,
        s2c_log_q=(other,) * 3,
        mod1_log_q=mod1_b,
        mod1_type="cos_discrete",
        mod1_k=16,
        mod1_degree=30,
        mod1_double_angle=3,
        log_message_ratio=7,
        log_default_scale=15,
        ephemeral_secret_weight=sparse_weight,
    )
    return _with_fast_moduli(lit)


def _with_fast_moduli(lit: btp.ParametersLiteral) -> btp.ParametersLiteral:
    """Assign explicit <2^23 primes to the literal's chain layout.

    The generic chain generator enumerates primes alternating around 2^bits
    (GenModuli, core/rlwe/params.go:903) — for bits=23 half of those land
    above 2^23 and off the fast path, so the fast presets pick their primes
    downstream-only at 23 bits and alternating below."""
    m1_depth = mod1.ParametersLiteral(
        level_q=0, log_scale=lit.mod1_log_q, mod1_type=lit.mod1_type,
        k=lit.mod1_k, mod1_degree=lit.mod1_degree,
        double_angle=lit.mod1_double_angle,
        mod1_inv_degree=lit.mod1_inv_degree).depth()
    layout = (tuple(lit.residual_log_q) + tuple(lit.s2c_log_q)
              + (lit.mod1_log_q,) * m1_depth + tuple(lit.c2s_log_q))
    sizes: dict[int, int] = {}
    for b in layout + tuple(lit.log_p):
        sizes[b] = sizes.get(b, 0) + 1
    n = 1 << lit.log_n
    pools: dict[int, list[int]] = {}
    for bits, count in sizes.items():
        g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
        out: list[int] = []
        while len(out) < count:
            p = (g.next_downstream_prime() if bits >= 23
                 else g.next_alternating_prime())
            if p < fring.MAX_FAST_MODULUS:
                out.append(p)
        pools[bits] = out
    q = tuple(pools[b].pop(0) for b in layout)
    p = tuple(pools[b].pop(0) for b in lit.log_p)
    return dataclasses.replace(lit, q=q, p=p)


FAST_N14 = fast_parameters_literal(14)


# -- wide-path (41-61-bit) bootstrapping --------------------------------------
# Reference-grade chains (default_parameters.go:25-40 shapes): 45-bit
# default scale and 55-bit q0 / mod1 / C2S moduli, or the reference's true
# widths (60-bit q0 and mod1, 61-bit P, 58-bit C2S).  45-bit primes are
# plentiful at every degree (spacing 2N << 2^45), so these presets reach
# logN 15-16, where the < 2^23 pool runs dry.  The wide path admits moduli
# up to 2^61 + 2^55 (ops/wide.py); the bootstrapping parameters also build
# the u64 rings, which stop at 2^61, and every prime these presets pick at
# logN 6-16 is below it.

def check_wide_chain(params) -> None:
    from matrix_fhe_tpu_torch.ops import wide
    for q in list(params.q) + list(params.p or ()):
        if not wide.MIN_WIDE_MODULUS <= q < wide.MAX_WIDE_MODULUS:
            raise ValueError(
                f"modulus {q} outside [2^41, 2^61 + 2^55): chain is not "
                f"wide-path compatible (use a wide_parameters_literal preset)")


def wide_parameters_literal(log_n: int, residual_levels: int = 3,
                            sparse_weight: int = 32) -> btp.ParametersLiteral:
    """A wide-path bootstrapping literal for degree 2^log_n: 55-bit q0,
    2^45 default scale, message ratio 2^8, CosDiscrete degree 30 / K=16
    with 3 double-angle rounds (default_parameters.go:25-40's shape)."""
    return btp.ParametersLiteral(
        log_n=log_n,
        residual_log_q=(55,) + (45,) * (residual_levels - 1),
        log_p=(55, 55),
        log_slots=None,
        c2s_log_q=(55, 55, 55),
        s2c_log_q=(45, 45, 45),
        mod1_log_q=55,
        mod1_type="cos_discrete",
        mod1_k=16,
        mod1_degree=30,
        mod1_double_angle=3,
        log_message_ratio=8,
        log_default_scale=45,
        ephemeral_secret_weight=sparse_weight,
    )


def wide61_parameters_literal(log_n: int, residual_levels: int = 5,
                              sparse_weight: int = 32,
                              num_p: int = 2) -> btp.ParametersLiteral:
    """The reference's N16QP1547H192H32 widths (default_parameters.go:45-65):
    60-bit q0 + 45-bit residual primes, 58-bit CoeffsToSlots, 42-bit
    SlotsToCoeffs, 60-bit EvalMod, 61-bit P.  ``num_p`` sets the hybrid
    key-switching digit size."""
    return btp.ParametersLiteral(
        log_n=log_n,
        residual_log_q=(60,) + (45,) * (residual_levels - 1),
        log_p=(61,) * num_p,
        log_slots=None,
        c2s_log_q=(58, 58, 58),
        s2c_log_q=(42, 42, 42),
        mod1_log_q=60,
        mod1_type="cos_discrete",
        mod1_k=16,
        mod1_degree=30,
        mod1_double_angle=3,
        log_message_ratio=8,
        log_default_scale=45,
        ephemeral_secret_weight=sparse_weight,
    )


def make_wide_bootstrapper(p: btp.Parameters, evk: btp.EvaluationKeys) -> btp.Evaluator:
    """Bootstrapping evaluator whose pipeline runs on the wide path
    (``fast/weval.py``'s ``WideEvaluator``).  ``evk`` are u64-path keys,
    converted once; ciphertexts in and out hold the u64 path's words
    (``weval.ct_to_wide`` / ``ct_to_u64`` copy them).  The DFT matrices'
    plain-domain forms and the encapsulation keys' are made here, so that a
    bootstrap makes none."""
    from matrix_fhe_tpu_torch.fast import weval
    params = p.params
    check_wide_chain(params)
    wev = weval.make_wide_evaluator(params, evk.rlk, evk.gks)
    bts = btp.Evaluator(p, evk, ev=wev, enc=weval.WideEncoder(params))
    for m in list(bts.c2s_matrix.matrices) + list(bts.s2c_matrix.matrices):
        wev.wide_lintrans(m)
    for e in (evk.evk_dense_to_sparse, evk.evk_sparse_to_dense):
        if e is not None:
            wev._evk_wide(e, params.max_level)
    return bts

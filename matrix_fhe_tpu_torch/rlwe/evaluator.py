"""RLWE evaluator on the u64 path: gadget products, key switching,
automorphisms, trace, on any of the three ring types (the automorphism's
permutation and the trace's Galois elements depend on the type).

Counterpart of ``matrix_fhe_tpu/rlwe/evaluator.py`` (the reference's
core/rlwe/evaluator*.go).  Every step is fully reduced, which is
bit-identical to the reference's lazy windows at op boundaries
(evaluator_gadget_product.go:148-177).  The JAX package's per-level jit
cache is ``_pgraph``: on the card the key switch runs as CUDA graphs, one
for each (name, parameters, level) and input signature, at the JAX
package's four sites (the digit loop of ``decompose_ntt``,
``gadget_product_hoisted`` and both flavours of ``gadget_product``).  Their
bodies stay callable (``decompose_digits``, ``gadget_product_hoisted_body``,
``gadget_product_body``), and within ``utils/graphs.py:eager()`` every call
runs eagerly: the plain form the graphs are held to.
"""

from __future__ import annotations

import collections

import torch

from matrix_fhe_tpu_torch.ops import automorphism as am
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.rlwe.keys import (GadgetCiphertext, GaloisKey,
                                            RelinearizationKey, base_two_counts)
from matrix_fhe_tpu_torch.rlwe.params import Parameters
from matrix_fhe_tpu_torch.utils import graphs

Digits = list[tuple[torch.Tensor, torch.Tensor | None]]

# Per-(params, level) key-switch graphs, the counterpart of the JAX package's
# jit cache (matrix_fhe_tpu/rlwe/evaluator.py:142-164): relinearization,
# rotations and key application all funnel through gadget_product at
# recurring shapes, so one CUDA graph a (name, parameters, level) and input
# signature replaces thousands of small launches from the host.  A bounded
# LRU keyed as the JAX package's; an evicted entry frees its graphs.  Every
# graph captures into graphs.SHARED, one pool and one stream pair a device,
# whose static inputs the graphs share by shape: the whole gadget is an
# input, as in the JAX package, so the graphs of every level read one copy.
_GRAPH_CACHE: collections.OrderedDict = collections.OrderedDict()
_GRAPH_CACHE_MAX = 1024


def _table_counts(params: Parameters) -> tuple:
    """The sizes of the key-switching tables' caches, which a capture must not grow."""
    return len(params._decomposers), len(params._moddown)


def _pgraph(name: str, params: Parameters, level: int, fn):
    """``fn``, a function of tensors, run through the graph cache: the JAX
    package's ``_pjit``, with the same key."""
    ck = (name, params.n, tuple(params.q), tuple(params.p or ()), params.ring_type, level)
    return graphs.cached(_GRAPH_CACHE, _GRAPH_CACHE_MAX, ck, f"key switch {name!r} at level "
                         f"{level}", fn, params.device, caches=lambda: _table_counts(params))


def _gadget_args(gadget: GadgetCiphertext) -> tuple:
    return gadget.q, gadget.p, gadget.base_two


def _gadget(args: tuple) -> GadgetCiphertext:
    q, p, base_two = args
    return GadgetCiphertext(q=q, p=p, base_two=base_two)


def decompose_ntt(params: Parameters, level: int, cx: torch.Tensor,
                  cx_is_ntt: bool = True) -> Digits:
    """DecomposeNTT (evaluator_gadget_product.go:431-452): every RNS digit of
    cx, each in the NTT domain over (Q, P); the hoistable part of rotations."""
    rq = params.ring_q.at_level(level)
    if cx_is_ntt:
        cx_ntt, cx_inv = cx, rq.intt(cx)
    else:
        cx_ntt, cx_inv = rq.ntt(cx), cx
    fn = _pgraph("decompose_ntt", params, level,
                 lambda a, b: decompose_digits(params, level, a, b))
    return fn(cx_ntt, cx_inv)


def decompose_digits(params: Parameters, level: int, cx_ntt: torch.Tensor,
                     cx_inv: torch.Tensor) -> Digits:
    """``decompose_ntt``'s digit loop, the part its graph holds."""
    rq = params.ring_q.at_level(level)
    dec = params.decomposer(level)
    return [rt.decompose_single_ntt(dec, i, cx_ntt, cx_inv, rq, params.ring_p)
            for i in range(params.base_rns_decomposition_vector_size(level))]


def decompose_ntt_base2(params: Parameters, level: int, cx: torch.Tensor,
                        base_two: int, level_p: int, cx_is_ntt: bool = True) -> Digits:
    """Single-P / bit decomposition of cx (gadgetProductSinglePAndBitDecompLazy,
    evaluator_gadget_product.go:190-303): digit (i, j) is the unsigned
    base-2^B digit j of limb i of INTT(cx), reduced onto every (Q, P') limb
    and NTT'd; (i)-major, the layout of the base-two gadget keys."""
    rq = params.ring_q.at_level(level)
    rp = None if level_p < 0 else params.ring_p.at_level(level_p)
    cx_inv = rq.intt(cx) if cx_is_ntt else cx
    mask = (1 << base_two) - 1
    out = []
    for i, count in enumerate(base_two_counts(params.q[: level + 1], base_two)):
        ci = cx_inv[..., i, :]
        for j in range(count):
            cw = ((ci >> (j * base_two)) & mask)[..., None, :]  # < 2^B
            yq = rq.ntt(mm.bred_add(cw, rq.moduli[:, None], rq.bhi[:, None]))
            yp = None
            if rp is not None:
                yp = rp.ntt(mm.bred_add(cw, rp.moduli[:, None], rp.bhi[:, None]))
            out.append((yq, yp))
    return out


def gadget_product_hoisted_lazy(params: Parameters, level: int, digits: Digits,
                                gadget: GadgetCiphertext):
    """<decomp(cx), gadget> over (Q, P'), before ModDown
    (gadgetProductMultiplePLazy, evaluator_gadget_product.go:123-190).
    Returns [d0q, d1q, d0p, d1p]; the p parts are None without auxiliary
    primes.  P' is the gadget's own auxiliary level."""
    rq = params.ring_q.at_level(level)
    rp = None if gadget.p is None else params.ring_p.at_level(gadget.level_p)
    lq = level + 1
    acc = [None, None, None, None]
    for i, (yq, yp) in enumerate(digits):
        gq = gadget.q[i, :, :lq, :]
        prods = [rq.mul_coeffs_montgomery(gq[0], yq), rq.mul_coeffs_montgomery(gq[1], yq)]
        if rp is not None:
            gp = gadget.p[i]
            prods += [rp.mul_coeffs_montgomery(gp[0], yp), rp.mul_coeffs_montgomery(gp[1], yp)]
        else:
            prods += [None, None]
        if i == 0:
            acc = prods
        else:
            acc[0] = rq.add(acc[0], prods[0])
            acc[1] = rq.add(acc[1], prods[1])
            if rp is not None:
                acc[2] = rp.add(acc[2], prods[2])
                acc[3] = rp.add(acc[3], prods[3])
    return acc


def mod_down_qp(params: Parameters, level: int, xq: torch.Tensor,
                xp: torch.Tensor | None) -> torch.Tensor:
    """Divide a (Q, P') element by P' (ModDownQPtoQNTT,
    ring/basis_extension.go:241); P' is read off ``xp``.  xp None: the P-less
    path, where ModDown is the identity (evaluator_gadget_product.go:70)."""
    if params.ring_p is None or xp is None:
        return xq
    lp = int(xp.shape[-2]) - 1
    return rt.mod_down(xq, xp, params.moddown_constants(level, lp),
                       params.ring_q.at_level(level), params.ring_p.at_level(lp),
                       ntt=True)


def gadget_product_hoisted(params: Parameters, level: int, digits: Digits,
                           gadget: GadgetCiphertext) -> tuple[torch.Tensor, torch.Tensor]:
    """<decomp(cx), gadget> over Q after ModDown by P (NTT domain, at
    ``level``; evaluator_gadget_product.go:16-60)."""
    fn = _pgraph("gadget_product_hoisted", params, level,
                 lambda d, g: gadget_product_hoisted_body(params, level, d, _gadget(g)))
    return fn(digits, _gadget_args(gadget))


def gadget_product_hoisted_body(params: Parameters, level: int, digits: Digits,
                                gadget: GadgetCiphertext) -> tuple[torch.Tensor, torch.Tensor]:
    """``gadget_product_hoisted``'s body, the part its graph holds."""
    acc = gadget_product_hoisted_lazy(params, level, digits, gadget)
    return mod_down_qp(params, level, acc[0], acc[2]), mod_down_qp(params, level, acc[1], acc[3])


def gadget_product(params: Parameters, level: int, cx: torch.Tensor,
                   gadget: GadgetCiphertext) -> tuple[torch.Tensor, torch.Tensor]:
    """GadgetProduct (evaluator_gadget_product.go:16-30) of an NTT-domain cx,
    for either gadget flavour: RNS digits, or single-P base 2^B (:190-325),
    each one graph a level (the flavour's base and P level in its name)."""
    name = (f"gadget_product_b2_{gadget.base_two}_{gadget.level_p}" if gadget.base_two > 0
            else "gadget_product")
    fn = _pgraph(name, params, level,
                 lambda c, g: gadget_product_body(params, level, c, _gadget(g)))
    return fn(cx, _gadget_args(gadget))


def gadget_product_body(params: Parameters, level: int, cx: torch.Tensor,
                        gadget: GadgetCiphertext) -> tuple[torch.Tensor, torch.Tensor]:
    """``gadget_product``'s body, the part its graph holds: the
    decomposition and the hoisted product (in the RNS flavour through their
    own cache entries, inlined as the JAX package's nested jits are; call it
    within ``graphs.eager()`` to run it eagerly)."""
    if gadget.base_two > 0:
        digits = decompose_ntt_base2(params, level, cx, gadget.base_two, gadget.level_p)
        return gadget_product_hoisted_body(params, level, digits, gadget)
    return gadget_product_hoisted(params, level, decompose_ntt(params, level, cx), gadget)


def apply_evaluation_key(params: Parameters, ct: Ciphertext, evk) -> Ciphertext:
    """ApplyEvaluationKey (evaluator_evaluationkey.go:37): re-encrypt a
    degree-1 ciphertext from skIn to skOut."""
    rq = params.ring_q.at_level(ct.level)
    d0, d1 = gadget_product(params, ct.level, ct.value[1], evk.gadget)
    return ct.with_value((rq.add(d0, ct.value[0]), d1))


def relinearize(params: Parameters, ct: Ciphertext, rlk: RelinearizationKey) -> Ciphertext:
    """Degree 2 -> degree 1 (evaluator_evaluationkey.go:128-153)."""
    if ct.degree != 2:
        raise ValueError("relinearize expects a degree-2 ciphertext")
    rq = params.ring_q.at_level(ct.level)
    d0, d1 = gadget_product(params, ct.level, ct.value[2], rlk.gadget)
    return ct.with_value((rq.add(ct.value[0], d0), rq.add(ct.value[1], d1)))


def automorphism(params: Parameters, ct: Ciphertext, gk: GaloisKey) -> Ciphertext:
    """X^i -> X^{i galEl} (evaluator_automorphism.go:14-60): gadget product
    of c1 with the Galois key, add c0, then permute both parts."""
    if ct.degree != 1:
        raise ValueError("automorphism expects a degree-1 ciphertext")
    if gk.gal_el == 1:
        return ct
    rq = params.ring_q.at_level(ct.level)
    d0, d1 = gadget_product(params, ct.level, ct.value[1], gk.gadget)
    d0 = rq.add(d0, ct.value[0])
    perm = am.automorphism_ntt if ct.metadata.is_ntt else am.automorphism_coeff
    return ct.with_value((perm(rq, d0, gk.gal_el), perm(rq, d1, gk.gal_el)))


def p_scalar_mform(params: Parameters, level: int) -> list[int]:
    """MForm(P mod q_i) per Q-limb, the P-scaling of c0 in the lazy hoisted
    paths (MulScalarBigint with ringP.ModulusAtLevel)."""
    big_p = params.big_p()
    return [(big_p << 64) % q for q in params.q[:level + 1]]


def automorphism_hoisted_lazy(params: Parameters, ct: Ciphertext, digits: Digits,
                              gk: GaloisKey):
    """AutomorphismHoistedLazy (evaluator_automorphism.go:107-160): the
    rotated ciphertext mod (Q, P), scaled by P: (phi(P c0 + d0), phi(d1)),
    (d0, d1) the lazy gadget product of c1."""
    rq = params.ring_q.at_level(ct.level)
    rp = params.ring_p
    d0q, d1q, d0p, d1p = gadget_product_hoisted_lazy(params, ct.level, digits, gk.gadget)
    if rp is not None:
        d0q = rq.add(d0q, rq.mul_scalar_montgomery(ct.value[0], p_scalar_mform(params, ct.level)))
    else:
        d0q = rq.add(d0q, ct.value[0])
    out = []
    for xq, xp in ((d0q, d0p), (d1q, d1p)):
        xq = am.automorphism_ntt(rq, xq, gk.gal_el)
        if rp is not None:
            xp = am.automorphism_ntt(rp, xp, gk.gal_el)
        out.append((xq, xp))
    return out


def automorphism_hoisted(params: Parameters, ct: Ciphertext, digits: Digits,
                         gk: GaloisKey) -> Ciphertext:
    """AutomorphismHoisted (evaluator_automorphism.go:62-105): a precomputed
    decomposition of c1 reused across many rotations."""
    rq = params.ring_q.at_level(ct.level)
    d0, d1 = gadget_product_hoisted(params, ct.level, digits, gk.gadget)
    d0 = rq.add(d0, ct.value[0])
    return ct.with_value((am.automorphism_ntt(rq, d0, gk.gal_el),
                          am.automorphism_ntt(rq, d1, gk.gal_el)))


def trace(params: Parameters, ct: Ciphertext, log_n: int,
          gks: dict[int, GaloisKey]) -> Ciphertext:
    """Trace (core/rlwe/inner_sum.go:36-124): projection onto the subring of
    degree 2^log_n, pre-multiplied by (N/n)^-1 so the surviving coefficients
    keep their value."""
    if ct.degree != 1:
        raise ValueError("trace expects a degree-1 ciphertext")
    level = ct.level
    rq = params.ring_q.at_level(level)
    gap = 1 << (params.log_n - log_n - 1)
    if log_n == 0:
        gap <<= 1
    if params.ring_type == "conjugate_invariant":
        gap >>= 1
    if gap <= 1:
        return ct
    n_inv = pow(gap, -1, rq.modulus_at_level(level))
    sc = [(n_inv % q) * (1 << 64) % q for q in rq.moduli_tuple]
    out = ct.with_value(tuple(rq.mul_scalar_montgomery(v, sc) for v in ct.value))
    if not ct.metadata.is_ntt:
        out = out.with_value(tuple(rq.ntt(v) for v in out.value)).with_metadata(is_ntt=True)

    def fold(out, gal_el):
        rot = automorphism(params, out, gks[gal_el])
        return out.with_value((rq.add(out.value[0], rot.value[0]),
                               rq.add(out.value[1], rot.value[1])))

    for gal_el in galois_elements_for_trace(params, log_n):
        out = fold(out, gal_el)
    if not ct.metadata.is_ntt:
        out = out.with_value(tuple(rq.intt(v) for v in out.value)).with_metadata(is_ntt=False)
    return out


def galois_elements_for_trace(params: Parameters, log_n: int) -> list[int]:
    """GaloisElementsForTrace (inner_sum.go:125-151)."""
    els = [params.galois_element(1 << i) for i in range(log_n, params.log_n - 1)]
    if log_n == 0 and params.ring_type == "standard":
        els.append(params.nth_root - 1)
    return els

"""PyTorch port, the key-switch graph caches held against the JAX package's
jit caches on the CPU: ``rlwe/evaluator.py:_GRAPH_CACHE`` against
``matrix_fhe_tpu/rlwe/evaluator.py:_JIT_CACHE`` and
``rlwe/keys.py:_EVK_GRAPH_CACHE`` against ``_EVK_JIT_CACHE``.

One sequence runs through both packages: relinearizations at three levels,
rotations by two Galois keys, a hoisted rotation, a base-two key switch and
relinearization keygens on four parameter sets (one twice).  After each
step the port's cache keys (an entry holds one graph a signature; the keys
leave the signature out) equal JAX's in the same LRU order.  The sequence
runs with both caches unbounded, where each output must equal JAX's, and
with both bounds set to 3, where the evictions must match.  The JAX
package looks its caches up while it traces, so where only the keys are
compared its side runs under ``jax.eval_shape`` (traced, not compiled).
The inputs are residues made with numpy from a seed.  On the CPU an
entry's call is the eager body, so the keys and the order are the cache's
own; the card's graphs are held to the eager bodies by
``tests/test_torch_graph_cache_cuda.py`` and ``chip_smoke.py`` phase 29.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu import rlwe as jrlwe
from matrix_fhe_tpu.rlwe import evaluator as jev
from matrix_fhe_tpu.rlwe import keys as JK
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.rlwe import evaluator as tev
from matrix_fhe_tpu_torch.rlwe import keys as TK
from test_torch_rlwe import eq, jax_evk_samples

LITERALS = {"A": dict(logn=4, logq=(45, 40, 40), logp=(50, 50)),
            "B": dict(logn=4, logq=(45, 40), logp=(50, 50)),
            "C": dict(logn=4, logq=(45, 40, 40)),
            "D": dict(logn=5, logq=(45, 40, 40), logp=(50, 50))}
GALOIS = (5, 25)      # galois_element(1), galois_element(2)
BASE_TWO = 30         # a P-less base-two gadget: two digits a limb


def _residues(rng, shape, moduli) -> np.ndarray:
    """uint64 words below each limb's modulus (the second axis from the end)."""
    m = np.array(moduli, dtype=np.uint64)[:, None]
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64) % m


def _gadget(rng, params, rows, base_two=0):
    p = None if base_two else _residues(rng, (rows, 2, len(params.p), params.n), params.p)
    return JK.GadgetCiphertext(q=_residues(rng, (rows, 2, len(params.q), params.n), params.q),
                               p=p, base_two=base_two)


@pytest.fixture(scope="module")
def sessions():
    """Each parameter set's JAX parameters and a secret key (words below
    each modulus, any key to the key switch and keygen), carried to the
    port; for A also a ciphertext, two Galois keys and a base-two key."""
    rng = np.random.default_rng(17)
    out = {}
    for i, (name, lit) in enumerate(LITERALS.items()):
        jp = jrlwe.new_parameters(jrlwe.ParametersLiteral(**lit))
        q = _residues(rng, (len(jp.q), jp.n), jp.q)
        sk = JK.SecretKey(value=JK.QPPoly(
            q=q, p=_residues(rng, (len(jp.p), jp.n), jp.p) if jp.p else None))
        s = dict(jp=jp, tp=carry.carry(jp, "cpu"), sk=sk, tsk=carry.carry(sk, "cpu"),
                 kr=jax.random.key(i), rows=-(-len(jp.q) // max(len(jp.p), 1)))
        if name == "A":
            ct = jrlwe.Ciphertext(value=tuple(_residues(rng, (len(jp.q), jp.n), jp.q)
                                              for _ in range(2)))
            gks = {g: JK.GaloisKey(gadget=_gadget(rng, jp, s["rows"]), gal_el=g)
                   for g in GALOIS}
            rows2 = sum(JK.base_two_counts(jp.q, BASE_TWO))
            b2 = JK.EvaluationKey(gadget=_gadget(rng, jp, rows2, BASE_TWO))
            s.update(ct=ct, gks=gks, b2=b2, tct=carry.carry(ct, "cpu"),
                     tgks=carry.carry(gks, "cpu"), tb2=carry.carry(b2, "cpu"))
        out[name] = s
    return out


def _at(ct, level, degree2=False):
    """``ct`` (either package's) cut to ``level``, made degree 2 by repeating c1."""
    v = tuple(x[: level + 1] for x in ct.value)
    return ct.with_value(v + (v[1],) if degree2 else v)


def _steps(s: dict) -> list:
    """(step, JAX call, port call, compare the outputs?) in the sequence's
    order.  Only keygen A's output is compared: the other keygens are
    there to fill the keygen cache, on keys the port draws itself."""
    a = s["A"]
    jp, tp, g0, g1 = a["jp"], a["tp"], *GALOIS
    out = []
    for level in (2, 1, 0):
        out.append((f"relinearize at level {level}",
                    lambda lv=level: jev.relinearize(jp, _at(a["ct"], lv, True),
                                                     JK.RelinearizationKey(a["gks"][g0].gadget)),
                    lambda lv=level: tev.relinearize(tp, _at(a["tct"], lv, True),
                                                     TK.RelinearizationKey(a["tgks"][g0].gadget)),
                    True))
    for g in (g0, g1):
        out.append((f"rotation by galois element {g}",
                    lambda g=g: jev.automorphism(jp, a["ct"], a["gks"][g]),
                    lambda g=g: tev.automorphism(tp, a["tct"], a["tgks"][g]), True))

    def hoisted(ev, params, ct, gk):
        return ev.automorphism_hoisted(params, ct, ev.decompose_ntt(params, ct.level,
                                                                    ct.value[1]), gk)
    out.append(("hoisted rotation", lambda: hoisted(jev, jp, a["ct"], a["gks"][g1]),
                lambda: hoisted(tev, tp, a["tct"], a["tgks"][g1]), True))
    out.append(("base-two key switch",
                lambda: jev.apply_evaluation_key(jp, a["ct"], a["b2"]),
                lambda: tev.apply_evaluation_key(tp, a["tct"], a["tb2"]), True))
    for name in ("A", "B", "A", "C", "D"):
        p = s[name]
        if name == "A":
            def port(p=p):
                return TK.relinearization_key_from_samples(
                    p["tp"], p["tsk"], jax_evk_samples(p["kr"], p["jp"], p["rows"]))
        else:
            def port(p=p):
                return TK.gen_relinearization_key(torch.Generator().manual_seed(1), p["tp"],
                                                  p["tsk"])
        out.append((f"relinearization keygen on {name}",
                    lambda p=p: JK.gen_relinearization_key(p["kr"], p["jp"], p["sk"]), port,
                    name == "A"))
    return out


def _key(k) -> tuple:
    """A cache key with the distributions by their fields (each package has
    its own sampler classes)."""
    return tuple((type(x).__name__, dataclasses.astuple(x)) if dataclasses.is_dataclass(x)
                 else x for x in k)


@pytest.mark.parametrize("bound", [None, 3])
def test_graph_caches_follow_the_jit_caches(sessions, monkeypatch, bound):
    """After every step the port's cache keys equal the JAX package's, in
    the same LRU order; with the packages' own bounds (1024 and 32) the
    outputs are equal too, with both bounds at 3 the caches evict alike."""
    for mod, name in ((jev, "_JIT_CACHE"), (JK, "_EVK_JIT_CACHE"), (tev, "_GRAPH_CACHE"),
                      (TK, "_EVK_GRAPH_CACHE")):
        monkeypatch.setattr(mod, name, collections.OrderedDict())
    if bound is not None:
        for mod, name in ((jev, "_JIT_CACHE_MAX"), (JK, "_EVK_JIT_CACHE_MAX"),
                          (tev, "_GRAPH_CACHE_MAX"), (TK, "_EVK_GRAPH_CACHE_MAX")):
            monkeypatch.setattr(mod, name, bound)
    evicted = set()
    for step, jax_call, port_call, compare in _steps(sessions):
        before = set(tev._GRAPH_CACHE) | set(TK._EVK_GRAPH_CACHE)
        got = port_call()
        if bound is None and compare:
            eq(got, jax_call())
        else:
            jax.eval_shape(jax_call)
        for jcache, tcache in ((jev._JIT_CACHE, tev._GRAPH_CACHE),
                               (JK._EVK_JIT_CACHE, TK._EVK_GRAPH_CACHE)):
            assert [_key(k) for k in tcache] == [_key(k) for k in jcache], step
        evicted |= before - set(tev._GRAPH_CACHE) - set(TK._EVK_GRAPH_CACHE)
    names = {k[0] for k in tev._GRAPH_CACHE}
    if bound is None:
        # the key switch at three levels, the hoisted pair, the base-two flavour
        assert not evicted and len(tev._GRAPH_CACHE) == 10 and names == {
            "gadget_product", "decompose_ntt", "gadget_product_hoisted",
            f"gadget_product_b2_{BASE_TWO}_-1"}
        assert len(TK._EVK_GRAPH_CACHE) == 4
    else:
        assert len(tev._GRAPH_CACHE) == len(TK._EVK_GRAPH_CACHE) == 3
        # both caches evicted: the keygen's B, and key switches at every level
        assert {k[-1] for k in evicted if len(k) == 6 and isinstance(k[0], str)} == {0, 1, 2}
        assert any(k[3] == "standard" and len(k[1]) == 2 for k in evicted if isinstance(k[0], int))

"""PyTorch port, the key-switch graph caches on the card (rlwe/evaluator.py
``_pgraph``, rlwe/keys.py ``_EVK_GRAPH_CACHE``, on utils/graphs.py): each
graph held bit for bit to its eager body (the same call within
``graphs.eager()``), for each gadget flavour on each ring type, through a
second call, a dropped constant cache, an eviction, an outer capture and a
body that cannot be captured.

The inputs are residues drawn with a seeded CPU generator: a key switch
reads keys and ciphertexts as words, whatever secret they belong to.
Without a GPU every test here skips; on a machine with a card and no jax
it runs on its own:

    python -m pytest tests/test_torch_graph_cache_cuda.py -q -p no:cacheprovider \\
        --noconftest -o addopts=""
"""

import collections
import types

import pytest
import torch

from matrix_fhe_tpu_torch import rlwe
from matrix_fhe_tpu_torch.circuits.ckks import staged
from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda
from matrix_fhe_tpu_torch.ops import rns_tools as rt
from matrix_fhe_tpu_torch.rlwe import evaluator as tev
from matrix_fhe_tpu_torch.rlwe import keys as TK
from matrix_fhe_tpu_torch.utils import device, graphs, launches

RINGS = {
    "standard": lambda p: rlwe.ParametersLiteral(logn=10, logq=(45, 40, 40), logp=p),
    "ci": lambda p: rlwe.ParametersLiteral(logn=10, logq=(45, 40, 40), logp=p,
                                           ring_type="conjugate_invariant"),
    "3n": lambda p: rlwe.Parameters3NLiteral(order2=9, order3=1, logq=(45, 40, 40), logp=p),
}
# (P bit sizes, base two, P level of the gadget)
FLAVOURS = {"rns": ((50, 50), 0, 1), "p-less": (None, 0, -1),
            "base two, level_p 0": ((50, 50), 30, 0), "base two, level_p -1": ((50,), 30, -1)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Each test on caches of its own."""
    monkeypatch.setattr(tev, "_GRAPH_CACHE", collections.OrderedDict())
    monkeypatch.setattr(TK, "_EVK_GRAPH_CACHE", collections.OrderedDict())


def _params(ring: str, logp, dev):
    lit = RINGS[ring](logp)
    if ring == "3n":
        return rlwe.new_parameters_3n(lit, device=dev)
    return rlwe.new_parameters(lit, device=dev)


def _residues(gen, shape, moduli, dev) -> torch.Tensor:
    m = torch.tensor(moduli, dtype=torch.int64)[:, None]
    return (torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64) % m).to(dev)


def _gadget(gen, params, base_two: int, level_p: int, dev) -> TK.GadgetCiphertext:
    """Words of a gadget of the flavour's shape over the whole chain."""
    n, q = params.n, params.q
    if base_two:
        rows = sum(TK.base_two_counts(q, base_two))
    else:
        rows = -(-len(q) // max(level_p + 1, 1))
    p = None if level_p < 0 else _residues(gen, (rows, 2, level_p + 1, n),
                                            params.p[: level_p + 1], dev)
    return TK.GadgetCiphertext(q=_residues(gen, (rows, 2, len(q), n), q, dev), p=p,
                               base_two=base_two)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.is_cuda and torch.equal(a, b)


def _graphs() -> int:
    return sum(len(g.entries) for g in tev._GRAPH_CACHE.values())


def _b4_b5() -> dict:
    return {"fwd": ntt64_cuda.fwd_launches + ntt64_cuda.ci_fwd_launches + ntt3n_cuda.fwd_launches,
            "bwd": ntt64_cuda.bwd_launches + ntt64_cuda.ci_bwd_launches + ntt3n_cuda.bwd_launches}


def _zero_counts() -> None:
    for m in (ntt64_cuda, ntt3n_cuda):
        m.fwd_launches = m.bwd_launches = 0
    ntt64_cuda.ci_fwd_launches = ntt64_cuda.ci_bwd_launches = 0


def _node_counts(graph) -> dict:
    names = launches.graph_nodes(graph)
    return {d: sum(f"{d}_kernel" in k and ("ntt64" in k or "ntt3n" in k) for k in names)
            for d in ("fwd", "bwd")}


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("ring", list(RINGS))
def test_graph_equals_eager(ring, flavour):
    """gadget_product at two levels (and, for the RNS gadgets, the hoisted
    pair decompose_ntt + gadget_product_hoisted) equals its eager body, bit
    for bit; a second call with other inputs and another key of the same
    shape replays the same graphs."""
    dev = _cuda()
    logp, base_two, level_p = FLAVOURS[flavour]
    params = _params(ring, logp, dev)
    gen = torch.Generator().manual_seed(10 * list(RINGS).index(ring)
                                        + list(FLAVOURS).index(flavour))
    for call in range(2):
        gadget = _gadget(gen, params, base_two, level_p, dev)
        for level in (params.max_level, params.max_level - 1):
            cx = _residues(gen, (level + 1, params.n), params.q[: level + 1], dev)
            got = tev.gadget_product(params, level, cx, gadget)
            with graphs.eager():
                want = tev.gadget_product(params, level, cx, gadget)
            assert _same(got, want), (ring, flavour, call, level)
            if base_two == 0:
                digits = tev.decompose_ntt(params, level, cx)
                hoisted = tev.gadget_product_hoisted(params, level, digits, gadget)
                with graphs.eager():
                    want_d = tev.decompose_ntt(params, level, cx)
                    want_h = tev.gadget_product_hoisted(params, level, want_d, gadget)
                assert _same(digits, want_d) and _same(hoisted, want_h), (ring, flavour, level)
                assert _same(hoisted, got)  # the hoisted pair is the key switch
        if call == 0:
            n_graphs = _graphs()
    # one graph an entry, and the second call captured nothing new
    assert _graphs() == n_graphs == len(tev._GRAPH_CACHE) == (2 if base_two else 6)


@pytest.mark.parametrize("ring", ["standard", "ci", "3n"])
def test_launches_counted_where_they_run(ring):
    """A capture adds nothing to the wrappers' counts; each replay counts
    the launches its capture recorded into the replays() windows open: a
    first call counts the warm-up's launches and the replay's, a second
    call only the replay's, each the eager call's launches."""
    dev = _cuda()
    params = _params(ring, (50, 50), dev)
    gen = torch.Generator().manual_seed(17)
    gadget = _gadget(gen, params, 0, 1, dev)
    cx = _residues(gen, (3, params.n), params.q, dev)
    names = [f"{m.__name__}.{e}" for m, es in ((ntt64_cuda, ("ntt_fwd", "ntt_ci_fwd")),
                                               (ntt3n_cuda, ("ntt_fwd",))) for e in es]
    names_bwd = [n.replace("fwd", "bwd") for n in names]

    def replayed(w) -> dict:
        return {"fwd": sum(w.count(n) for n in names), "bwd": sum(w.count(n) for n in names_bwd)}

    with graphs.eager():
        _zero_counts()
        tev.gadget_product(params, 2, cx, gadget)
        eager = _b4_b5()
    assert eager["fwd"] > 0 and eager["bwd"] > 0
    for call in range(2):
        _zero_counts()
        with graphs.replays() as w:
            tev.gadget_product(params, 2, cx, gadget)
        assert _b4_b5() == (eager if call == 0 else {"fwd": 0, "bwd": 0}), call
        assert replayed(w) == eager, call


def test_gadget_read_from_one_static_copy():
    """The graphs of every level (and of the hoisted product) read the
    gadget from one static buffer: the whole gadget is their input."""
    dev = _cuda()
    params = _params("standard", (50, 50), dev)
    gen = torch.Generator().manual_seed(19)
    gadget = _gadget(gen, params, 0, 1, dev)
    for level in (2, 1):
        cx = _residues(gen, (level + 1, params.n), params.q[: level + 1], dev)
        tev.gadget_product_hoisted(params, level, tev.decompose_ntt(params, level, cx), gadget)
        tev.gadget_product(params, level, cx, gadget)
    gadget_graphs = [g for k, f in tev._GRAPH_CACHE.items() if k[0] != "decompose_ntt"
                     for g in f.entries.values()]
    assert len(gadget_graphs) == 4
    buffers = {t.data_ptr() for g in gadget_graphs for t in g.inputs
               if tuple(t.shape) == tuple(gadget.q.shape)}
    assert len(buffers) == 1


@pytest.mark.parametrize("logp", [(50, 50), None])
def test_keygen_graph_equals_eager(logp):
    """A relinearization and a Galois key: the keygen graph equals the
    eager body; the base-two key stays eager (no cache entry)."""
    dev = _cuda()
    params = _params("standard", logp, dev)
    gen = torch.Generator().manual_seed(5)
    sk = TK.gen_secret_key(gen, params)
    for make in (lambda s: TK.relinearization_key_from_samples(params, sk, s),
                 lambda s: TK.galois_key_from_samples(params, sk, 5, s)):
        samples = TK.sample_evaluation_key(gen, params)
        got = make(samples)
        with graphs.eager():
            want = make(samples)
        assert _same((got.gadget.q, got.gadget.p), (want.gadget.q, want.gadget.p))
    entry = next(iter(TK._EVK_GRAPH_CACHE.values()))
    assert len(TK._EVK_GRAPH_CACHE) == 1 and len(entry.entries) == 1
    if logp is not None:
        evkp = TK.EvaluationKeyParameters(level_p=0, base_two_decomposition=30)
        TK.gen_evaluation_key(gen, params, sk.value.q, sk, evkp)
        assert len(TK._EVK_GRAPH_CACHE) == 1


def test_replay_after_constants_dropped():
    """A captured key switch keeps every device constant it read: after the
    shared cache is cleared and its memory written over, a replay still
    equals the eager body."""
    dev = _cuda()
    params = _params("standard", (50, 50), dev)
    gen = torch.Generator().manual_seed(7)
    gadget = _gadget(gen, params, 0, 1, dev)
    cx = _residues(gen, (3, params.n), params.q, dev)
    first = tev.gadget_product(params, 2, cx, gadget)
    device.clear_constants()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((n,), -1, dtype=torch.int64, device=dev)
            for n in (1, 3, 8, 64, 512, 4096) for _ in range(1000)]
    torch.cuda.synchronize()
    got = tev.gadget_product(params, 2, cx, gadget)
    with graphs.eager():
        want = tev.gadget_product(params, 2, cx, gadget)
    assert _same(got, first) and _same(got, want)
    del junk


def test_eviction_then_recapture(monkeypatch):
    """With room for two entries, a third evicts the least recently used
    and frees its graph; asked again, it is captured anew and still equals
    the eager body."""
    dev = _cuda()
    monkeypatch.setattr(tev, "_GRAPH_CACHE_MAX", 2)
    params = _params("standard", (50,), dev)
    gen = torch.Generator().manual_seed(9)
    gadget = _gadget(gen, params, 30, -1, dev)   # one entry a call: no nested lookups
    cxs = {lv: _residues(gen, (lv + 1, params.n), params.q[: lv + 1], dev) for lv in (2, 1, 0)}
    tev.gadget_product(params, 2, cxs[2], gadget)
    first = next(iter(tev._GRAPH_CACHE.values()))
    assert len(first.entries) == 1
    tev.gadget_product(params, 1, cxs[1], gadget)
    tev.gadget_product(params, 0, cxs[0], gadget)
    assert [k[-1] for k in tev._GRAPH_CACHE] == [1, 0] and not first.entries  # freed
    got = tev.gadget_product(params, 2, cxs[2], gadget)
    with graphs.eager():
        want = tev.gadget_product(params, 2, cxs[2], gadget)
    assert _same(got, want) and [k[-1] for k in tev._GRAPH_CACHE] == [0, 2]
    assert _graphs() == 2


@pytest.mark.parametrize("ring", ["standard", "3n"])
def test_nested_in_an_outer_capture(ring):
    """A key switch called inside a graph_ciphertext_fn capture (and inside
    a capture of its own making) runs its body inline: the outer graph's
    B4 / B5 kernel nodes equal the eager body's launches, and the cache
    holds no graph of its own for it."""
    dev = _cuda()
    params = _params(ring, (50, 50), dev)
    gen = torch.Generator().manual_seed(11)
    evk = TK.EvaluationKey(gadget=_gadget(gen, params, 0, 1, dev))
    ct = rlwe.Ciphertext(value=tuple(_residues(gen, (3, params.n), params.q, dev)
                                     for _ in range(2)))

    def fn(c):
        return tev.apply_evaluation_key(params, c, evk)

    with graphs.eager():
        _zero_counts()
        want = fn(ct)
        eager = _b4_b5()
    assert eager["fwd"] > 0 and eager["bwd"] > 0
    g = staged.graph_ciphertext_fn(types.SimpleNamespace(), params, fn, name="outer")
    got = g(ct)
    assert _same(got.value, want.value)
    assert _node_counts(next(iter(g.entries.values())).graph) == eager
    assert len(tev._GRAPH_CACHE) == 3 and _graphs() == 0  # looked up in the warm-up, inlined
    # a capture not made by utils/graphs.py
    raw = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(raw):
        fn(ct)
    assert _node_counts(raw) == eager and _graphs() == 0
    raw.reset()


def test_body_that_synchronises_raises(monkeypatch):
    """A key switch that reads the device from the host cannot be captured:
    it raises with its name, after one eager warm-up, and runs no eager
    call in the graph's place; the card works on after it."""
    dev = _cuda()
    params = _params("standard", (50, 50), dev)
    gen = torch.Generator().manual_seed(13)
    cx = _residues(gen, (3, params.n), params.q, dev)
    real, calls = rt.decompose_single_ntt, []

    def syncing(*args):
        calls.append(int(args[2][0, 0]))   # a device -> host read
        return real(*args)

    monkeypatch.setattr(rt, "decompose_single_ntt", syncing)
    with pytest.raises(RuntimeError, match="'decompose_ntt' at level 2"):
        tev.decompose_ntt(params, 2, cx)
    assert len(calls) == 2 and _graphs() == 0   # the warm-up's two digits
    monkeypatch.setattr(rt, "decompose_single_ntt", real)
    torch.cuda.synchronize()
    got = tev.decompose_ntt(params, 2, cx)
    with graphs.eager():
        want = tev.decompose_ntt(params, 2, cx)
    assert _same(got, want) and _graphs() == 1

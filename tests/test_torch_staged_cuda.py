"""PyTorch port, the staged bootstrap (circuits/ckks/staged.py) on the card:
each stage captured into a CUDA graph and replayed.

The session is tests/test_fboot.py's bootstrap (the fast chain at logN 6,
the JAX package's keys and ciphertext), read from
tests/data/fboot_logn6_jax.mft.gz (tools/port_staged_fixture.py), since
this file imports no jax.  Without a GPU every test here skips; on a
machine with a card and no jax it runs on its own:

    python -m pytest tests/test_torch_staged_cuda.py -q -p no:cacheprovider \\
        --noconftest -o addopts=""
"""

import gzip
import hashlib
import io
import pathlib
from fractions import Fraction
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from matrix_fhe_tpu_torch.circuits.ckks import bootstrapping as btp
from matrix_fhe_tpu_torch.circuits.ckks import staged
from matrix_fhe_tpu_torch.fast import fboot, feval
from matrix_fhe_tpu_torch.ops import ntt_cuda
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.utils import device, launches, serialization

FIXTURE = pathlib.Path(__file__).parent / "data" / "fboot_logn6_jax.mft.gz"
# tests/test_fboot.py:U64_BOOT_DIGEST (that module imports jax)
U64_BOOT_DIGEST = "be5e856029eda8d9408dc84fe8be024e9afcd67dcbc1ba69b493edaeb2d79ece"


@pytest.fixture(scope="module")
def session():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a GPU")
    dev = torch.device("cuda")
    r = io.BytesIO(gzip.decompress(FIXTURE.read_bytes()))
    rlk, ct = serialization.load(r, dev), serialization.load(r, dev)
    gks = {}
    while r.tell() < len(r.getbuffer()):
        gk = serialization.load(r, dev)
        gks[gk.gal_el] = gk
    p = btp.Parameters(fboot.fast_parameters_literal(6, residual_levels=2, sparse_weight=0),
                       device=dev)
    evk = btp.EvaluationKeys(rlk=rlk, gks=gks)
    assert isinstance(rlk, K.RelinearizationKey) and sorted(gks) == sorted(p.galois_elements())
    return SimpleNamespace(p=p, evk=evk, ct=ct, fast=fboot.make_fast_bootstrapper(p, evk))


def _u64_digest(ct) -> str:
    h = hashlib.sha256()
    for v in ct.value:
        h.update(v.long().cpu().numpy().astype("<u8").tobytes())
    return h.hexdigest()


def _same(a, b) -> bool:
    return a.metadata == b.metadata and len(a.value) == len(b.value) and all(
        torch.equal(x, y) for x, y in zip(a.value, b.value))


def test_u64_staged_digest(session):
    """The u64 evaluator's bootstrap, staged on the card: the JAX package's
    u64 pipeline's limbs."""
    s = session
    st = staged.StagedBootstrapper(btp.Evaluator(s.p, s.evk))
    out = st(s.ct)
    assert out.level == s.p.residual_level and out.scale == s.p.params.default_scale
    assert _u64_digest(out) == U64_BOOT_DIGEST
    assert all(len(g.entries) == 1 for g in st.graphs)  # one signature a stage
    assert len(st.graphs) == 11  # head, 3 + 3 matrices, the tail, evalmod x 2, s2c head


def test_fast_staged_digest_and_kernel_nodes(session):
    """The fast bootstrap, staged: the same limbs, twice; its graphs hold
    B1 as often as the eager bootstrap launches it."""
    s = session
    ct = feval.ct_to_fast(s.ct)
    ntt_cuda.fwd_launches = ntt_cuda.bwd_launches = 0
    eager = s.fast.bootstrap(ct)
    counts = {"fwd": ntt_cuda.fwd_launches, "bwd": ntt_cuda.bwd_launches}
    st = staged.StagedBootstrapper(s.fast)
    for _ in range(2):
        out = st(ct)
        assert _same(out, eager) and _u64_digest(out) == U64_BOOT_DIGEST
    nodes = chip_smoke.graph_counts(st)  # each graph as often as a bootstrap replays it
    assert nodes["B1"] == counts and counts["fwd"] > 0, (nodes, counts)
    assert nodes["B4"] == {"fwd": 0, "bwd": 0} and nodes["replays"] == 11, nodes


def test_one_graph_a_signature(session):
    """A new level or scale captures a new graph; the same one replays."""
    ev = session.fast.ev
    g = staged.graph_ciphertext_fn(ev, session.p.params, lambda c: ev.add(c, c), name="add")
    ct = feval.ct_to_fast(session.ct)  # at level 1
    g(ct)
    g(ct)
    assert len(g.entries) == 1
    g(ev.drop_level(ct, 1))
    assert len(g.entries) == 2
    g(ct.with_metadata(scale=ct.scale * 2))
    assert len(g.entries) == 3


def test_replays_read_fresh_inputs_and_keep_results(session):
    """Two replays on different inputs equal the eager outputs, and a result
    returned is not overwritten by the next replay."""
    ev = session.fast.ev

    def fn(c):
        return ev.rescale(ev.mul_const_complex(ev.add(c, c), 0.5 + 0.25j))

    g = staged.graph_ciphertext_fn(ev, session.p.params, fn, name="probe")
    a = feval.ct_to_fast(session.ct)
    b = ev.conjugate(a)
    ra = g(a)
    kept = [v.clone() for v in ra.value]
    rb = g(b)
    assert len(g.entries) == 1
    assert _same(ra, fn(a)) and _same(rb, fn(b))
    assert all(torch.equal(x, y) for x, y in zip(ra.value, kept))


def test_host_sync_raises_at_capture(session):
    """A stage that waits for the host cannot be captured: it raises with
    its name and never runs eagerly instead."""
    ev = session.fast.ev
    calls = []

    def fn(c):
        calls.append(int(c.value[0][0, 0]))  # a device -> host read
        return c

    g = staged.graph_ciphertext_fn(ev, session.p.params, fn, name="syncs")
    ct = feval.ct_to_fast(session.ct)
    with pytest.raises(RuntimeError, match="syncs"):
        g(ct)
    assert not g.entries and len(calls) == 1  # the warm-up ran it once, eagerly
    torch.cuda.synchronize()
    # the card still works after the refused capture
    g2 = staged.graph_ciphertext_fn(ev, session.p.params, ev.rescale, name="after")
    assert _same(g2(ct), ev.rescale(ct))


def test_b1_call_is_one_kernel_node():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a GPU")
    n, moduli = 1 << 10, ntt_cuda.find_v2_primes(1 << 10, 3)
    tabs = ntt_cuda.build_tables(n, moduli, "cuda")
    x = torch.randint(0, min(moduli), (3, n), dtype=torch.int32, device="cuda")
    for fn, name in ((ntt_cuda.ntt_fwd, "ntt_fwd_kernel"), (ntt_cuda.ntt_bwd, "ntt_bwd_kernel")):
        kernels = launches.graph_kernels(lambda: fn(x, tabs), calls=2)
        assert len(kernels) == 2 and all(name in k for k in kernels), kernels


def test_scalar_constants_are_cached(session):
    """A double-RNS constant is made on the device once: asked again, the
    same tensor."""
    ev = session.fast.ev
    a = ev._double_rns_scalars(3, 0.5 + 0.25j, Fraction(1 << 10))
    b = ev._double_rns_scalars(3, 0.5 + 0.25j, Fraction(1 << 10))
    assert a[0].data_ptr() == b[0].data_ptr() and a[0].is_cuda


def test_graph_keeps_its_constants(session):
    """A captured stage keeps every device constant it read: after the
    shared cache is cleared, its memory handed back and written over, a
    replay gives the same limbs as before and as the eager call."""
    ev = session.fast.ev

    def fn(c):
        c = ev.add_const(ev.mul_const(c, 0.6180339887), 0.3 - 0.7j)
        return ev.rescale(ev.mul_const_complex(c, 0.5 + 0.25j))

    g = staged.graph_ciphertext_fn(ev, session.p.params, fn, name="constants")
    ct = feval.ct_to_fast(session.ct)
    want = g(ct)
    assert next(iter(g.entries.values())).constants  # recorded at capture
    device.clear_constants()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((n,), -1, dtype=torch.int64, device="cuda")
            for n in (1, 8, 64, 512, 4096) for _ in range(2000)]
    torch.cuda.synchronize()
    got = g(ct)
    assert _same(got, want) and _same(got, fn(ct))
    del junk

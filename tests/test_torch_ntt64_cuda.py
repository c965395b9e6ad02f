"""PyTorch port, kernel B4 (csrc/ntt64.cu), the NTT of 64-bit words, on the
card, through ``ops/ntt64_cuda.py`` and the rings that launch it.

Each test holds the kernel bit-exact against its plain version
(``ntt64_cuda.ntt_fwd_plain``/``ntt_bwd_plain``) run on CPU copies of the
same tensors, at moduli up to the wide path's 2^61 + 2^55.  Without a GPU
every test here skips; this file imports no jax, so on a machine with a
card and no jax it runs on its own:

    python -m pytest tests/test_torch_ntt64_cuda.py -q -p no:cacheprovider \\
        --noconftest -o addopts=""
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from matrix_fhe_tpu_torch.fast import wckks, wring
from matrix_fhe_tpu_torch.ops import ntt64_cuda, rings, wide
from matrix_fhe_tpu_torch.utils import launches
from matrix_fhe_tpu_torch.utils import primes as pr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA u64 NTT kernel needs a GPU")
    return torch.device("cuda")


def _moduli(n, bits=(45, 55, 61)):
    out = []
    for b in bits:
        g = pr.NTTFriendlyPrimesGenerator(b, 2 * n)
        out.append(g.next_downstream_prime() if b == 61 else g.next_alternating_prime())
    return out


def _operands(lead, moduli, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, lead + (n,), dtype=np.int64) for q in moduli], axis=-2)
    x.reshape(-1, n)[0, :2] = [moduli[0] - 1, 0]
    return torch.from_numpy(x)


def _check(x, ring_cpu, ring_dev, cluster=None):
    dev = ring_dev.device
    if cluster is None:
        f, b = ring_dev.ntt(x.to(dev)), ring_dev.intt(x.to(dev))
    else:
        f = ntt64_cuda.launch(x.to(dev), ring_dev, True, cluster)
        b = ntt64_cuda.launch(x.to(dev), ring_dev, False, cluster)
    back = ring_dev.intt(f)
    torch.cuda.synchronize()
    assert f.dtype == torch.int64 and f.shape == x.shape
    assert torch.equal(f.cpu(), ntt64_cuda.ntt_fwd_plain(x, ring_cpu))
    assert torch.equal(b.cpu(), ntt64_cuda.ntt_bwd_plain(x, ring_cpu))
    assert torch.equal(back.cpu(), x)


@pytest.mark.parametrize("logn", range(4, 17))
def test_kernel_matches_plain_every_size(cuda, logn):
    n = 1 << logn
    moduli = _moduli(n)
    _check(_operands((2,), moduli, n, logn), rings.new_ring(n, moduli, device="cpu"),
           rings.new_ring(n, moduli, device=cuda))


@pytest.mark.parametrize("logn", range(10, 17))
@pytest.mark.parametrize("c", ntt64_cuda.CLUSTERS)
def test_every_cluster_size(cuda, logn, c):
    """Every cluster size the kernel is built for at every N that has a
    cluster kernel (below 2^10 only C = 1, in the test above)."""
    n = 1 << logn
    if c not in ntt64_cuda.clusters(n):
        pytest.skip("a CTA holds at most 2^14 words")
    moduli = _moduli(n)
    _check(_operands((1,), moduli, n, c), rings.new_ring(n, moduli, device="cpu"),
           rings.new_ring(n, moduli, device=cuda), cluster=c)


@pytest.mark.parametrize("lead, limbs", [((), 9), ((4,), 9), ((2,), 7), ((1,), 21), ((6,), 17)])
def test_wide_ring_step_shapes(cuda, lead, limbs):
    """The wide ring at logN 14 and the shapes its step and bootstrap give
    B4; each call counts one launch."""
    n = 1 << 14
    moduli = pr.NTTFriendlyPrimesGenerator(45, 2 * n).next_alternating_primes(limbs)
    ring_dev = wring.new_wide_ring(n, moduli, device=cuda)
    before = (ntt64_cuda.fwd_launches, ntt64_cuda.bwd_launches)
    _check(_operands(lead, moduli, n, limbs), wring.new_wide_ring(n, moduli, device="cpu"),
           ring_dev)
    assert (ntt64_cuda.fwd_launches - before[0], ntt64_cuda.bwd_launches - before[1]) == (1, 2)


# bench.py's two wide step moduli at logN 14 (chip_smoke.py phase 11), and
# the shapes its step gives B4 on each ring ([L] rows of one polynomial,
# [2, L] a ciphertext, [4, L] the key switch's digits)
WIDE_STEP_MODULI = {"pn14qp438": (wckks.PN14QP438_Q, wckks.PN14QP438_P),
                    "wide61": (chip_smoke.WIDE61_Q, chip_smoke.WIDE61_P)}


@pytest.mark.parametrize("name", sorted(WIDE_STEP_MODULI))
def test_wide_step_moduli_and_shapes(cuda, name):
    """B4 at the PN14QP438 and wide61 step's moduli and launch shapes, at
    the cluster size the rule picks, against the plain version."""
    n = 1 << 14
    q, p = WIDE_STEP_MODULI[name]
    for moduli, leads in ((q, [(), (2,), (4,)]), (p, [(2,), (4,)]), (q + p, [(), (2,)])):
        ring_cpu = wring.new_wide_ring(n, list(moduli), device="cpu")
        ring_dev = wring.new_wide_ring(n, list(moduli), device=cuda)
        for lead in leads:
            _check(_operands(lead, list(moduli), n, len(lead) + len(moduli)), ring_cpu, ring_dev)


def _above_2_61(count: int) -> list[int]:
    """The first primes above 2^61 that are 1 mod 2^18 (4N for N = 2^16:
    both B4 modes at every N), all below the wide path's 2^61 + 2^55."""
    out, q = [], 1 << 61
    while len(out) < count:
        q += 1 << 18
        if pr.is_prime(q + 1):
            out.append(q + 1)
    assert out[-1] < wide.MAX_WIDE_MODULUS
    return out


@pytest.mark.parametrize("logn", range(6, 17))
def test_moduli_above_2_61(cuda, logn):
    """B4 at primes in [2^61, 2^61 + 2^55), where the forward's lazy words
    reach 4q > 2^63: both modes (the standard ring, the wide path's, and the
    CI ring), every cluster size, against the plain versions; a row of
    q - 1 words (the largest lazy sums) among random ones."""
    n = 1 << logn
    moduli = _above_2_61(2) + [pr.NTTFriendlyPrimesGenerator(45, 1 << 18).next_alternating_prime()]
    x = _operands((2,), moduli, n, logn)
    x[0, 0] = moduli[0] - 1
    for kind in (rings.STANDARD, rings.CONJUGATE_INVARIANT):
        ring_cpu, ring_dev = (rings.new_ring(n, moduli, kind, device=d,
                                             max_modulus=wide.MAX_WIDE_MODULUS)
                              for d in ("cpu", cuda))
        ci = kind == rings.CONJUGATE_INVARIANT
        plain_f = ntt64_cuda.ntt_ci_fwd_plain if ci else ntt64_cuda.ntt_fwd_plain
        plain_b = ntt64_cuda.ntt_ci_bwd_plain if ci else ntt64_cuda.ntt_bwd_plain
        want_f, want_b = plain_f(x, ring_cpu), plain_b(x, ring_cpu)
        for c in ntt64_cuda.clusters(n):
            f = ntt64_cuda.launch(x.to(cuda), ring_dev, True, c, ci=ci)
            b = ntt64_cuda.launch(x.to(cuda), ring_dev, False, c, ci=ci)
            assert torch.equal(f.cpu(), want_f), (kind, c)
            assert torch.equal(b.cpu(), want_b), (kind, c)
        assert torch.equal(ring_dev.intt(ring_dev.ntt(x.to(cuda))).cpu(), x), kind


# phase 16's launch shapes of the CI ring at logN 14 (55 + 45x6-bit Q, a
# 61-bit P): one polynomial over 1, 6 or 7 limbs
@pytest.mark.parametrize("limbs", [1, 6, 7])
def test_ci_mode_phase16_shapes(cuda, limbs):
    """B4's CI mode at phase 16's shapes: equal to the plain CI transform on
    the CPU, and still one kernel a call (three calls captured into a CUDA
    graph hold three B4 kernel nodes and nothing else)."""
    n = 1 << 14
    moduli = [pr.NTTFriendlyPrimesGenerator(b, 4 * n).next_alternating_prime()
              for b in (55, 45)] + pr.NTTFriendlyPrimesGenerator(
                  45, 4 * n).next_alternating_primes(6)[1:] + [
                  pr.NTTFriendlyPrimesGenerator(61, 4 * n).next_downstream_prime()]
    moduli = moduli[:limbs]
    ring_cpu = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device="cpu")
    ring_dev = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device=cuda)
    x = _operands((), moduli, n, limbs)
    xd = x.to(cuda)
    for fn, plain in ((ntt64_cuda.ntt_ci_fwd, ntt64_cuda.ntt_ci_fwd_plain),
                      (ntt64_cuda.ntt_ci_bwd, ntt64_cuda.ntt_ci_bwd_plain)):
        assert torch.equal(fn(xd, ring_dev).cpu(), plain(x, ring_cpu))
        kernels = launches.graph_kernels(functools.partial(fn, xd, ring_dev))
        assert len(kernels) == 3 and all("ntt64" in k for k in kernels), kernels


def test_input_checks_and_refused_launches(cuda):
    n = 1 << 15
    moduli = _moduli(n)
    ring = rings.new_ring(n, moduli, device=cuda)
    x = _operands((1,), moduli, n, 0).to(cuda)
    with pytest.raises(TypeError):
        ntt64_cuda.ntt_fwd(x.to(torch.int32), ring)
    with pytest.raises(ValueError):
        ntt64_cuda.ntt_fwd(x[:, :2], ring)
    with pytest.raises(ValueError):
        ntt64_cuda.launch(x.transpose(-1, -2).contiguous().transpose(-1, -2), ring, True)
    for c in (1, 3, 32):  # no kernel: 2^15 words do not fit one CTA; C a power of two <= 16
        with pytest.raises(RuntimeError, match="CUDA error"):
            ntt64_cuda.launch(x, ring, True, c)


def test_side_stream(cuda):
    n = 1 << 14
    moduli = _moduli(n)
    ring_cpu, ring_dev = rings.new_ring(n, moduli, device="cpu"), rings.new_ring(n, moduli, device=cuda)
    x = _operands((3,), moduli, n, 7)
    s = torch.cuda.Stream()
    xd = x.to(cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        f = ring_dev.ntt(xd)
    s.synchronize()
    assert torch.equal(f.cpu(), ntt64_cuda.ntt_fwd_plain(x, ring_cpu))

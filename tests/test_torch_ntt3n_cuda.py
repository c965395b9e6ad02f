"""PyTorch port, kernel B5 (csrc/ntt3n.cu), the 3N ring's NTT, on the card,
through ``ops/ntt3n_cuda.py`` and the rings that launch it; and the
conjugate-invariant ring's NTT on kernel B4's CI mode (the fold inside the
launch).

Each test holds the kernel bit-exact against its plain version
(``ntt3n_cuda.ntt_fwd_plain``/``ntt_bwd_plain``, ``ops/ntt_3n.py``;
``ntt64_cuda.ntt_ci_fwd_plain``/``_bwd_plain``) run on CPU copies of the
same tensors, at every cluster size the wrappers can pick.  Without a GPU
every test here skips; this
file imports no jax, so on a machine with a card and no jax it runs on its
own:

    python -m pytest tests/test_torch_ntt3n_cuda.py -q -p no:cacheprovider \\
        --noconftest -o addopts=""
"""

import functools

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.ops import ntt3n_cuda, ntt64_cuda, rings
from matrix_fhe_tpu_torch.utils import launches
from matrix_fhe_tpu_torch.utils import primes as pr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA 3N NTT kernel needs a GPU")
    return torch.device("cuda")


def _moduli(n, bits=(45, 55, 60)):
    return [pr.find_3n_rns_primes(n, b, 1)[0] for b in bits]


def _operands(lead, moduli, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, lead + (n,), dtype=np.int64) for q in moduli], axis=-2)
    x.reshape(-1, n)[0, :2] = [moduli[0] - 1, 0]
    return torch.from_numpy(x)


def _check(x, ring_cpu, ring_dev):
    dev = ring_dev.device
    f, b = ring_dev.ntt(x.to(dev)), ring_dev.intt(x.to(dev))
    assert torch.equal(f.cpu(), ntt3n_cuda.ntt_fwd_plain(x, ring_cpu))
    assert torch.equal(b.cpu(), ntt3n_cuda.ntt_bwd_plain(x, ring_cpu))
    assert torch.equal(ring_dev.intt(f).cpu(), x)


@pytest.mark.parametrize("n", [12, 24, 48, 96, 1152, 1536, 12288, 24576, 27648])
def test_kernel_matches_plain(cuda, n):
    moduli = _moduli(n)
    ring_cpu = rings.new_ring(n, moduli, rings.MATRIX, device="cpu")
    ring_dev = rings.new_ring(n, moduli, rings.MATRIX, device=cuda)
    _check(_operands((2,), moduli, n, n), ring_cpu, ring_dev)


@pytest.mark.parametrize("lead, limbs", [((), 7), ((2,), 7), ((2, 3), 6), ((7,), 1)])
def test_batched_and_sliced_rows(cuda, lead, limbs):
    n = 12288
    moduli = pr.find_3n_rns_primes(n, 41, 6) + pr.find_3n_rns_primes(n, 51, 1)
    ring_cpu = rings.new_ring(n, moduli, rings.MATRIX, device="cpu")
    ring_dev = rings.new_ring(n, moduli, rings.MATRIX, device=cuda)
    x = _operands(lead, moduli[:limbs], n, limbs)
    _check(x, ring_cpu.at_level(limbs - 1), ring_dev.at_level(limbs - 1))
    # a limb view that starts past the first limb
    y = _operands(lead, moduli[2:4], n, 9)
    _check(y, ring_cpu.limbs(2, 4), ring_dev.limbs(2, 4))


def test_counts_and_dense_degree(cuda):
    n = 48
    ring = rings.new_ring(n, _moduli(n), rings.MATRIX, device=cuda)
    x = _operands((), _moduli(n), n, 1).to(cuda)
    f0, b0 = ntt3n_cuda.fwd_launches, ntt3n_cuda.bwd_launches
    ring.intt(ring.ntt(x))
    assert (ntt3n_cuda.fwd_launches - f0, ntt3n_cuda.bwd_launches - b0) == (1, 1)
    # N = 6 has no factorized split: the dense transform runs, no kernel
    small = rings.new_ring(6, _moduli(6), rings.MATRIX, device=cuda)
    assert small.ntt3n is None
    z = _operands((), _moduli(6), 6, 2).to(cuda)
    f0, b0 = ntt3n_cuda.fwd_launches, ntt3n_cuda.bwd_launches
    assert torch.equal(small.intt(small.ntt(z)), z)
    assert (ntt3n_cuda.fwd_launches, ntt3n_cuda.bwd_launches) == (f0, b0)


def test_input_checks_and_refused_sizes(cuda):
    n = 48
    moduli = _moduli(n)
    ring = rings.new_ring(n, moduli, rings.MATRIX, device=cuda)
    x = _operands((), moduli, n, 3).to(cuda)
    with pytest.raises(TypeError):
        ntt3n_cuda.ntt_fwd(x.to(torch.int32), ring)
    with pytest.raises(ValueError):
        ntt3n_cuda.ntt_fwd(x[:2], ring)
    with pytest.raises(ValueError, match="contiguous"):
        ntt3n_cuda.launch(x.t().contiguous().t(), ring, True)
    # 39366 = 2 3^9: M = 3^9 is odd, so no cluster splits it, and its two
    # branches pass the 227 KB one CTA holds
    with pytest.raises(NotImplementedError, match="227"):
        rings.new_ring(39366, pr.find_3n_rns_primes(39366, 40, 1), rings.MATRIX, device=cuda)
    # a cluster the kernel does not take at this N (M = 24 = 2^3 3: C <= 8)
    with pytest.raises(ValueError, match="cluster"):
        ntt3n_cuda.launch(x, ring, True, cluster=16)


@pytest.mark.parametrize("n", [48, 1152, 12288, 27648, 31104])
def test_every_cluster_size(cuda, n):
    """B5 at each cluster size it takes at N (31104 = 2^7 3^5 only from
    C = 2 on), forward, inverse and the round trip."""
    moduli = _moduli(n, (41, 51, 60))
    ring_cpu = rings.new_ring(n, moduli, rings.MATRIX, device="cpu")
    ring_dev = rings.new_ring(n, moduli, rings.MATRIX, device=cuda)
    x = _operands((3,), moduli, n, n + 1)
    want_f = ntt3n_cuda.ntt_fwd_plain(x, ring_cpu)
    want_b = ntt3n_cuda.ntt_bwd_plain(x, ring_cpu)
    cs = ntt3n_cuda.clusters(n)
    assert cs == ((2, 4, 8) if n == 31104 else (1, 2, 4, 8))
    for c in cs:
        f = ntt3n_cuda.launch(x.to(cuda), ring_dev, True, cluster=c)
        b = ntt3n_cuda.launch(x.to(cuda), ring_dev, False, cluster=c)
        assert torch.equal(f.cpu(), want_f), c
        assert torch.equal(b.cpu(), want_b), c
        assert torch.equal(ntt3n_cuda.launch(f, ring_dev, False, cluster=c).cpu(), x), c


@pytest.mark.parametrize("lead", [(1,), (5,), (6,), (7,)])
def test_phase15_shapes_and_geometry(cuda, lead):
    """Phase 15's launch shapes at N = 12288 (one polynomial of 1 to 7
    limbs) with the cluster size the wrapper picks."""
    n = 12288
    moduli = pr.find_3n_rns_primes(n, 41, 6) + pr.find_3n_rns_primes(n, 51, 1)
    limbs = lead[0]
    ring_cpu = rings.new_ring(n, moduli[:limbs], rings.MATRIX, device="cpu")
    ring_dev = rings.new_ring(n, moduli[:limbs], rings.MATRIX, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ntt3n_cuda.geometry(limbs, n, sms) in ntt3n_cuda.clusters(n)
    _check(_operands((), moduli[:limbs], n, limbs), ring_cpu, ring_dev)


def test_ci_ring_runs_b4(cuda):
    """The CI ring's NTT on the card: B4's CI mode, equal to the torch-op CI
    transform on the CPU, and counted as B4's CI launches."""
    for n in (16, 1024, 1 << 14):
        moduli = pr.NTTFriendlyPrimesGenerator(45, 4 * n).next_alternating_primes(3)
        ring_cpu = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device="cpu")
        ring_dev = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device=cuda)
        x = _operands((2,), moduli, n, n)
        f0, b0 = ntt64_cuda.ci_fwd_launches, ntt64_cuda.ci_bwd_launches
        f, b = ring_dev.ntt(x.to(cuda)), ring_dev.intt(x.to(cuda))
        assert (ntt64_cuda.ci_fwd_launches - f0, ntt64_cuda.ci_bwd_launches - b0) == (1, 1)
        assert torch.equal(f.cpu(), ntt64_cuda.ntt_ci_fwd_plain(x, ring_cpu))
        assert torch.equal(b.cpu(), ntt64_cuda.ntt_ci_bwd_plain(x, ring_cpu))
        assert torch.equal(ring_dev.intt(f).cpu(), x)


@pytest.mark.parametrize("logn", [4, 6, 10, 13, 14, 15, 16])
def test_ci_mode_every_cluster_size(cuda, logn):
    """B4's CI mode (the fold on load and on store) at each cluster size it
    is built for at N = 2^logn, against the plain CI transform on the CPU."""
    n = 1 << logn
    moduli = pr.NTTFriendlyPrimesGenerator(55, 4 * n).next_alternating_primes(2)
    ring_cpu = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device="cpu")
    ring_dev = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device=cuda)
    x = _operands((2,), moduli, n, logn)
    want_f = ntt64_cuda.ntt_ci_fwd_plain(x, ring_cpu)
    want_b = ntt64_cuda.ntt_ci_bwd_plain(x, ring_cpu)
    for c in ntt64_cuda.clusters(n):
        f = ntt64_cuda.launch(x.to(cuda), ring_dev, True, c, ci=True)
        b = ntt64_cuda.launch(x.to(cuda), ring_dev, False, c, ci=True)
        assert torch.equal(f.cpu(), want_f), c
        assert torch.equal(b.cpu(), want_b), c


def test_ci_call_is_one_kernel(cuda):
    """A CI transform is one launch and no other kernel (three calls
    captured into a CUDA graph hold three B4 kernel nodes and nothing
    else), and no torch operator on the words, on sliced limbs too."""
    n = 1 << 14
    moduli = pr.NTTFriendlyPrimesGenerator(55, 4 * n).next_alternating_primes(3)
    ring = rings.new_ring(n, moduli, rings.CONJUGATE_INVARIANT, device=cuda).limbs(1, 3)
    x = _operands((2,), moduli[1:3], n, 5).to(cuda)
    for fn in (ntt64_cuda.ntt_ci_fwd, ntt64_cuda.ntt_ci_bwd):
        kernels = launches.graph_kernels(functools.partial(fn, x, ring))
        assert len(kernels) == 3 and all("ntt64" in k for k in kernels), kernels
        # the output's allocation alone
        assert launches.torch_ops(functools.partial(fn, x, ring)) == ["aten.empty_like.default"]

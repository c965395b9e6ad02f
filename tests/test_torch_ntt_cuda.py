"""PyTorch port, the CUDA NTT kernel (csrc/ntt.cu) on the card, through its
three wrappers: ntt_cuda.ntt_fwd/ntt_bwd, ntt_cuda.ntt_chain and
ntt_w22.ntt_fwd/ntt_bwd.

Each test holds the kernel bit-exact against the plain torch version
(ops/ntt_plain.py) run on CPU copies of the same tensors.  Without a GPU
every test here skips; this file imports no jax, so on a machine with a
card and no jax it runs on its own:

    python -m pytest tests/test_torch_ntt_cuda.py -q -p no:cacheprovider \
        --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain, ntt_w22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA NTT kernel needs a GPU")
    return torch.device("cuda")


def _operands(shape, moduli, seed):
    rng = np.random.default_rng(seed)
    hi = np.array(moduli, dtype=np.int64)[:, None]
    return torch.from_numpy((rng.integers(0, 1 << 62, shape) % hi).astype(np.int32))


def _check(x, n, moduli, cuda):
    cpu = ntt_cuda.build_tables(n, moduli, "cpu")
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    f = ntt_cuda.ntt_fwd(x.to(cuda), dev)
    b = ntt_cuda.ntt_bwd(f, dev)
    bx = ntt_cuda.ntt_bwd(x.to(cuda), dev)
    torch.cuda.synchronize()
    assert f.dtype == torch.int32 and f.shape == x.shape
    assert torch.equal(f.cpu(), ntt_plain.ntt_fwd_plain(x, cpu))
    assert torch.equal(bx.cpu(), ntt_plain.ntt_bwd_plain(x, cpu))
    assert torch.equal(b.cpu(), x)


@pytest.mark.parametrize("logn", range(4, 16))
def test_kernel_matches_plain_every_size(cuda, logn):
    n = 1 << logn
    moduli = ntt_cuda.find_v2_primes(n, 3)
    _check(_operands((2, 3, n), moduli, logn), n, moduli, cuda)


@pytest.mark.parametrize("shape", [(19,), (7, 19), (2, 3), (17,), (7, 3), (2, 19),
                                   (1, 19), (1, 3)])
def test_kernel_matches_plain_step_shapes(cuda, shape):
    n = 1 << 14
    moduli = ntt_cuda.find_v2_primes(n, 22)[:shape[-1]]
    _check(_operands(shape + (n,), moduli, sum(shape)), n, moduli, cuda)


def test_kernel_extreme_values(cuda):
    n = 1 << 12
    moduli = ntt_cuda.find_v2_primes(n, 2)
    top = torch.tensor(moduli, dtype=torch.int32)[:, None] - 1
    x = torch.stack([top.expand(2, n), torch.zeros(2, n, dtype=torch.int32)])
    _check(x.contiguous(), n, moduli, cuda)


def test_wrapper_counts_launches_and_rejects_bad_input(cuda):
    n = 1 << 10
    moduli = ntt_cuda.find_v2_primes(n, 2)
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((3, 2, n), moduli, 0).to(cuda)
    before = (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches, ntt_cuda.launches)
    ntt_cuda.ntt_bwd(ntt_cuda.ntt_fwd(x, dev), dev)
    ntt_cuda.ntt_fwd(x, dev)
    after = (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches, ntt_cuda.launches)
    assert after == (before[0] + 2, before[1] + 1, before[2] + 3)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_fwd(x.to(torch.int64), dev)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd(x.transpose(0, 1), dev)      # [2, 3, n]: wrong limbs
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd(x[..., ::2], dev)            # not [.., L, N]
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd(x.transpose(-1, -2).contiguous().transpose(-1, -2), dev)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd(x, ntt_cuda.build_tables(n, moduli, "cpu"))
    assert (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches, ntt_cuda.launches) == after
    big = 1 << 16
    with pytest.raises(NotImplementedError):
        ntt_cuda.ntt_fwd(torch.zeros((1, big), dtype=torch.int32, device=cuda),
                         ntt_cuda.build_tables(big, ntt_cuda.find_v2_primes(big, 1), cuda))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("logn", [10, 14, 15])
def test_kernel_matches_plain_every_cluster_size(cuda, logn, cluster):
    """Rows split over `cluster` CTAs, forced through launch's geometry."""
    n = 1 << logn
    moduli = ntt_cuda.find_v2_primes(n, 3)
    cpu = ntt_cuda.build_tables(n, moduli, "cpu")
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((2, 3, n), moduli, logn * 8 + cluster)
    f = ntt_cuda.launch(x.to(cuda), dev, True, cluster=cluster)
    b = ntt_cuda.launch(x.to(cuda), dev, False, cluster=cluster)
    rt = ntt_cuda.launch(f, dev, False, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ntt_plain.ntt_fwd_plain(x, cpu))
    assert torch.equal(b.cpu(), ntt_plain.ntt_bwd_plain(x, cpu))
    assert torch.equal(rt.cpu(), x)


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_chain_kernel_matches_plain_over_a_cluster(cuda, k, cluster):
    n = 1 << 14
    moduli = ntt_cuda.find_v2_primes(n, 3)
    cpu = ntt_cuda.build_tables(n, moduli, "cpu")
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((1, 3, n), moduli, k + cluster)
    f = ntt_cuda.launch(x.to(cuda), dev, True, k, cluster=cluster)
    b = ntt_cuda.launch(x.to(cuda), dev, False, k, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ntt_plain.ntt_chain_plain(x, cpu, k, fwd=True))
    assert torch.equal(b.cpu(), ntt_plain.ntt_chain_plain(x, cpu, k, fwd=False))


def test_refused_launch_raises(cuda):
    n = 1 << 9
    moduli = ntt_cuda.find_v2_primes(n, 2)
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((1, 2, n), moduli, 0).to(cuda)
    before = ntt_cuda.launches
    for cluster in (16, 3, 2):     # no such cluster size; no cluster below N = 2^10
        with pytest.raises(RuntimeError):
            ntt_cuda.launch(x, dev, True, cluster=cluster)
        with pytest.raises(RuntimeError):
            ntt_cuda.launch(x, dev, False, cluster=cluster)
    assert ntt_cuda.launches == before


def test_kernel_runs_on_the_current_stream(cuda):
    n = 1 << 14
    moduli = ntt_cuda.find_v2_primes(n, 4)
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((8, 4, n), moduli, 1).to(cuda)
    for cluster in (1, 8):            # one CTA a row, and a row over a cluster
        want = ntt_cuda.launch(x, dev, True, cluster=cluster)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = ntt_cuda.launch(x, dev, True, cluster=cluster)
            back = ntt_cuda.launch(got, dev, False, cluster=cluster)
        torch.cuda.current_stream().wait_stream(side)
        assert torch.equal(got, want) and torch.equal(back, x)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("logn", [10, 12, 14, 15])
def test_chain_kernel_matches_plain(cuda, logn, k):
    n = 1 << logn
    moduli = ntt_cuda.find_v2_primes(n, 3)
    cpu = ntt_cuda.build_tables(n, moduli, "cpu")
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    x = _operands((2, 3, n), moduli, logn + k)
    f = ntt_cuda.ntt_chain(x.to(cuda), dev, k)
    b = ntt_cuda.ntt_chain(x.to(cuda), dev, k, fwd=False)
    rt = ntt_cuda.ntt_chain(f, dev, k, fwd=False)
    torch.cuda.synchronize()
    assert f.dtype == torch.int32 and f.shape == x.shape
    assert torch.equal(f.cpu(), ntt_plain.ntt_chain_plain(x, cpu, k, fwd=True))
    assert torch.equal(b.cpu(), ntt_plain.ntt_chain_plain(x, cpu, k, fwd=False))
    assert torch.equal(rt.cpu(), x)


@pytest.mark.parametrize("shape", [(8, 4, 1 << 14), (2, 3, 1 << 10)])
def test_w22_kernel_matches_plain(cuda, shape):
    n = shape[-1]
    moduli = ntt_w22.find_w22_primes(n, shape[-2])
    cpu = ntt_w22.build_tables(n, moduli, "cpu")
    dev = ntt_w22.build_tables(n, moduli, cuda)
    x = _operands(shape, moduli, n)
    f = ntt_w22.ntt_fwd(x.to(cuda), dev)
    b = ntt_w22.ntt_bwd(x.to(cuda), dev)
    rt = ntt_w22.ntt_bwd(f, dev)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ntt_plain.ntt_fwd_plain(x, cpu))
    assert torch.equal(b.cpu(), ntt_plain.ntt_bwd_plain(x, cpu))
    assert torch.equal(rt.cpu(), x)


def test_chain_and_w22_wrappers_count_launches_and_reject_bad_input(cuda):
    n = 1 << 10
    moduli = ntt_w22.find_w22_primes(n, 2)
    dev = ntt_cuda.build_tables(n, moduli, cuda)
    w22 = ntt_w22.build_tables(n, moduli, cuda)
    x = _operands((3, 2, n), moduli, 0).to(cuda)

    def counts():
        return (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches,
                ntt_cuda.chain_fwd_launches, ntt_cuda.chain_bwd_launches,
                ntt_w22.w22_fwd_launches, ntt_w22.w22_bwd_launches, ntt_cuda.launches)

    before = counts()
    ntt_cuda.ntt_chain(ntt_cuda.ntt_chain(x, dev, 3), dev, 3, fwd=False)
    ntt_cuda.ntt_chain(x, dev, 1)
    ntt_w22.ntt_bwd(ntt_w22.ntt_fwd(x, w22), w22)
    ntt_w22.ntt_fwd(x, w22)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0, 0, 2, 1, 2, 1, 6]
    with pytest.raises(TypeError):
        ntt_cuda.ntt_chain(x.to(torch.int64), dev, 2)
    with pytest.raises(TypeError):
        ntt_w22.ntt_fwd(x.to(torch.int64), w22)
    with pytest.raises(TypeError):
        ntt_w22.ntt_fwd(x, dev)                           # not w22 tables
    for k in (0, 2.0):
        with pytest.raises(ValueError):
            ntt_cuda.ntt_chain(x, dev, k)
    for bad in (x.transpose(0, 1), x[..., ::2],
                x.transpose(-1, -2).contiguous().transpose(-1, -2)):
        with pytest.raises(ValueError):
            ntt_cuda.ntt_chain(bad, dev, 2)
        with pytest.raises(ValueError):
            ntt_w22.ntt_bwd(bad, w22)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_chain(x, ntt_cuda.build_tables(n, moduli, "cpu"), 2)
    with pytest.raises(ValueError):
        ntt_w22.ntt_fwd(x, ntt_w22.build_tables(n, moduli, "cpu"))
    assert counts() == after

"""PyTorch port, kernel B6 (csrc/ntt_sharded.cu), the local step of the
coefficient-sharded NTT, on the card, through ``ops/ntt_sharded_cuda.py``.

Each test holds the kernel bit-exact against its plain version
(``ntt_sharded_cuda.local_step_plain``) on the same CUDA tensors: at
chip_smoke.py phase 26's shard shapes (N = 2^14, the flagship's 9 Q primes
and its 61-bit P, lead 2, every block of k = 8, 2 and 1 shards), at every
N from 2^4 to 2^16 with 45-, 55- and 61-bit primes, at every geometry the
tiled kernel takes, and at the one-column blocks of the simple kernel.  Without a
GPU every test here skips; this file imports no jax, so on a machine with a
card and no jax it runs on its own:

    python -m pytest tests/test_torch_ntt_sharded_cuda.py -q -p no:cacheprovider \\
        --noconftest -o addopts=""
"""

import functools

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch import flagship
from matrix_fhe_tpu_torch.ops import ntt_sharded_cuda
from matrix_fhe_tpu_torch.parallel import ntt_sharded as sh
from matrix_fhe_tpu_torch.utils import primes as pr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA sharded NTT kernel needs a GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _tables(n, moduli):
    return ntt_sharded_cuda.build_tables(n, list(moduli), "cuda")


def _moduli(n, bits=(45, 55, 61)):
    out = []
    for b in bits:
        g = pr.NTTFriendlyPrimesGenerator(b, 2 * n)
        out.append(g.next_downstream_prime() if b == 61 else g.next_alternating_prime())
    return tuple(out)


def _words(lead, moduli, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, lead + (n,), dtype=np.int64) for q in moduli], axis=-2)
    x.reshape(-1, n)[0, :2] = [moduli[0] - 1, 0]
    return torch.from_numpy(x)


def _check_blocks(x, tabs, k, blocks):
    c = tabs.cols // k
    for i in blocks:
        blk = sh.shard_columns(x, tabs, k, i)
        got = ntt_sharded_cuda.local_step(blk, tabs, i * c)
        want = ntt_sharded_cuda.local_step_plain(blk, tabs, i * c)
        torch.cuda.synchronize()
        assert got.shape == blk.shape[:-1] + (tabs.cols,) and got.dtype == torch.int64
        assert torch.equal(got, want), f"k={k} block {i}"


@pytest.mark.parametrize("k", [8, 2, 1])
def test_phase26_shard_shapes(cuda, k):
    params = flagship.flagship_parameters(14, 9, 1, device=cuda)
    moduli = tuple(params.q) + tuple(params.p)
    tabs = _tables(1 << 14, moduli)
    x = _words((2,), moduli, 1 << 14, 26).to(cuda)
    _check_blocks(x, tabs, k, range(k))


@pytest.mark.parametrize("logn", range(4, 17))
def test_sizes(cuda, logn):
    n = 1 << logn
    tabs = _tables(n, _moduli(n))
    x = _words((1,), _moduli(n), n, logn).to(cuda)
    C = tabs.cols
    for k in sorted({1, 2, min(8, C)}):
        _check_blocks(x, tabs, k, sorted({0, k - 1}))


@pytest.mark.parametrize("logn, k", [(4, 1), (4, 2), (5, 4), (10, 1), (10, 8), (14, 1),
                                     (14, 8), (15, 2), (16, 1), (16, 8)])
def test_every_geometry(cuda, logn, k):
    """The tiled kernel at every (threads, ti, cn) it takes at the shape
    (``ntt_sharded_cuda.candidates``): 2 x 2 and 2 x 4 tiles, CTAs of 2 to R
    rows, threads idle in step 2 or not, step-1 tiles shared by 1 to 32
    threads, one stage or many, sums reduced inside a stage or across
    stages; each block against the plain version."""
    n = 1 << logn
    tabs = _tables(n, _moduli(n))
    x = _words((2,), _moduli(n), n, logn + k).to(cuda)
    c = tabs.cols // k
    for i in sorted({0, k - 1}):
        blk = sh.shard_columns(x, tabs, k, i).contiguous()
        want = ntt_sharded_cuda.local_step_plain(blk, tabs, i * c)
        for geom in ntt_sharded_cuda.candidates(tabs.rows, tabs.cols, c):
            got = ntt_sharded_cuda.launch(blk, tabs, i * c, geom)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"2^{logn} k={k} block {i} {geom}"


@pytest.mark.parametrize("logn", [4, 6, 8])
def test_one_column_blocks(cuda, logn):
    """c = 1 (R = C = 4 at N = 2^4, k = 4): the simple kernel, every block."""
    n = 1 << logn
    tabs = _tables(n, _moduli(n))
    x = _words((3,), _moduli(n), n, logn).to(cuda)
    _check_blocks(x, tabs, tabs.cols, range(tabs.cols))


def test_refused_geometry(cuda):
    n, moduli = 1 << 14, _moduli(1 << 14)
    tabs = _tables(n, moduli)
    blk = sh.shard_columns(_words((1,), moduli, n, 0).to(cuda), tabs, 8, 0).contiguous()
    # 64 threads, ti 3, ti x C > 2 cn x threads (twice), cn 3
    for geom in ((64, 4), (256, 3), (256, 32), (128, 8, 2), (128, 4, 3)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            ntt_sharded_cuda.launch(blk, tabs, 0, geom)


def test_gathered_sum_is_the_ntt(cuda):
    from matrix_fhe_tpu_torch.ops import modmath as mm
    from matrix_fhe_tpu_torch.ops import rings
    n, moduli = 1 << 12, _moduli(1 << 12)
    tabs = _tables(n, moduli)
    x = _words((2,), moduli, n, 3).to(cuda)
    k, c = 4, tabs.cols // 4
    parts = torch.stack([ntt_sharded_cuda.local_step(sh.shard_columns(x, tabs, k, i), tabs,
                                                     i * c) for i in range(k)])
    got = mm.modsum(parts, tabs.moduli[:, None, None], tabs.bhi[:, None, None], dim=0)
    want = rings.new_ring(n, list(moduli), device=cuda).ntt(x)
    assert torch.equal(got.reshape(x.shape), want)


def test_counts_launches(cuda):
    n, moduli = 1 << 10, _moduli(1 << 10)
    tabs = _tables(n, moduli)
    x = sh.shard_columns(_words((1,), moduli, n, 0).to(cuda), tabs, 2, 1)
    before = ntt_sharded_cuda.launches
    ntt_sharded_cuda.local_step(x, tabs, tabs.cols // 2)
    assert ntt_sharded_cuda.launches == before + 1
    ntt_sharded_cuda.local_step(x.cpu(), ntt_sharded_cuda.build_tables(n, list(moduli), "cpu"),
                                tabs.cols // 2)
    assert ntt_sharded_cuda.launches == before + 1  # the plain version on the CPU


def test_refused_inputs(cuda):
    n, moduli = 1 << 10, _moduli(1 << 10)
    tabs = _tables(n, moduli)
    x = sh.shard_columns(_words((1,), moduli, n, 0), tabs, 2, 0)
    with pytest.raises(ValueError, match="tables on"):
        ntt_sharded_cuda.local_step(x, tabs, 0)  # a CPU block, tables on the card
    with pytest.raises(TypeError):
        ntt_sharded_cuda.local_step(x.to(cuda).to(torch.int32), tabs, 0)
    with pytest.raises(ValueError, match="columns"):
        ntt_sharded_cuda.local_step(x.to(cuda), tabs, 3)

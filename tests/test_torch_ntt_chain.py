"""PyTorch port, the chained NTT (``ntt_cuda.ntt_chain``) against the JAX
package's ``pallas_ntt2.ntt_chain``.

The JAX kernel runs in interpret mode on the CPU at [8, 3, 2^14] (v2 needs
R, C >= 128, so logN = 14); the port's chain takes its plain path on a CPU
tensor.  The tolerance is exact equality.  The CUDA chain kernel runs only on
a card: tests/test_torch_ntt_cuda.py holds it against the plain version.
"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import pallas_ntt2
from matrix_fhe_tpu_torch.ops import ntt_cuda

N, LIMBS, BATCH, K = 1 << 14, 3, 8, 3


@pytest.fixture(scope="module")
def case():
    moduli = pallas_ntt2.find_v2_primes(N, LIMBS)
    rng = np.random.default_rng(3)
    hi = np.array(moduli, dtype=np.int64)[:, None]
    x = (rng.integers(0, 1 << 62, (BATCH, LIMBS, N)) % hi).astype(np.int32)
    x[0, :, :3] = hi - 1  # worst-case magnitudes
    return x, pallas_ntt2.build_tables(N, moduli), ntt_cuda.build_tables(N, moduli, "cpu")


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "bwd"])
def test_chain_matches_jax_chain_and_sequential_calls(case, fwd):
    x, jtabs, tabs = case
    got = ntt_cuda.ntt_chain(torch.from_numpy(x), tabs, K, fwd=fwd)
    assert got.dtype == torch.int32 and got.shape == x.shape
    want = np.asarray(pallas_ntt2.ntt_chain(x, jtabs, K, fwd=fwd, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    seq = torch.from_numpy(x)
    for _ in range(K):
        seq = (ntt_cuda.ntt_fwd if fwd else ntt_cuda.ntt_bwd)(seq, tabs)
    assert torch.equal(got, seq)


def test_chain_of_one_is_one_transform_and_inverts(case):
    x, _, tabs = case
    xt = torch.from_numpy(x[:2])
    f = ntt_cuda.ntt_chain(xt, tabs, 1)
    assert torch.equal(f, ntt_cuda.ntt_fwd(xt, tabs))
    assert torch.equal(ntt_cuda.ntt_chain(xt, tabs, 1, fwd=False), ntt_cuda.ntt_bwd(xt, tabs))
    assert torch.equal(ntt_cuda.ntt_chain(ntt_cuda.ntt_chain(xt, tabs, 2), tabs, 2, fwd=False), xt)


def test_chain_rejects_bad_arguments_and_launches_nothing_on_cpu():
    n, moduli = 1 << 6, ntt_cuda.find_v2_primes(1 << 6, 2)
    tabs = ntt_cuda.build_tables(n, moduli, "cpu")
    x = torch.zeros((2, 2, n), dtype=torch.int32)
    before = (ntt_cuda.chain_fwd_launches, ntt_cuda.chain_bwd_launches, ntt_cuda.launches)
    for k in (0, -1, 1.0):
        with pytest.raises(ValueError):
            ntt_cuda.ntt_chain(x, tabs, k)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_chain(x.to(torch.int64), tabs, 2)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_chain(x[:, :1], tabs, 2)          # one limb, tables for two
    assert torch.equal(ntt_cuda.ntt_chain(x, tabs, 2, fwd=False), x)
    after = (ntt_cuda.chain_fwd_launches, ntt_cuda.chain_bwd_launches, ntt_cuda.launches)
    assert after == before

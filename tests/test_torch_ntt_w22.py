"""PyTorch port, the w22 NTT (``ops/ntt_w22.py``) against the JAX package's
v1 Pallas NTT (``pallas_ntt.ntt_fwd``/``ntt_bwd`` in interpret mode) and its
u64 ring NTT.

The JAX kernel runs at logN 10 and 12 here (at 2^14 it takes ~16 s a call on
the CPU); the port's wrappers take the plain path on a CPU tensor.  The
tolerance is exact equality.  The CUDA kernel runs only on a card:
tests/test_torch_ntt_cuda.py holds it against the plain version.
"""

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import mxu_ntt, pallas_ntt, rings
from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_w22


# 2^14 has 11 such primes: both packages list them all and refuse a 12th
@pytest.mark.parametrize("n,count", [(1 << 8, 8), (1 << 10, 10), (1 << 14, 11)])
def test_prime_lists_match_jax(n, count):
    assert ntt_w22.find_w22_primes(n, count) == mxu_ntt.find_w22_primes(n, count)
    assert ntt_w22.MAX_W22_MODULUS == mxu_ntt.MAX_W22_MODULUS
    if n == 1 << 14:
        for find in (ntt_w22.find_w22_primes, mxu_ntt.find_w22_primes):
            with pytest.raises(ValueError):
                find(n, count + 1)


@pytest.mark.parametrize("logn", [10, 12])
def test_w22_ntt_matches_jax_kernel_and_u64_ring(logn):
    n, limbs, batch = 1 << logn, 3, 8
    moduli = ntt_w22.find_w22_primes(n, limbs)
    rng = np.random.default_rng(logn)
    hi = np.array(moduli, dtype=np.int64)[:, None]
    x = (rng.integers(0, 1 << 62, (batch, limbs, n)) % hi).astype(np.int32)
    x[0, :, :3] = hi - 1  # worst-case magnitudes
    tabs = ntt_w22.build_tables(n, moduli, "cpu")

    got_f = ntt_w22.ntt_fwd(torch.from_numpy(x), tabs)
    got_b = ntt_w22.ntt_bwd(torch.from_numpy(x), tabs)
    assert got_f.dtype == torch.int32 and got_f.shape == x.shape
    assert torch.equal(ntt_w22.ntt_bwd(got_f, tabs), torch.from_numpy(x))

    jtabs = pallas_ntt.build_tables(n, moduli)
    np.testing.assert_array_equal(
        got_f.numpy(), np.asarray(pallas_ntt.ntt_fwd(x, jtabs, interpret=True)))
    np.testing.assert_array_equal(
        got_b.numpy(), np.asarray(pallas_ntt.ntt_bwd(x, jtabs, interpret=True)))
    # the u64 ring's NTT (its inverse is pinned by the round trip above)
    ring = rings.new_ring(n, moduli, rings.STANDARD)
    np.testing.assert_array_equal(
        got_f.numpy().astype(np.uint64),
        np.asarray(jax.jit(rings.Ring.ntt)(ring, x.astype(np.uint64))))


def test_w22_tables_and_wrappers_check_their_input():
    n = 1 << 6
    with pytest.raises(ValueError):
        ntt_w22.build_tables(n, [ntt_cuda.find_v2_primes(n, 1)[0]], "cpu")  # > 2^22
    moduli = ntt_w22.find_w22_primes(n, 2)
    tabs = ntt_w22.build_tables(n, moduli, "cpu")
    assert isinstance(tabs, ntt_cuda.NTTTables)
    assert isinstance(tabs.sliced(slice(0, 1)), ntt_w22.W22Tables)
    x = torch.zeros((2, n), dtype=torch.int32)
    before = (ntt_w22.w22_fwd_launches, ntt_w22.w22_bwd_launches, ntt_cuda.launches)
    assert torch.equal(ntt_w22.ntt_fwd(x, tabs), x)
    with pytest.raises(TypeError):
        ntt_w22.ntt_fwd(x, ntt_cuda.build_tables(n, moduli, "cpu"))  # not w22 tables
    with pytest.raises(TypeError):
        ntt_w22.ntt_bwd(x.to(torch.int64), tabs)
    with pytest.raises(ValueError):
        ntt_w22.ntt_bwd(x[:1], tabs)
    assert (ntt_w22.w22_fwd_launches, ntt_w22.w22_bwd_launches, ntt_cuda.launches) == before

"""PyTorch port, ring tables and NTT: held bit-exact against the JAX package.

The JAX side of every NTT comparison is its CPU reference, as in
tests/test_pallas_ntt2.py: the MXU-form NTT (ops/mxu_ntt.py) and the u64
ring NTT (ops/rings.py).  The CUDA kernel itself runs only on a card:
tests/test_torch_ntt_cuda.py holds it against the plain version there.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import automorphism as j_auto
from matrix_fhe_tpu.ops import mxu_ntt, pallas_ntt2, rings
from matrix_fhe_tpu.utils import primes as j_primes
from matrix_fhe_tpu_torch.ops import automorphism as t_auto
from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain, tables
from matrix_fhe_tpu_torch.utils import primes as t_primes

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = ("import sys, matrix_fhe_tpu_torch.fast.fckks, "
            "matrix_fhe_tpu_torch.ops.ntt_w22; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("n,count", [(1 << 8, 8), (1 << 10, 10), (1 << 14, 22)])
def test_prime_lists_match_jax(n, count):
    got = ntt_cuda.find_v2_primes(n, count)
    assert got == pallas_ntt2.find_v2_primes(n, count)
    assert ntt_cuda.MAX_V2_MODULUS == pallas_ntt2.MAX_V2_MODULUS
    for q in got:
        assert t_primes.primitive_root(q) == j_primes.primitive_root(q)


def test_prime_helpers_match_jax():
    for v in (2, 97, 7681, 8380417, 8380419, (1 << 61) - 1, 1 << 40):
        assert t_primes.is_prime(v) == j_primes.is_prime(v)
        assert t_primes.factor(v - 1) == j_primes.factor(v - 1)
    for bits, nth in ((20, 512), (23, 1 << 15)):
        a = t_primes.NTTFriendlyPrimesGenerator(bits, nth)
        b = j_primes.NTTFriendlyPrimesGenerator(bits, nth)
        assert a.next_alternating_primes(6) == b.next_alternating_primes(6)
        assert a.next_upstream_primes(2) == b.next_upstream_primes(2)
        assert a.next_downstream_primes(2) == b.next_downstream_primes(2)


@pytest.mark.parametrize("n", [1 << 8, 1 << 9])
def test_four_step_factors_match_jax(n):
    for q in ntt_cuda.find_v2_primes(n, 2):
        psi = tables.root_2n(n, q)
        for got, want in zip(ntt_plain.four_step_factors(n, q, psi),
                             mxu_ntt.four_step_factors(n, q, psi)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1 << 4, 1 << 8, 1 << 9])
def test_psi_tables_match_jax_ring(n):
    """Plain tables == the JAX ring's Montgomery tables times 2^-64."""
    for q in ntt_cuda.find_v2_primes(n, 2):
        ref = rings._gen_subring_tables(n, 2 * n, q, False)
        r64 = pow(2, -64, q)
        fwd, bwd = tables.psi_tables(n, q, tables.root_2n(n, q))
        for got, mont in ((fwd, ref["roots_fwd"]), (bwd, ref["roots_bwd"])):
            want = [int(v) * r64 % q for v in mont]
            np.testing.assert_array_equal(got, np.array(want, dtype=np.int64))
    assert [tables.bit_reverse(i, 5) for i in range(32)] == \
        [rings.bit_reverse(i, 5) for i in range(32)]


def test_shoup_quotients():
    q = 8380417
    w = np.array([0, 1, 2, q // 2, q - 1], dtype=np.int64)
    got = tables.shoup(w, q)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got.astype(np.int64),
                                  [(int(v) << 32) // q for v in w])


# logN 8 and 14 split square, 9 odd (R = 16, C = 32); batch and limbs small
@pytest.mark.parametrize("logn,batch,limbs", [(8, 3, 3), (9, 2, 2), (14, 2, 2)])
def test_plain_ntt_matches_jax(logn, batch, limbs):
    n = 1 << logn
    moduli = ntt_cuda.find_v2_primes(n, limbs)
    rng = np.random.default_rng(logn)
    x = np.stack([np.stack([rng.integers(0, q, n) for q in moduli])
                  for _ in range(batch)]).astype(np.int32)
    x[0, :, :3] = np.array(moduli)[:, None] - 1  # worst-case magnitudes
    tabs = ntt_cuda.build_tables(n, moduli, "cpu")

    got_f = ntt_plain.ntt_fwd_plain(torch.from_numpy(x), tabs).numpy()
    got_b = ntt_plain.ntt_bwd_plain(torch.from_numpy(got_f), tabs).numpy()
    assert got_f.dtype == np.int32
    np.testing.assert_array_equal(got_b, x)

    mx = mxu_ntt.build_tables(n, moduli)
    np.testing.assert_array_equal(
        got_f, np.asarray(jax.jit(mxu_ntt.ntt_fwd)(x, mx)))
    np.testing.assert_array_equal(
        got_b, np.asarray(jax.jit(mxu_ntt.ntt_bwd)(got_f, mx)))
    ring = rings.new_ring(n, moduli, rings.STANDARD)
    np.testing.assert_array_equal(
        got_f.astype(np.uint64),
        np.asarray(jax.jit(rings.Ring.ntt)(ring, x.astype(np.uint64))))
    np.testing.assert_array_equal(
        got_b.astype(np.uint64),
        np.asarray(jax.jit(rings.Ring.intt)(ring, got_f.astype(np.uint64))))


def test_wrapper_takes_plain_path_on_cpu():
    n, moduli = 1 << 6, ntt_cuda.find_v2_primes(1 << 6, 2)
    tabs = ntt_cuda.build_tables(n, moduli, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, min(moduli), (2, n)).astype(np.int32))
    before = (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches, ntt_cuda.launches)
    assert torch.equal(ntt_cuda.ntt_fwd(x, tabs), ntt_plain.ntt_fwd_plain(x, tabs))
    assert torch.equal(ntt_cuda.ntt_bwd(x, tabs), ntt_plain.ntt_bwd_plain(x, tabs))
    # the CPU path launches no kernel
    assert (ntt_cuda.fwd_launches, ntt_cuda.bwd_launches, ntt_cuda.launches) == before


def test_table_slices_are_per_limb():
    n, moduli = 1 << 5, ntt_cuda.find_v2_primes(1 << 5, 4)
    full = ntt_cuda.build_tables(n, moduli, "cpu")
    band = full.sliced(slice(1, 3))
    ref = ntt_cuda.build_tables(n, moduli[1:3], "cpu")
    assert band.num_limbs == 2
    assert band.psi.is_contiguous() and band.ipsi_shoup.is_contiguous()
    for f in ("psi", "psi_shoup", "ipsi", "ipsi_shoup", "ninv", "ninv_shoup",
              "fs_a", "fs_t", "fs_bt", "fs_ainv", "fs_tinv", "fs_binvt"):
        assert torch.equal(getattr(band, f), getattr(ref, f)), f


@pytest.mark.parametrize("n,gal_el", [(1 << 4, 5), (1 << 8, 5), (1 << 8, 25),
                                      (1 << 8, 2 * (1 << 8) - 1),
                                      (1 << 10, 3125)])
def test_automorphism_index_matches_jax(n, gal_el):
    np.testing.assert_array_equal(
        t_auto.automorphism_ntt_index(n, 2 * n, gal_el),
        j_auto.automorphism_ntt_index(n, 2 * n, gal_el))

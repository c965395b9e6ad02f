"""PyTorch port, 64-bit modular arithmetic on int64 words: held bit-exact
against the JAX package's uint64 primitives (tests/test_modmath.py's cases),
with q of 45, 55 and 61 bits, values near 2^61 and full 64-bit words."""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import modmath as jm
from matrix_fhe_tpu.utils import primes as pr
from matrix_fhe_tpu_torch.ops import modmath as tm

QS = [pr.NTTFriendlyPrimesGenerator(45, 1 << 8).next_alternating_prime(),
      pr.NTTFriendlyPrimesGenerator(55, 1 << 8).next_alternating_prime(),
      0x1FFFFFFFFFE00001]  # 61 bits, just below 2^61


def _t(a: np.ndarray) -> torch.Tensor:
    """uint64 words as the port's int64 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _w(v: int) -> torch.Tensor:
    return torch.tensor(tm.signed(v))


def _operands(q, seed):
    rng = np.random.default_rng(seed)
    n = 512
    x = rng.integers(0, q, n, dtype=np.uint64)
    y = rng.integers(0, q, n, dtype=np.uint64)
    # the top of the range: values within 2^20 of q, and of 2^61
    x[:64] = np.uint64(q) - rng.integers(1, 1 << 20, 64, dtype=np.uint64)
    y[64:128] = np.uint64(q) - rng.integers(1, 1 << 20, 64, dtype=np.uint64)
    big = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)
    big[:64] = np.uint64(1 << 61) - rng.integers(0, 1 << 20, 64, dtype=np.uint64)
    big[64:72] = np.iinfo(np.uint64).max - np.arange(8, dtype=np.uint64)
    return x, y, big


@pytest.mark.parametrize("q", QS, ids=["q45", "q55", "q61"])
def test_constants_match_jax(q):
    assert pr.is_prime(q)
    assert tm.gen_mred_constant(q) == jm.gen_mred_constant(q)
    assert tm.gen_bred_constant(q) == jm.gen_bred_constant(q)


@pytest.mark.parametrize("q", QS, ids=["q45", "q55", "q61"])
def test_primitives_match_jax(q):
    x, y, big = _operands(q, q % 1000)
    qinv = jm.gen_mred_constant(q)
    bhi, blo = jm.gen_bred_constant(q)
    jq, jqi, jbh, jbl = (np.uint64(v) for v in (q, qinv, bhi, blo))
    tq, tqi, tbh, tbl = (_w(v) for v in (q, qinv, bhi, blo))
    X, Y, B = _t(x), _t(y), _t(big)
    pairs = [
        (tm.mred(X, Y, tq, tqi), jm.mred(jm.u64(x), jm.u64(y), jq, jqi)),
        (tm.mred_lazy(X, Y, tq, tqi), jm.mred_lazy(jm.u64(x), jm.u64(y), jq, jqi)),
        (tm.bred(X, Y, tq, tbh, tbl), jm.bred(jm.u64(x), jm.u64(y), jq, jbh, jbl)),
        (tm.bred_lazy(X, Y, tq, tbh, tbl), jm.bred_lazy(jm.u64(x), jm.u64(y), jq, jbh, jbl)),
        (tm.bred_add(B, tq, tbh), jm.bred_add(jm.u64(big), jq, jbh)),
        (tm.mform(X, tq, tbh, tbl), jm.mform(jm.u64(x), jq, jbh, jbl)),
        (tm.imform(X, tq, tqi), jm.imform(jm.u64(x), jq, jqi)),
        (tm.mul64_hi(B, X), jm.mul64_hi(jm.u64(big), jm.u64(x))),
        (tm.mul64_hi(B, B.flip(0)), jm.mul64_hi(jm.u64(big), jm.u64(big[::-1]))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    s, c = tm.add64_carry(B, B.flip(0))
    js, jc = jm.add64_carry(jm.u64(big), jm.u64(big[::-1]))
    np.testing.assert_array_equal(_u(s), np.asarray(js))
    np.testing.assert_array_equal(_u(c), np.asarray(jc))
    assert int(c.sum()) > 0  # some sums carried
    np.testing.assert_array_equal(_u(tm.bred_add(B, tq, tbh)), big % np.uint64(q))
    # the MForm / IMForm round trip
    np.testing.assert_array_equal(_u(tm.imform(tm.mform(X, tq, tbh, tbl), tq, tqi)), x)


@pytest.mark.parametrize("q", QS, ids=["q45", "q55", "q61"])
def test_modsum_matches_jax(q):
    bhi, _ = jm.gen_bred_constant(q)
    rng = np.random.default_rng(1)
    for width in (1, 7, 100):
        x = rng.integers(0, 2 * q, (3, width), dtype=np.uint64)
        got = tm.modsum(_t(x), tm.signed(q), tm.signed(bhi), dim=-1)
        want = np.asarray(jm.modsum(jm.u64(x), np.uint64(q), np.uint64(bhi), axis=-1))
        np.testing.assert_array_equal(_u(got), want)
        np.testing.assert_array_equal(
            _u(got), np.array([sum(int(v) for v in row) % q for row in x], dtype=np.uint64))


def test_word_conversions_and_modulus_bound():
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        assert tm.unsigned(tm.signed(v)) == v
    assert tm.signed((1 << 64) - 1) == -1
    tm.check_modulus(QS[2])
    for bad in (1 << 61, (1 << 62) + 1, 1):
        with pytest.raises(ValueError, match="2\\^61"):
            tm.check_modulus(bad)

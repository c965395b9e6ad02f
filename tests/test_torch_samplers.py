"""PyTorch port, the samplers (ops/samplers.py).

torch's random streams are not JAX's threefry streams, so the samplers are
held to their distributions, not to the JAX package's bits: values in range,
the bound and the exact Hamming weight hold always, the ternary density and
the Gaussian sigma hold within the tolerances stated below, and one seed
gives the same arrays.  (Bit-exactness of everything downstream is held by
handing the port the arrays JAX sampled: tests/test_torch_rlwe.py.)"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu_torch.ops import rings as tr
from matrix_fhe_tpu_torch.ops import samplers as smp
from matrix_fhe_tpu_torch.utils import primes as pr

N = 1024
BATCH = (64,)  # 65536 draws a distribution


@pytest.fixture(scope="module")
def ring():
    # a 45-bit prime and one just above a power of two: the mask-and-reject
    # loop rejects about half of the second limb's draws
    g = pr.NTTFriendlyPrimesGenerator(33, 2 * N)
    above = next(p for p in iter(g.next_upstream_prime, None) if p > 1 << 33)
    q45 = pr.NTTFriendlyPrimesGenerator(45, 2 * N).next_alternating_prime()
    return tr.new_ring(N, [q45, above], device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _centered(ring, x):
    q = ring.moduli[:, None]
    return torch.where(x > q // 2, x - q, x)


def test_uniform(ring):
    x = smp.uniform_poly(_gen(0), ring, BATCH)
    assert x.shape == BATCH + (2, N) and x.dtype == torch.int64
    q = ring.moduli[:, None]
    assert bool(((x >= 0) & (x < q)).all())
    # mean of U[0, q) is q/2 with std q/sqrt(12 * 65536): within 1%
    mean = x.double().mean(dim=(0, 2)) / ring.moduli.double()
    assert torch.allclose(mean, torch.full_like(mean, 0.5), atol=0.01), mean
    assert torch.equal(x, smp.uniform_poly(_gen(0), ring, BATCH))
    assert not torch.equal(x, smp.uniform_poly(_gen(1), ring, BATCH))


def test_gaussian(ring):
    xe = smp.DiscreteGaussian(sigma=3.2, bound=19.2)
    x = smp.gaussian_poly(_gen(2), ring, xe, BATCH)
    v = _centered(ring, x)
    assert torch.equal(v[:, 0], v[:, 1])  # the same small values on every limb
    assert int(v.abs().max()) <= 19
    # rounding adds 1/12 to the variance: sd sqrt(3.2^2 + 1/12) = 3.213;
    # the sample sd of 65536 draws lies within 2% of it
    sd = float(v[:, 0].double().std())
    assert abs(sd / np.sqrt(3.2 ** 2 + 1 / 12) - 1) < 0.02, sd
    assert abs(float(v[:, 0].double().mean())) < 0.05
    assert torch.equal(x, smp.gaussian_poly(_gen(2), ring, xe, BATCH))
    # a tight bound forces the redraw loop; nothing escapes it
    tight = smp.gaussian_poly(_gen(3), ring, smp.DiscreteGaussian(sigma=3.2, bound=2.0), BATCH)
    assert int(_centered(ring, tight).abs().max()) <= 2
    mont = smp.gaussian_poly(_gen(2), ring, xe, BATCH, montgomery=True)
    assert torch.equal(mont, ring.mform(x))


@pytest.mark.parametrize("p", [2 / 3, 0.1])
def test_ternary_density(ring, p):
    x = smp.ternary_poly(_gen(4), ring, smp.Ternary(p=p), BATCH)
    v = _centered(ring, x)
    assert torch.equal(v[:, 0], v[:, 1])
    assert set(v.unique().tolist()) <= {-1, 0, 1}
    # the nonzero share has sd sqrt(p (1-p) / 65536) < 0.002: within 0.01
    nz = v[:, 0] != 0
    assert abs(float(nz.double().mean()) - p) < 0.01
    # +1 and -1 equally likely: their mean over the nonzero entries within 0.03
    assert abs(float(v[:, 0][nz].double().mean())) < 0.03
    assert torch.equal(x, smp.ternary_poly(_gen(4), ring, smp.Ternary(p=p), BATCH))


def test_ternary_hamming_weight(ring):
    h = 192
    x = smp.ternary_poly(_gen(5), ring, smp.Ternary(h=h), BATCH)
    v = _centered(ring, x)
    assert set(v.unique().tolist()) <= {-1, 0, 1}
    assert ((v[:, 0] != 0).sum(dim=-1) == h).all()
    assert not torch.equal(v[0, 0] != 0, v[1, 0] != 0)  # rows permuted independently
    assert abs(float(v[:, 0][v[:, 0] != 0].double().mean())) < 0.03
    assert torch.equal(x, smp.ternary_poly(_gen(5), ring, smp.Ternary(h=h), BATCH))
    with pytest.raises(ValueError):
        smp.ternary_poly(_gen(5), ring, smp.Ternary(h=N + 1))


def test_sample_dispatch(ring):
    xs, xe = smp.Ternary(p=0.5), smp.DiscreteGaussian(3.2, 19.2)
    assert torch.equal(smp.sample(_gen(6), ring, xs), smp.ternary_poly(_gen(6), ring, xs))
    assert torch.equal(smp.sample(_gen(6), ring, xe, montgomery=True),
                       smp.gaussian_poly(_gen(6), ring, xe, montgomery=True))
    with pytest.raises(TypeError):
        smp.sample(_gen(6), ring, None)

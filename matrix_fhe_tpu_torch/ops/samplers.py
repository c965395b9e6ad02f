"""Polynomial samplers drawing from an explicit ``torch.Generator``.

Counterpart of ``matrix_fhe_tpu/ops/samplers.py`` (the reference's
ring/sampler*.go).  The distributions are the reference's; the byte streams
are torch's, so they differ from the JAX package's threefry streams and
from the reference's blake2b XOF.  Randomness is not part of the
bit-exactness contract: the port is held against the JAX package by handing
both the same sampled arrays (``rlwe/keys.py`` and ``rlwe/encryptor.py``
split every generator into a sampling part and a deterministic part).

Every draw runs on the generator's device and the result moves to the
ring's device afterwards, so a CPU generator with one seed gives the same
arrays whatever device the ring lives on.

Distributions (ring/sampler.go:102-139):
  * uniform: rejection sampling on masked words (sampler_uniform.go:46);
  * discrete Gaussian (sigma, bound): round(|N(0, sigma^2)|) rejected at the
    bound, with a random sign (sampler_gaussian.go:159-175);
  * ternary with density p: P(0) = 1-p, P(+-1) = p/2 each;
  * ternary with Hamming weight h: exactly h uniform +-1 entries.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from matrix_fhe_tpu_torch.ops.rings import Ring


@dataclasses.dataclass(frozen=True)
class DiscreteGaussian:
    """ring/sampler.go:102: sigma = std-dev, bound = max abs coefficient."""
    sigma: float
    bound: float


@dataclasses.dataclass(frozen=True)
class Ternary:
    """ring/sampler.go:126: exactly one of (p, h) set; p = nonzero density,
    h = Hamming weight."""
    p: float | None = None
    h: int | None = None


Distribution = Union[DiscreteGaussian, Ternary, None]


def _bits(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform 62-bit words (moduli are below 2^61, so masks keep <= 61)."""
    return torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                         device=gen.device)


def _signs(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen, dtype=torch.int64,
                         device=gen.device)


def uniform_poly(gen: torch.Generator, ring: Ring, batch: tuple[int, ...] = ()
                 ) -> torch.Tensor:
    """Uniform in [0, q_i) per limb, exact: masked words, each one >= q_i
    drawn again (only those) until none is left."""
    shape = batch + (ring.num_limbs, ring.n)
    q = torch.tensor(ring.moduli_tuple, dtype=torch.int64, device=gen.device)
    mask = torch.tensor([(1 << m.bit_length()) - 1 for m in ring.moduli_tuple],
                        dtype=torch.int64, device=gen.device)
    x = _bits(gen, shape) & mask[:, None]
    # the rejected words by flat position, ascending (a boolean mask's
    # order), with their moduli and masks: each round redraws and tests
    # only those, so it costs what is left, not the whole polynomial
    pos = torch.nonzero((x >= q[:, None]).view(-1)).view(-1)
    limb = torch.div(pos, ring.n, rounding_mode="floor") % ring.num_limbs
    q, mask = q[limb], mask[limb]
    flat = x.view(-1)
    while pos.numel():
        flat[pos] = redrawn = _bits(gen, (pos.numel(),)) & mask
        left = torch.nonzero(redrawn >= q).view(-1)
        pos, q, mask = pos[left], q[left], mask[left]
    return x.to(ring.device)


def _lift_small(ring: Ring, vals: torch.Tensor) -> torch.Tensor:
    """Small signed integers [.., N] -> their residues [.., L, N] on the ring."""
    v = vals.to(ring.device)[..., None, :]
    q = ring.moduli[:, None]
    return torch.where(v < 0, q + v, v)


def gaussian_poly(gen: torch.Generator, ring: Ring, xe: DiscreteGaussian,
                  batch: tuple[int, ...] = (), montgomery: bool = False) -> torch.Tensor:
    """Truncated rounded Gaussian, the same on every RNS limb: |N(0,1)|*sigma
    in float32, drawn again while above the bound, rounded as
    trunc(mag + 0.5), with a random sign."""
    shape = batch + (ring.n,)

    def draw():
        mag = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=gen.device).abs() * xe.sigma
        return mag, _signs(gen, shape)

    mag, sign = draw()
    while bool((mag > xe.bound).any()):
        m2, s2 = draw()
        bad = mag > xe.bound
        mag, sign = torch.where(bad, m2, mag), torch.where(bad, s2, sign)
    v = (mag + 0.5).to(torch.int64)  # round
    out = _lift_small(ring, torch.where(sign == 1, v, -v))
    return ring.mform(out) if montgomery else out


def ternary_poly(gen: torch.Generator, ring: Ring, xs: Ternary,
                 batch: tuple[int, ...] = (), montgomery: bool = False) -> torch.Tensor:
    """Ternary secret distribution; values in {-1, 0, 1} lifted to each limb."""
    shape = batch + (ring.n,)
    signs = 1 - 2 * _signs(gen, shape)
    if xs.h is not None:
        if not 0 <= xs.h <= ring.n:
            raise ValueError(f"Hamming weight {xs.h} outside [0, {ring.n}]")
        rows = signs.reshape(-1, ring.n)
        # an independent permutation a row: the h nonzero positions
        pos = torch.stack([torch.randperm(ring.n, generator=gen, device=gen.device)[:xs.h]
                           for _ in range(rows.shape[0])])
        keep = torch.zeros_like(rows).scatter_(1, pos, 1)
        vals = (rows * keep).reshape(shape)
    else:
        p = 2.0 / 3.0 if xs.p is None else xs.p
        nonzero = torch.rand(shape, generator=gen, dtype=torch.float32,
                             device=gen.device) < p
        vals = torch.where(nonzero, signs, 0)
    out = _lift_small(ring, vals)
    return ring.mform(out) if montgomery else out


def sample(gen: torch.Generator, ring: Ring, x: Distribution,
           montgomery: bool = False) -> torch.Tensor:
    """Dispatch on the distribution's type (ring/sampler.go:64 NewSampler)."""
    if isinstance(x, DiscreteGaussian):
        return gaussian_poly(gen, ring, x, montgomery=montgomery)
    if isinstance(x, Ternary):
        return ternary_poly(gen, ring, x, montgomery=montgomery)
    raise TypeError(f"unsupported distribution {x!r}")

"""Multiparty share aggregation over a mesh: a psum over the party axis.

Counterpart of ``matrix_fhe_tpu/multiparty/mesh.py``.  The reference
aggregates shares pairwise on a host (``AggregateShares``,
multiparty/keygen_cpk.go:86) and leaves the transport to the caller.  With
the parties laid out over a "party" axis of a mesh (one rank a party), the
aggregation is one ``psum`` (SURVEY sections 3.5 and 5.8): each rank
generates its party's share locally, the integer all-reduce sums the
canonical share words (below n_parties * q < 2^52, exact in int64), and one
Barrett reduction restores [0, q), bit-identical to the sequential
aggregation.

The randomised call is split as the port splits every one:
``sample_collective_pk_over_mesh`` draws each party's secret and noise, and
``collective_pk_over_mesh_from_samples`` runs the protocol on given draws
(the tests hand it the arrays the JAX package draws).
"""

from __future__ import annotations

import dataclasses

import torch

from matrix_fhe_tpu_torch.multiparty.protocols import PublicKeyGen
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.parallel import api
from matrix_fhe_tpu_torch.rlwe import keys as K
from matrix_fhe_tpu_torch.rlwe.params import Parameters

# n_parties * q must stay below the bound of the exact integer psum
PSUM_BOUND = 1 << 52


@dataclasses.dataclass(frozen=True)
class PartySample:
    """One party's draws: its secret's coefficients [LQ, N] (from Xs) and
    its share's noise [LQ, N] (from Xe)."""
    secret: torch.Tensor
    noise: torch.Tensor


def sample_collective_pk_over_mesh(params: Parameters, n_parties: int,
                                   generator: torch.Generator) -> list[PartySample]:
    """Each party's secret and noise, drawn in turn from ``generator``."""
    return [PartySample(secret=K.sample_secret(generator, params),
                        noise=PublicKeyGen.sample_share(generator, params))
            for _ in range(n_parties)]


def _psum_mod(x: torch.Tensor, ring, mesh: api.Mesh, axis: str) -> torch.Tensor:
    """Exact modular psum: an integer all-reduce, then one Barrett reduction
    (needs n_parties * max(q) < 2^52)."""
    total = api.psum(x, mesh, axis)
    return mm.bred_add(total, ring.moduli[:, None], ring.bhi[:, None])


def collective_pk_over_mesh_from_samples(params: Parameters, mesh: api.Mesh,
                                         samples: list[PartySample], crp: K.QPPoly,
                                         axis: str = "party"
                                         ) -> tuple[K.PublicKey, K.SecretKey]:
    """Collective public-key generation with the parties over ``axis``:
    this rank makes its party's secret key and share from ``samples[its
    index]``, and the shares are aggregated with ONE psum for each of the Q
    and P planes.  Returns the collective public key (on every rank) and
    this rank's secret key."""
    n_parties = mesh.shape[axis]
    if float(n_parties) * max(list(params.q) + list(params.p or ())) >= PSUM_BOUND:
        raise ValueError("psum aggregation bound: n_parties * q < 2^52")
    if len(samples) != n_parties:
        raise ValueError(f"{len(samples)} parties' draws for a party axis of {n_parties}")
    mine = samples[mesh.index(axis)]
    sk = K.secret_key_from_sample(params, mine.secret.to(params.device))
    share = PublicKeyGen.share_from_sample(params, sk, crp, mine.noise.to(params.device))
    agg = K.QPPoly(q=_psum_mod(share.q, params.ring_q, mesh, axis),
                   p=None if share.p is None else _psum_mod(share.p, params.ring_p, mesh, axis))
    return PublicKeyGen.finalize(params, agg, crp), sk

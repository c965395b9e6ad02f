"""Mesh, shardings and the counted collectives of the multi-device code.

Counterpart of ``matrix_fhe_tpu/parallel/api.py`` and of the ``jax.lax``
collectives its ``shard_map`` bodies call.  A JAX program is one process over
a ``jax.sharding.Mesh`` of devices; here each device of the mesh is one
process (a rank of ``torch.distributed``), started by ``parallel/launch.py``
or by the caller, and every tensor is that rank's local block, a plain
tensor.  Nothing is a DTensor: the whole point of the JAX package's
explicit-collective step (``fast_sharded.py``) is that every exchange is
written out and countable, and so it is here.

``make_mesh`` lays named axes over the ranks of the initialized default
process group, row-major, and makes one ``dist.new_group`` a slice of each
axis (the ranks that differ only in that axis' coordinate), in the same order
on every rank.  ``init_device_mesh`` is not used: on one card the ranks
share a device and run over gloo, which it would have to be told, and the
groups are all a mesh needs here.

The collectives, each ONE ``torch.distributed`` call on the axis' group:

  * ``all_gather(x, mesh, axis, dim)``: ``jax.lax.all_gather(..., tiled=True)``,
    the blocks concatenated along ``dim`` in the axis' order;
  * ``psum(x, mesh, axis)``: ``jax.lax.psum``, an integer sum;
  * ``all_to_all(x, mesh, axis, dim)``: block j of ``x`` along ``dim`` goes to
    the axis' rank j; returns the k received blocks stacked on a new first
    dim.  With a modular sum of those blocks it is the combine that
    ``jax.lax.psum_scatter`` does (``parallel/ntt_sharded.py``).

Each adds one to its entry of ``counts`` (a per-process tally that tests and
``chip_smoke.py`` read: the counterpart of counting collectives in the
compiled HLO).  Transport: over NCCL a tensor goes as it is.  Over gloo a
CUDA tensor always goes through host memory (copied out, the collective on
the copy, copied back): that is the gloo path of these helpers, not a
fallback taken on failure.  NCCL takes one rank a device, so several ranks
on one card run over gloo.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from matrix_fhe_tpu_torch.utils.device import resolve_device

# Collective calls since the counts were last reset, by kind.
counts = {"all_gather": 0, "psum": 0, "all_to_all": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the default process group, as seen by
    one rank: its coordinate on each axis, the group of each axis' slice it
    belongs to, and the device it computes on."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple                       # this rank's group, an axis each
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device this rank computes on: ``cuda:(rank % cards)`` on the
    card (several ranks share a card when there are fewer cards than
    ranks), else the CPU.  Raises without a card unless asked for the CPU."""
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        rank = dist.get_rank() if dist.is_initialized() else 0
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(axes: dict[str, int] | None = None, device_type: str = "cuda") -> Mesh:
    """Mesh over the ranks of the initialized default process group.
    Default: one "batch" axis over all ranks (pure data parallelism); pass
    e.g. {"batch": 2, "limb": 4} for a 2-D mesh.  Every rank must call it,
    with the same axes (each axis slice's group is made by all ranks)."""
    device = rank_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if axes is None:
        axes = {"batch": world}
    names, sizes = tuple(axes), tuple(int(s) for s in axes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {axes} does not cover the {world} ranks")
    layout = np.arange(world).reshape(sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups = []
    for a in range(len(sizes)):
        mine = None
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(a, slice(None))
            ranks = [int(r) for r in layout[tuple(index)]]
            g = dist.new_group(ranks)  # collective: every rank makes every group
            if rank in ranks:
                mine = g
        groups.append(mine)
    return Mesh(axis_names=names, axis_sizes=sizes, coords=coords, groups=tuple(groups),
                device=device)


def batch_sharding(mesh: Mesh, ndim: int) -> dict[str, int]:
    """Which dim each mesh axis splits: the leading (batch) dim over
    "batch", the rest replicated."""
    return {"batch": 0}


def limb_sharding(mesh: Mesh, ndim: int, limb_axis: int = -2) -> dict[str, int]:
    """The RNS limb dim (second-to-last by convention: [..., L, N]) over
    "limb", and the leading dim over "batch" where the mesh has that axis
    and the array a batch dim."""
    spec = {"limb": limb_axis % ndim}
    if "batch" in mesh.axis_names and ndim >= 3:
        spec["batch"] = 0
    return spec


def local_block(mesh: Mesh, x: torch.Tensor, spec: dict[str, int]) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (axis ->
    dim), on the mesh's device."""
    for axis, dim in spec.items():
        k = mesh.shape[axis]
        if x.shape[dim] % k:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                             f"{k} ranks of axis {axis!r}")
        size = x.shape[dim] // k
        x = x.narrow(dim, mesh.index(axis) * size, size)
    return x.contiguous().to(mesh.device)


def shard_ciphertext_batch(mesh: Mesh, ct_values: tuple, limbs: bool = False) -> tuple:
    """This rank's blocks of a batch of ciphertext component arrays
    [B, L, N]: split over "batch", or with ``limbs`` over "limb" (and
    "batch")."""
    def spec(v):
        if limbs and "limb" in mesh.axis_names:
            return limb_sharding(mesh, v.ndim)
        return batch_sharding(mesh, v.ndim)
    return tuple(local_block(mesh, v, spec(v)) for v in ct_values)


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

def _via_host(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of all ranks of ``axis`` concatenated along ``dim``."""
    g = mesh.group(axis)
    k = mesh.shape[axis]
    src = torch.movedim(x, dim, 0).contiguous()
    host = _via_host(g, src)
    if host:
        src = src.cpu()
    out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather(list(out.chunk(k)), src, group=g)  # into views of out
    counts["all_gather"] += 1
    if host:
        out = out.to(x.device)
    return torch.movedim(out, 0, dim)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The integer sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    g = mesh.group(axis)
    host = _via_host(g, x)
    out = x.cpu() if host else x.clone()
    out = out.contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    counts["psum"] += 1
    return out.to(x.device) if host else out


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Split ``x`` into k blocks along ``dim`` and send block j to rank j of
    ``axis``: returns [k, *block], block i being what rank i sent this one."""
    g = mesh.group(axis)
    k = mesh.shape[axis]
    if x.shape[dim] % k:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {k} ranks")
    blocks = torch.stack(torch.chunk(x, k, dim=dim)).contiguous()
    host = _via_host(g, blocks)
    if host:
        blocks = blocks.cpu()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=g)
    counts["all_to_all"] += 1
    return out.to(x.device) if host else out

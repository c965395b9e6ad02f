"""Coefficient-axis-sharded NTT: the multi-device four-step transform.

Counterpart of ``matrix_fhe_tpu/parallel/ntt_sharded.py``.  In four-step
form, OUT = (T .* (A @ X)) @ B^T with X = reshape(x, [R, C]), the column
axis C is the shard axis:

  * step 1 (A @ X) contracts over R, so each rank computes its own column
    block with no communication;
  * the twiddle product is elementwise, local;
  * step 2 (W @ B^T) contracts over the sharded axis C: each rank forms the
    partial product of its column block with its rows of B^T, a full
    [R, C] array, and the partials of all ranks sum to the output.

That local step is kernel B6 on the card and its plain version on the
CPU; both, and the tables (``ShardedNTTTables``, ``build_tables``, re-exported
here), live in ``ops/ntt_sharded_cuda.py``.  The combine is ONE collective:
an all-to-all of the k column blocks of the partial, then a modular sum of
the k blocks each rank receives, which leaves the output column-sharded as
the JAX package's ``psum_scatter`` + Barrett reduction does.  Not an int64
reduce-scatter sum: the port's words are int64 and compare signed, and at a
61-bit modulus eight canonical partials sum past 2^63; the modular sum is
exact for every modulus the sharded tables admit (< 2^61, the u64 rings'
limit, ``build_tables``) and any k <= 8.

The output equals the JAX package's ``ntt_sharded`` and the ring's NTT bit
for bit.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import ntt_sharded_cuda
from matrix_fhe_tpu_torch.ops.ntt_sharded_cuda import ShardedNTTTables, build_tables  # noqa: F401
from matrix_fhe_tpu_torch.parallel import api


def ntt_sharded(x_local: torch.Tensor, tabs: ShardedNTTTables, mesh: api.Mesh,
                axis: str = "seq") -> torch.Tensor:
    """Forward NTT with the coefficient axis sharded over ``axis``: this
    rank's column block of the [.., L, R, C] view of the input,
    [.., L, R, C/k], to the same block of the output.  Exactly one
    collective a call."""
    R, C = tabs.rows, tabs.cols
    k = mesh.shape[axis]
    if C % k:
        raise ValueError(f"C={C} must divide over {k} shards")
    c = C // k
    if x_local.shape[-2:] != (R, c):
        raise ValueError(f"block of shape {tuple(x_local.shape)} is not [.., L, {R}, {c}]")
    partial = ntt_sharded_cuda.local_step(x_local, tabs, mesh.index(axis) * c)  # B6 on the card
    got = api.all_to_all(partial, mesh, axis, dim=-1)      # [k, .., L, R, c]
    q = tabs.moduli[:, None, None]
    return mm.modsum(got, q, tabs.bhi[:, None, None], dim=0)


def ntt_reference(x: torch.Tensor, tabs: ShardedNTTTables) -> torch.Tensor:
    """Unsharded four-step NTT with the same tables and ordering, x [.., L, N]
    (the plain local step over all columns)."""
    *lead, L, N = x.shape
    out = ntt_sharded_cuda.local_step_plain(x.reshape(*lead, L, tabs.rows, tabs.cols), tabs, 0)
    return out.reshape(*lead, L, N)


def shard_columns(x: torch.Tensor, tabs: ShardedNTTTables, k: int, index: int) -> torch.Tensor:
    """Block ``index`` of k of the column axis of x [.., L, N]'s [.., L, R, C]
    view: the block ``ntt_sharded`` takes on rank ``index``."""
    *lead, L, _ = x.shape
    c = tabs.cols // k
    xb = x.reshape(*lead, L, tabs.rows, tabs.cols)
    return xb[..., index * c:(index + 1) * c].contiguous()


def gather_columns(blocks: list, tabs: ShardedNTTTables) -> torch.Tensor:
    """The [.., L, N] array of the k ranks' column blocks, in rank order."""
    full = torch.cat(list(blocks), dim=-1)
    return full.reshape(*full.shape[:-2], tabs.n)

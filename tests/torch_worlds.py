"""Rank bodies for the port's multi-rank tests: each runs in every rank of a
gloo world on the CPU, started by ``matrix_fhe_tpu_torch.parallel.launch``:

    res = launch.run(torch_worlds.ntt_world, 8, cases, device="cpu")

Each builds its inputs from the numpy arrays and arguments it is given,
makes the mesh, runs the sharded call once and returns this rank's output
(numpy) with the collectives counted during the call ("counts"), the
transport of the mesh's axis ("transport") and the rank's mesh coordinates
("coords").  A case may name its own mesh ("axes", e.g. {"batch": 2,
"limb": 4}); by default one axis spans the world.  The module imports no
jax: a spawned rank imports it by name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from matrix_fhe_tpu_torch.parallel import api


def _mesh(case: dict, axis: str, meshes: dict) -> api.Mesh:
    """The case's mesh, made once a world for each set of axes (every rank
    makes the same ones in the same order)."""
    axes = case.get("axes") or {axis: dist.get_world_size()}
    key = tuple(axes.items())
    if key not in meshes:
        meshes[key] = api.make_mesh(dict(axes), "cpu")
    return meshes[key]


def _counted(call):
    api.reset_counts()
    out = call()
    return out, dict(api.counts)


def _result(mesh: api.Mesh, axis: str, counts: dict, **out) -> dict:
    return {**out, "counts": counts, "transport": str(dist.get_backend(mesh.group(axis))),
            "coords": dict(zip(mesh.axis_names, mesh.coords))}


def select(results: list[dict], **coords) -> list[dict]:
    """The results of the ranks at ``coords`` on the axes named, in rank
    order (row-major: along the mesh's last axis)."""
    return [r for r in results if all(r["coords"][a] == c for a, c in coords.items())]


def gather_limbs(blocks: list[np.ndarray]) -> np.ndarray:
    """The whole [.., L, N] array of the ranks' limb blocks, in rank order."""
    return np.concatenate(blocks, axis=-2)


def ntt_world(cases: list[dict]) -> list[dict]:
    """``ntt_sharded`` over the "seq" axis, for each case {"n", "moduli",
    "x": [.., L, N] words}: this rank's column block of the output ("out",
    [.., L, R, C/k])."""
    from matrix_fhe_tpu_torch.parallel import ntt_sharded as sh
    res, meshes = [], {}
    for case in cases:
        mesh = _mesh(case, "seq", meshes)
        tabs = sh.build_tables(case["n"], case["moduli"], "cpu")
        x = sh.shard_columns(torch.from_numpy(case["x"]), tabs, mesh.shape["seq"],
                             mesh.index("seq"))
        out, counts = _counted(lambda: sh.ntt_sharded(x, tabs, mesh))
        res.append(_result(mesh, "seq", counts, out=out.numpy()))
    return res


def fast_world(cases: list[dict]) -> list[dict]:
    """``build_sharded_step`` over the "limb" axis on the context and
    operands of ``make_synthetic_context(logn, num_q, num_p, rescale_limbs,
    seed, num_rot)``, for each case (with "batch": B, the operands are B
    copies rolled by 0 .. B-1 along N, as tests/test_fast_sharded_smap.py
    batches them, split over a "batch" axis where the mesh has one): this
    rank's output blocks ("o0", "o1")."""
    from matrix_fhe_tpu_torch.fast import fckks
    from matrix_fhe_tpu_torch.parallel import fast_sharded
    res, meshes = [], {}
    for case in cases:
        mesh = _mesh(case, "limb", meshes)
        ctx, cts = fckks.make_synthetic_context(case["logn"], case["num_q"], case["num_p"],
                                                rescale_limbs=case["rescale_limbs"],
                                                seed=case.get("seed", 0),
                                                num_rot=case.get("num_rot", 0), device="cpu")
        if case.get("batch"):
            cts = tuple(torch.stack([torch.roll(v, b, dims=-1) for b in range(case["batch"])])
                        for v in cts)
        blocks = api.shard_ciphertext_batch(mesh, cts, limbs=True)
        fn = fast_sharded.build_sharded_step(ctx, mesh)
        (o0, o1), counts = _counted(lambda: fn(*blocks))
        res.append(_result(mesh, "limb", counts, o0=o0.numpy(), o1=o1.numpy()))
    return res


def pk_world(literal: dict, samples: list, crp: tuple) -> dict:
    """``collective_pk_over_mesh_from_samples`` over a "party" axis of all
    ranks at the CKKS literal ``literal``, each party's (secret, noise) draws
    and the common polynomial's (Q, P) draws as numpy: the collective public
    key's (Q, P) words ("pk") and this rank's secret key's ("sk")."""
    from matrix_fhe_tpu_torch.multiparty import mesh as mpm
    from matrix_fhe_tpu_torch.multiparty import protocols
    from matrix_fhe_tpu_torch.schemes import ckks
    mesh = api.make_mesh({"party": dist.get_world_size()}, "cpu")
    params = ckks.new_parameters(ckks.CKKSParametersLiteral(**literal), "cpu")
    draws = [mpm.PartySample(secret=torch.from_numpy(s), noise=torch.from_numpy(e))
             for s, e in samples]
    crp_qp = protocols.crp_qp_from_samples(params, *(torch.from_numpy(a) for a in crp))
    (pk, sk), counts = _counted(
        lambda: mpm.collective_pk_over_mesh_from_samples(params, mesh, draws, crp_qp))

    def words(qp):
        return tuple(None if v is None else v.numpy() for v in (qp.q, qp.p))
    return _result(mesh, "party", counts, pk=words(pk.value[0]), sk=words(sk.value))


def rank_tensor(n: int) -> torch.Tensor:
    """A CPU tensor of this rank's number, n of them."""
    return torch.full((n,), dist.get_rank(), dtype=torch.int64)


def rank_raises(bad: int) -> int:
    """Raises in rank ``bad``; every other rank returns its number."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} refuses")
    return dist.get_rank()

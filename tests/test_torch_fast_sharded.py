"""PyTorch port, the limb-sharded fast step with explicit collectives
(parallel/fast_sharded.py), on gloo ranks on the CPU (``parallel/launch.py``):

  * tests/test_fast_sharded_smap.py's three tests at
    ``make_synthetic_context(5, 8, num_p)`` on 8 ranks: the gathered outputs
    bit-identical to the unsharded ``fckks.mul_relin_rescale`` of the JAX
    package, the dropped limbs zero; the collective budget, read from the
    counts of ``parallel/api.py`` (the counterpart of counting the
    compiled HLO's collectives): at most 1 all-gather and ``rescale_limbs``
    psums, nothing else, at least one; batched [3, L, N] operands.  num_p 1
    and 3 are slow, as there;
  * tests/test_fast_sharded.py's multiply (logN 8, L 8, num_p 2, 2 galois
    keys drawn first) on 2 and 4 ranks, through ``build_sharded_step``.
    Its rotation case checks GSPMD's collectives for the unsharded
    automorphism, which has no torch counterpart (ROADMAP C).

The JAX package's unsharded step runs jitted for seconds a context, so its
outputs are pinned here (``DIGESTS``, from
``tools/port_circuit_digests.py test_torch_fast_sharded``); the port draws
the same contexts and operands from the same numpy seeds.  Each world of
ranks starts once for the file.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.fast import fckks as jfckks
from matrix_fhe_tpu_torch.fast import fckks
from matrix_fhe_tpu_torch.parallel import api, fast_sharded, launch
from test_torch_polynomial import digest
import torch_worlds

BATCH = 3
# name -> (ranks, make_synthetic_context arguments, batch)
SETUPS = {
    "smap num_p 1": (8, dict(logn=5, num_q=8, num_p=1, rescale_limbs=2), 0),
    "smap num_p 2": (8, dict(logn=5, num_q=8, num_p=2, rescale_limbs=1), 0),
    "smap num_p 3": (8, dict(logn=5, num_q=8, num_p=3, rescale_limbs=1), 0),
    "smap batched": (8, dict(logn=5, num_q=8, num_p=2, rescale_limbs=1), BATCH),
    "mul 2 ranks": (2, dict(logn=8, num_q=8, num_p=2, rescale_limbs=2, num_rot=2), 0),
    "mul 4 ranks": (4, dict(logn=8, num_q=8, num_p=2, rescale_limbs=2, num_rot=2), 0),
    # a 2-D mesh (as __graft_entry__.py builds them): 2 batch elements x 4 limb shards
    "2-D mesh": (8, dict(logn=5, num_q=8, num_p=2, rescale_limbs=1,
                         axes={"batch": 2, "limb": 4}), 2),
}
SLOW = {"smap num_p 1", "smap num_p 3"}


def _batched(v, batch):
    return [np.roll(np.asarray(v), b, axis=-1) for b in range(batch)] if batch else [v]


def _jax_case(name):
    _, args, batch = SETUPS[name]
    args = dict(args)
    ctx, cts = jfckks.make_synthetic_context(args.pop("logn"), args.pop("num_q"),
                                             args.pop("num_p"), **args)
    step = jax.jit(lambda *a: jfckks.mul_relin_rescale(ctx, *a))
    rolled = [_batched(v, batch) for v in cts]
    return [step(*(jnp.asarray(r[b]) for r in rolled)) for b in range(len(rolled[0]))]


def jax_context():
    return None


CASES = {name: (lambda n: lambda m, c: _jax_case(n))(name) for name in SETUPS
         if "axes" not in SETUPS[name][1]}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "smap num_p 1": "0326ea234d00c112d2fc622bc863de95b6c0e88dce89f434f6352a10f76dc9fa",
    "smap num_p 2": "d97f67373bbb909af7ed4b2d2c9d0c7d5867190f7a7ed433267e750b9a2a0511",
    "smap num_p 3": "90408c8f34647ae775dfa77eacd5addc5f7aa24ef14d2036db7621c4d5fb1f17",
    "smap batched": "d6a1351a8f9a3f6ee560c20562d7732fad7f4e0f19a79dce4f56d4a0cf719e28",
    "mul 2 ranks": "9a6b2a9be106ad8ffb61ecf4e86356879b7fc73b818d38dfb28a7866fe90c5e3",
    "mul 4 ranks": "9a6b2a9be106ad8ffb61ecf4e86356879b7fc73b818d38dfb28a7866fe90c5e3",
}


@functools.lru_cache(maxsize=None)
def _world(k: int, names: tuple) -> dict:
    cases = [dict(SETUPS[n][1], batch=SETUPS[n][2]) for n in names]
    res = launch.run(torch_worlds.fast_world, k, cases, device="cpu")
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


def _results(name):
    """The ranks' results of setup ``name``; the default suite's setups of
    one size start in one world."""
    k = SETUPS[name][0]
    if name in SLOW:
        return _world(k, (name,))[name]
    names = tuple(n for n in SETUPS if SETUPS[n][0] == k and n not in SLOW)
    return _world(k, names)[name]


def _gathered(name):
    blocks = _results(name)
    return (torch_worlds.gather_limbs([b["o0"] for b in blocks]),
            torch_worlds.gather_limbs([b["o1"] for b in blocks]))


def _live(name):
    args = SETUPS[name][1]
    return args["num_q"] - args["rescale_limbs"]


NUM_P = [pytest.param(p, marks=pytest.mark.slow) if f"smap num_p {p}" in SLOW else p
         for p in (1, 2, 3)]


@pytest.mark.parametrize("num_p", NUM_P)
def test_bit_identical_to_unsharded(num_p):
    name = f"smap num_p {num_p}"
    o0, o1 = _gathered(name)
    live = _live(name)
    assert digest([(o0[:live], o1[:live])]) == DIGESTS[name]
    assert not o0[live:].any() and not o1[live:].any()  # dropped limbs zeroed


@pytest.mark.parametrize("num_p", NUM_P)
def test_collective_budget(num_p):
    name = f"smap num_p {num_p}"
    rl = SETUPS[name][1]["rescale_limbs"]
    for b in _results(name):
        c = b["counts"]
        assert c["all_gather"] <= 1, f"{c['all_gather']} all-gathers (expected 1)"
        assert c["psum"] <= rl, f"{c['psum']} psums (rescale broadcasts)"
        assert c["all_to_all"] == 0, c
        assert c["all_gather"] + c["psum"] >= 1  # the collectives are real


def test_batched_operands():
    o0, o1 = _gathered("smap batched")
    live = _live("smap batched")
    assert o0.shape[0] == BATCH
    assert digest([(o0[b, :live], o1[b, :live]) for b in range(BATCH)]) == \
        DIGESTS["smap batched"]
    assert not o0[:, live:].any() and not o1[:, live:].any()


@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_ct_mult_matches(nshards):
    name = f"mul {nshards} ranks"
    o0, o1 = _gathered(name)
    live = _live(name)
    assert digest([(o0[:live], o1[:live])]) == DIGESTS[name]
    assert all(b["counts"]["all_gather"] == 1 and b["counts"]["psum"] == 2
               for b in _results(name))


def test_2d_mesh_batch_and_limbs():
    """Each batch coordinate's 4 limb shards give that element's step."""
    per_rank = _results("2-D mesh")
    args = dict(SETUPS["2-D mesh"][1])
    del args["axes"]
    ctx, cts = fckks.make_synthetic_context(args.pop("logn"), args.pop("num_q"),
                                            args.pop("num_p"), device="cpu", **args)
    live = _live("2-D mesh")
    for b in range(2):
        blocks = torch_worlds.select(per_rank, batch=b)
        assert [r["coords"]["limb"] for r in blocks] == [0, 1, 2, 3]
        o0 = torch_worlds.gather_limbs([r["o0"] for r in blocks])
        o1 = torch_worlds.gather_limbs([r["o1"] for r in blocks])
        assert o0.shape == (1, 8, 32)  # this rank's batch element
        w0, w1 = fckks.mul_relin_rescale(ctx, *(torch.roll(v, b, dims=-1) for v in cts))
        assert np.array_equal(o0[0, :live], w0.numpy()) and np.array_equal(o1[0, :live], w1.numpy())
        assert not o0[0, live:].any() and not o1[0, live:].any()
    for r in per_rank:  # the limb axis' collectives only
        assert (r["counts"]["all_gather"], r["counts"]["psum"]) == (1, 1), r["counts"]


def test_port_unsharded_matches():
    """The same digests hold the port's own unsharded step."""
    for name in ("smap num_p 2", "mul 2 ranks"):
        args = dict(SETUPS[name][1])
        ctx, cts = fckks.make_synthetic_context(args.pop("logn"), args.pop("num_q"),
                                                args.pop("num_p"), device="cpu", **args)
        assert digest([fckks.mul_relin_rescale(ctx, *cts)]) == DIGESTS[name]


def test_uneven_raises():
    ctx, _ = fckks.make_synthetic_context(5, 8, 2, device="cpu")
    mesh = api.Mesh(axis_names=("limb",), axis_sizes=(3,), coords=(0,), groups=(None,),
                    device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        fast_sharded.build_sharded_step(ctx, mesh)

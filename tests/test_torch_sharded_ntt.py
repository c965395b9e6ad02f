"""PyTorch port, the coefficient-sharded four-step NTT
(parallel/ntt_sharded.py): tests/test_sharded_ntt.py's cases at its sizes
(N = 2^10, three 45-bit primes, lead 2), with the shards as gloo ranks on
the CPU (``parallel/launch.py``), plus one case at the three largest
NTT-friendly primes below 2^61, where eight partials sum past 2^63 and the
all-to-all + modular-sum combine must stay exact.

The tables are held to the JAX package's ``build_tables`` word for word
(live, and through ``carry``).  The JAX package's transforms run eagerly
for seconds, so their outputs are pinned here as digests (``DIGESTS``,
from ``tools/port_circuit_digests.py test_torch_sharded_ntt``): the JAX
ring's NTT and ``ntt_reference`` of each input, and the JAX local step
(``_mod_matmul_left`` -> ``mred`` -> ``_partial_matmul_right``) of each of
8 column blocks.  The 8-rank world starts once for the file; the 2- and
4-rank cases are slow, as tests/test_sharded_ntt.py:40-43 marks them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import rings as jrings
from matrix_fhe_tpu.parallel import ntt_sharded as jsh
from matrix_fhe_tpu_torch import carry
from matrix_fhe_tpu_torch.ops import rings, ntt_sharded_cuda
from matrix_fhe_tpu_torch.parallel import api, launch
from matrix_fhe_tpu_torch.parallel import ntt_sharded as sh
from matrix_fhe_tpu_torch.utils import primes as pr
from test_torch_polynomial import digest
import torch_worlds

N = 1 << 10
SHARDS = 8


@functools.lru_cache(maxsize=None)
def moduli(case: str) -> list[int]:
    g = pr.NTTFriendlyPrimesGenerator(45 if case == "45" else 61, 2 * N)
    return g.next_alternating_primes(3) if case == "45" else g.next_downstream_primes(3)


def inputs(case: str, seed: int) -> np.ndarray:
    """tests/test_sharded_ntt.py's draws ([2, 3, N] below 2^44) for the
    45-bit case; canonical words for the 61-bit one."""
    rng = np.random.default_rng(seed)
    if case == "45":
        return rng.integers(0, 1 << 44, (2, 3, N), dtype=np.uint64).astype(np.int64)
    return np.stack([rng.integers(0, q, (2, N), dtype=np.int64) for q in moduli(case)], axis=-2)


def _jax_local_steps(tabs, x):
    """The JAX module's shard-local body on each of the 8 column blocks."""
    q, qinv, bhi = tabs.moduli, tabs.qinv, tabs.bhi
    R, C = tabs.rows, tabs.cols
    c = C // SHARDS
    xb = jnp.asarray(x.astype(np.uint64)).reshape(2, 3, R, C)
    out = []
    for i in range(SHARDS):
        y = jsh._mod_matmul_left(tabs.a_mat, xb[..., i * c:(i + 1) * c], q, qinv, bhi)
        w = jsh.mm.mred(y, tabs.tw[:, :, i * c:(i + 1) * c], q[:, None, None],
                        qinv[:, None, None])
        out.append(jsh._partial_matmul_right(w, tabs.bt_mat[:, i * c:(i + 1) * c], q, qinv,
                                             bhi))
    return out


def jax_context():
    return {case: (jsh.build_tables(N, moduli(case)), jrings.new_ring(N, moduli(case)))
            for case in ("45", "61")}


def _ring_ntt(case, seed):
    return lambda m, c: c[case][1].ntt(jnp.asarray(inputs(case, seed).astype(np.uint64)))


CASES = {
    "ring.ntt 45 seed 0": _ring_ntt("45", 0),
    "ntt_reference 45 seed 0": lambda m, c: jsh.ntt_reference(
        jnp.asarray(inputs("45", 0).astype(np.uint64)), c["45"][0]),
    "ring.ntt 45 seed 1": _ring_ntt("45", 1),
    "ring.ntt 61 seed 2": _ring_ntt("61", 2),
    "local steps 45 seed 1": lambda m, c: _jax_local_steps(c["45"][0], inputs("45", 1)),
}

# tools/port_circuit_digests.py: the JAX package's outputs of CASES
DIGESTS = {
    "ring.ntt 45 seed 0": "3a51bb9a13fa8543bf3e83e08faeee482955a9bc1d858023b04952196cf38c04",
    "ntt_reference 45 seed 0": "3a51bb9a13fa8543bf3e83e08faeee482955a9bc1d858023b04952196cf38c04",
    "ring.ntt 45 seed 1": "7ed763aa9ff67b8ed979e069df05d715d4ab381dd01c016a437d4375a7bd07d6",
    "ring.ntt 61 seed 2": "d5b83b329896dd283adde44b6f4e20eda80cd80c0a2558c91da2cb6d8a66ee9c",
    "local steps 45 seed 1": "7c3dc71871333eb1ef2a76926fe536ec72feb5673aaaa0e8752a5050d77eb0b0",
}

WORLD_CASES = {"45": 1, "61": 2}  # case -> input seed


def _world(k: int) -> dict:
    names = list(WORLD_CASES)
    res = launch.run(torch_worlds.ntt_world, k, [
        {"n": N, "moduli": moduli(c), "x": inputs(c, WORLD_CASES[c])} for c in names],
        device="cpu")
    return {c: [r[i] for r in res] for i, c in enumerate(names)}


@pytest.fixture(scope="module")
def world8():
    return _world(SHARDS)


@pytest.fixture(scope="module")
def port_tabs():
    return {case: sh.build_tables(N, moduli(case), "cpu") for case in ("45", "61")}


@pytest.mark.parametrize("case", ["45", "61"])
def test_tables_match_jax(port_tabs, case):
    jt = jsh.build_tables(N, moduli(case))
    carried = carry.carry(jt, "cpu")
    for f in ("a_mat", "bt_mat", "tw", "moduli", "qinv", "bhi"):
        want = np.asarray(getattr(jt, f)).view(np.int64)
        np.testing.assert_array_equal(getattr(port_tabs[case], f).numpy(), want, err_msg=f)
        assert torch.equal(getattr(carried, f), getattr(port_tabs[case], f)), f
    assert (carried.n, carried.rows, carried.cols) == (jt.n, jt.rows, jt.cols)


def test_reference_four_step_bit_exact(port_tabs):
    x = torch.from_numpy(inputs("45", 0))
    got = sh.ntt_reference(x, port_tabs["45"])
    assert digest(got) == DIGESTS["ntt_reference 45 seed 0"] == DIGESTS["ring.ntt 45 seed 0"]
    assert torch.equal(got, rings.new_ring(N, moduli("45"), device="cpu").ntt(x))


def test_local_step_plain_matches_jax(port_tabs):
    tabs = port_tabs["45"]
    x = torch.from_numpy(inputs("45", 1))
    c = tabs.cols // SHARDS
    before = ntt_sharded_cuda.launches
    parts = [ntt_sharded_cuda.local_step(sh.shard_columns(x, tabs, SHARDS, i), tabs, i * c)
             for i in range(SHARDS)]
    assert ntt_sharded_cuda.launches == before  # a CPU block takes the plain version
    assert digest(parts) == DIGESTS["local steps 45 seed 1"]
    assert torch.equal(parts[3], ntt_sharded_cuda.local_step_plain(
        sh.shard_columns(x, tabs, SHARDS, 3), tabs, 3 * c))


def _check_world(blocks, tabs, want_digest):
    got = sh.gather_columns([torch.from_numpy(b["out"]) for b in blocks], tabs)
    assert digest(got) == want_digest
    for b in blocks:  # one collective a call, the all-to-all
        assert {k: b["counts"][k] for k in api.counts} == {
            "all_gather": 0, "psum": 0, "all_to_all": 1}, b["counts"]
        assert b["transport"] == "gloo"


@pytest.mark.parametrize("case", ["45", "61"])
def test_sharded_matches_unsharded_8(world8, port_tabs, case):
    seed = WORLD_CASES[case]
    _check_world(world8[case], port_tabs[case], DIGESTS[f"ring.ntt {case} seed {seed}"])


@pytest.mark.slow
@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_matches_unsharded(port_tabs, nshards):
    _check_world(_world(nshards)["45"], port_tabs["45"], DIGESTS["ring.ntt 45 seed 1"])


def test_errors(port_tabs):
    tabs = port_tabs["45"]
    mesh = api.Mesh(axis_names=("seq",), axis_sizes=(3,), coords=(0,), groups=(None,),
                    device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        sh.ntt_sharded(torch.zeros((3, 32, 10), dtype=torch.int64), tabs, mesh)
    with pytest.raises(TypeError, match="int64"):
        ntt_sharded_cuda.local_step(torch.zeros((3, 32, 4), dtype=torch.int32), tabs, 0)
    with pytest.raises(ValueError, match="columns"):
        ntt_sharded_cuda.local_step(torch.zeros((3, 32, 4), dtype=torch.int64), tabs, 2)

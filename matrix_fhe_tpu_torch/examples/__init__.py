"""The JAX package's example scripts (``examples/``), on the port.

Each module is the same circuit at the same parameters as its script there,
with every assert at the same bound.  Each exposes ``main(device="cuda",
seed=0) -> dict`` and runs as

    python -m matrix_fhe_tpu_torch.examples.<name> [--device cpu]

The dict holds the decrypted words (``"words"``: the plaintexts' limbs,
name -> tensor) and what the script checks decoded (``"decoded"``), with
its error figures beside them.  Every draw comes from a CPU generator of
its own site (``generator``), so a seed gives the same words on every
device.
"""

from __future__ import annotations

import argparse

import torch

NAMES = ("ckks_template", "ckks_tutorial",
         "bgv_template", "bgv_vectorized_ole", "bgv_ride_hailing",
         "ckks_sigmoid_chebyshev", "ckks_sigmoid_minimax",
         "ckks_vectorized_polynomial_evaluation",
         "ckks_scheme_switching", "ckks_bootstrapping", "rgsw_blind_rotation",
         "multiparty_pir", "multiparty_threshold_keygen", "multiparty_psi")


def generator(seed: int, site: int) -> torch.Generator:
    """The CPU generator of one draw site: the script's ``jax.random.key(site)``,
    or the ``site``-th key of its ``split(key(0), ...)``."""
    return torch.Generator().manual_seed((seed << 16) + site)


def generators(seed: int, count: int) -> list[torch.Generator]:
    """The script's ``jax.random.split(jax.random.key(0), count)``."""
    return [generator(seed, i) for i in range(count)]


def crs(site: int) -> torch.Generator:
    """A multiparty common reference string, ``jax.random.key(site)``: public,
    the same whatever the seed."""
    return torch.Generator().manual_seed(site)


def cli(main) -> None:
    """Run ``main`` on the command line's ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

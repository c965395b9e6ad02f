"""Digests of the JAX package's circuit outputs, pinned by the PyTorch port's
circuit tests.

    python tools/port_circuit_digests.py [test_torch_polynomial ...]
    python tools/port_circuit_digests.py test_torch_fboot:staged_stages ...

Each named test module (default: all of ``MODULES``) defines
``jax_context()`` (the JAX package's parameters, keys and ciphertexts from
its seeds), ``CASES`` (one function a circuit over a namespace of modules,
run here on the JAX package's) and ``DIGESTS``; this runs every case on the
JAX package on the CPU and prints the ``DIGESTS`` dict to paste in, the
sha256 that ``digest`` (tests/test_torch_polynomial.py) gives of its
output.  ``module:case`` runs that case alone (the module's context is
still made whole).  A module may give a case a context of its own
(``JAX_CONTEXTS``: {case: function}), and a case that returns a string
(a digest of its own, a chain of primes) is printed as it is.  The
circuits run eagerly, as the JAX package's own tests run them: minutes a
module.  ``test_torch_wboot:n16_dft_matrices`` (the logN-16 matrices of
chip_smoke.py's phase 28) takes ~7 min and ~4 GB, ``wide61_bootstrap``
~13 min.

The modules of ring switching, the bridge, ring packing, the packed
bootstrap, noise and BGV / BFV (JAX on the CPU, context + cases):
``test_torch_ring_switch`` ~35 s (29 + 4), ``test_torch_bridge`` ~45 s
(38 + 5), ``test_torch_ring_packing`` ~55 s (35 + 18),
``test_torch_noise`` ~25 s (21 + 2), ``test_torch_bgv`` ~100 s (44 + 54, of
which the two Paterson-Stockmeyer polynomials 42 s) and
``test_torch_boot_packed`` ~5.5 min (56 + 265 + 8: the packed case's first
bootstrap compiles the JAX evaluator's graphs).

The modules of the base-two key switches, RGSW, blind rotation and the
multiparty protocols: ``test_torch_base2`` ~2 min (78 + 32 s),
``test_torch_rgsw`` ~1.8 min, ``test_torch_blindrot`` ~8 min (364 s of
context, the eager JAX keygen of both sizes, + 34 + 64 s for the two
``evaluate``s) and ``test_torch_multiparty`` ~2.6 min.

The multi-device modules: ``test_torch_sharded_ntt`` ~20 s (the JAX ring's
NTT, ``ntt_reference`` and the 8 shards' local steps, eagerly),
``test_torch_fast_sharded`` ~40 s (six jitted unsharded steps) and
``test_torch_multiparty_mesh`` ~30 s (25 s of context: the 8 parties'
eager ``gen_secret_key``).
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

MODULES = ("test_torch_polynomial", "test_torch_mod1", "test_torch_lintrans",
           "test_torch_dft", "test_torch_flintrans", "test_torch_fdft",
           "test_torch_bootstrapping", "test_torch_fboot", "test_torch_wring",
           "test_torch_weval", "test_torch_wboot", "test_torch_comparison_inverse",
           "test_torch_matrix_ckks", "test_torch_ci", "test_torch_ring_switch",
           "test_torch_bridge", "test_torch_ring_packing", "test_torch_boot_packed",
           "test_torch_noise", "test_torch_bgv", "test_torch_base2", "test_torch_rgsw",
           "test_torch_blindrot", "test_torch_multiparty", "test_torch_sharded_ntt",
           "test_torch_fast_sharded", "test_torch_multiparty_mesh")


def main() -> None:
    import importlib

    import jax
    jax.config.update("jax_platforms", "cpu")
    import matrix_fhe_tpu  # noqa: F401  (x64 on)
    from test_torch_polynomial import JAX, digest

    for arg in sys.argv[1:] or MODULES:
        name, _, only = arg.partition(":")
        mod = importlib.import_module(name)
        contexts: dict = {}
        lines = []
        for case, fn in mod.CASES.items():
            if only and case != only:
                continue
            make = getattr(mod, "JAX_CONTEXTS", {}).get(case, mod.jax_context)
            if make not in contexts:
                t0 = time.perf_counter()
                contexts[make] = make()
                print(f"# {name}: context {make.__name__} {time.perf_counter() - t0:.1f} s",
                      flush=True)
            t1 = time.perf_counter()
            out = fn(JAX, contexts[make])
            lines.append(f'    "{case}": "{out if isinstance(out, str) else digest(out)}",')
            print(f"# {case}: {time.perf_counter() - t1:.1f} s", flush=True)
        print(f"{name}.DIGESTS = {{\n" + "\n".join(lines) + "\n}", flush=True)


if __name__ == "__main__":
    main()

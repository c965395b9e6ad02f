"""The negacyclic NTT for w22 primes (q < 2^22) on the card.

Counterpart of ``matrix_fhe_tpu/ops/pallas_ntt.py`` (``build_tables``,
``ntt_fwd``/``ntt_bwd``, the v1 Pallas kernel) and of
``matrix_fhe_tpu/ops/mxu_ntt.py`` (``MAX_W22_MODULUS``, ``find_w22_primes``).
The TPU kernel computes B1's transform (``ops/ntt_cuda.py``) restricted to
primes below 2^22, in Dekker float32 arithmetic because the TPU has no
widening multiply.  The card has one, so the same function runs the same
hand-written device code (``csrc/ntt.cu``), through wrappers and launch
counters of its own:

  * a CUDA tensor goes through the kernel, or the call raises;
  * a CPU tensor goes through the plain torch version (``ops/ntt_plain.py``).

Input and output are int32 [..., L, N] (the JAX kernel's public [B, L, N]),
canonical in [0, q), the output in the reference's bit-reversed order.
"""

from __future__ import annotations

import torch

from matrix_fhe_tpu_torch.ops import ntt_cuda, ntt_plain
from matrix_fhe_tpu_torch.utils import graphs
from matrix_fhe_tpu_torch.utils import primes as pr

MAX_W22_MODULUS = 1 << 22

# Kernel launches since the counts were last reset, by ntt_fwd and ntt_bwd
# (a capture launches nothing; a graph's replays count in utils/graphs.py
# replays()).
w22_fwd_launches = 0
w22_bwd_launches = 0


def find_w22_primes(n: int, count: int) -> list[int]:
    """NTT-friendly primes < 2^22 for ring degree n (largest first), pooled
    across bit sizes 22 (downstream only) then 21, 20, ... (alternating)."""
    out: list[int] = []
    for bits in (22, 21, 20, 19, 18):
        g = pr.NTTFriendlyPrimesGenerator(bits, 2 * n)
        try:
            while len(out) < count:
                p = (g.next_downstream_prime() if bits == 22
                     else g.next_alternating_prime())
                if p < MAX_W22_MODULUS and p not in out:
                    out.append(p)
        except ValueError:
            continue
        if len(out) >= count:
            return out
    raise ValueError(f"could not find {count} w22 primes for n={n}")


class W22Tables(ntt_cuda.NTTTables):
    """``NTTTables`` whose moduli are all below 2^22."""


def build_tables(n: int, moduli: list[int], device="cuda") -> W22Tables:
    return ntt_cuda.stacked_tables(W22Tables, n, moduli, MAX_W22_MODULUS, device)


def ntt_fwd(x: torch.Tensor, tabs: W22Tables) -> torch.Tensor:
    global w22_fwd_launches
    _check(x, tabs)
    if x.device.type == "cpu":
        return ntt_plain.ntt_fwd_plain(x, tabs)
    out = ntt_cuda.launch(x, tabs, fwd=True)
    w22_fwd_launches += graphs.launched(f"{__name__}.ntt_fwd", x, tabs)
    return out


def ntt_bwd(x: torch.Tensor, tabs: W22Tables) -> torch.Tensor:
    global w22_bwd_launches
    _check(x, tabs)
    if x.device.type == "cpu":
        return ntt_plain.ntt_bwd_plain(x, tabs)
    out = ntt_cuda.launch(x, tabs, fwd=False)
    w22_bwd_launches += graphs.launched(f"{__name__}.ntt_bwd", x, tabs)
    return out


def _check(x: torch.Tensor, tabs) -> None:
    if not isinstance(tabs, W22Tables):
        raise TypeError("the w22 NTT takes tables from ntt_w22.build_tables")
    ntt_cuda.check_input(x, tabs)

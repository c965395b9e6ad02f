"""CKKS binding of the generic lintrans circuit.

Counterpart of ``matrix_fhe_tpu/circuits/ckks/lintrans.py`` (the reference's
circuits/ckks/lintrans/lintrans.go): supplies
the CKKS embed function (complex diagonals -> (Q, P) NTT/Montgomery
plaintexts) and the Permutation helper (:194-263).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np

from matrix_fhe_tpu_torch.circuits import lintrans as lt
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext
from matrix_fhe_tpu_torch.schemes import ckks


def embed_fn(enc: ckks.Encoder):
    def embed(values, level_q, level_p, scale):
        return enc.embed_qp(values, level_q, level_p, scale)
    return embed


def new_linear_transformation(enc: ckks.Encoder, diagonals: dict[int, np.ndarray],
                              ltp: lt.LinearTransformationParameters) -> lt.LinearTransformation:
    return lt.encode(embed_fn(enc), diagonals, ltp)


def evaluate(enc_params: ckks.CKKSParameters, ct: Ciphertext,
             transform: lt.LinearTransformation, gks) -> Ciphertext:
    return lt.evaluate(enc_params, ct, transform, gks)


@dataclasses.dataclass
class PermutationMapping:
    """circuits/ckks/lintrans/lintrans.go:194 Permutation: slot i of the
    output <- scaling * slot ``from`` of the input."""
    from_idx: int
    scaling: complex


def permutation_diagonals(mappings: list[PermutationMapping],
                          slots: int) -> dict[int, np.ndarray]:
    """Converts a permutation (one mapping per output slot) to diagonals
    (lintrans.go:216-263)."""
    diags: dict[int, np.ndarray] = {}
    for i, m in enumerate(mappings):
        d = (m.from_idx - i) % slots
        if d not in diags:
            diags[d] = np.zeros(slots, dtype=np.complex128)
        diags[d][i] = m.scaling
    return diags

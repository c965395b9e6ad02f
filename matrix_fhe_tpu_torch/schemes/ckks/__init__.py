"""CKKS: approximate homomorphic arithmetic over C^{N/2} (R^N on the CI ring).

Counterpart of ``matrix_fhe_tpu/schemes/ckks`` (the reference's
schemes/ckks) for the standard ring (N/2 complex slots) and the
conjugate-invariant ring (N real slots).
"""

from matrix_fhe_tpu_torch.schemes.ckks.params import (  # noqa: F401
    CKKSParameters, CKKSParametersLiteral, new_parameters)
from matrix_fhe_tpu_torch.schemes.ckks.encoder import Encoder  # noqa: F401
from matrix_fhe_tpu_torch.schemes.ckks.evaluator import Evaluator  # noqa: F401
from matrix_fhe_tpu_torch.schemes.ckks.precision import precision_stats  # noqa: F401
from matrix_fhe_tpu_torch.schemes.ckks import bridge  # noqa: F401

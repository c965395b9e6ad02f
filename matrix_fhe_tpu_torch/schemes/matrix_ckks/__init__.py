"""Matrix-CKKS: CKKS-like fixed-point arithmetic over the 3N ring
Z_q[X]/(X^N - X^{N/2} + 1), the fork's own scheme.

Counterpart of ``matrix_fhe_tpu/schemes/matrix_ckks`` (the reference's
schemes/matrix_ckks).
"""

from matrix_fhe_tpu_torch.schemes.matrix_ckks.scheme import (  # noqa: F401
    Encoder, Evaluator, MatrixCKKSParametersLiteral, example_parameters, new_parameters)

"""BGV (and BFV as the scale-invariant variant): exact integer SIMD
arithmetic over Z_T.

Counterpart of ``matrix_fhe_tpu/schemes/bgv`` (the reference's schemes/bgv,
a unified BGV/BFV evaluator, schemes/bfv/README.md).
"""

from matrix_fhe_tpu_torch.schemes.bgv.scheme import (  # noqa: F401
    BGVParametersLiteral, BGVParameters, new_parameters, Encoder, Evaluator,
)

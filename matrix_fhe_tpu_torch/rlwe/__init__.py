"""RLWE core on the u64 path: parameters, keys, encryption, key switching.

Counterpart of ``matrix_fhe_tpu/rlwe`` (the reference's core/rlwe) for the
standard ring.  State is frozen dataclasses of torch tensors; every random
draw comes from an explicit ``torch.Generator``.
"""

from matrix_fhe_tpu_torch.rlwe.params import (  # noqa: F401
    GALOIS_GEN, Parameters, Parameters3NLiteral, ParametersLiteral, new_parameters,
    new_parameters_3n)
from matrix_fhe_tpu_torch.rlwe.elements import Ciphertext, MetaData, Plaintext  # noqa: F401
from matrix_fhe_tpu_torch.rlwe.keys import (  # noqa: F401
    EvaluationKey, GaloisKey, PublicKey, RelinearizationKey, SecretKey,
    gen_evaluation_key, gen_galois_key, gen_galois_keys, gen_public_key,
    gen_relinearization_key, gen_secret_key)
from matrix_fhe_tpu_torch.rlwe import decryptor, encryptor, evaluator  # noqa: F401

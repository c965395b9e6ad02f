"""RGSW ciphertexts, external products and blind rotation.

Counterpart of ``matrix_fhe_tpu/rgsw`` (the reference's core/rgsw/)."""

from matrix_fhe_tpu_torch.rgsw.rgsw import (  # noqa: F401
    RGSWCiphertext, encrypt, encrypt_plaintext, external_product,
)

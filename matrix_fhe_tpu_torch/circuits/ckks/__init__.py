"""CKKS circuit bindings: counterpart of ``matrix_fhe_tpu/circuits/ckks``."""

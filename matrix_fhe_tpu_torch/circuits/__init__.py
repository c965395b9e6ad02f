"""Homomorphic circuits: counterpart of ``matrix_fhe_tpu/circuits``."""

"""The int32 fast path over <2^23 moduli: ring, RNS tools, the CKKS
multiply-relinearize-rescale step and the evaluator over it, ported from
``matrix_fhe_tpu.fast``.

Residues are int32 tensors [..., L, N], canonical in [0, q) at op
boundaries.  Between boundaries the arithmetic runs in int64, where every
product of two residues (< 2^46) and every sum on this path is exact; the
JAX package's float32-Shoup and wrapping-int32 tricks are not needed.
"""

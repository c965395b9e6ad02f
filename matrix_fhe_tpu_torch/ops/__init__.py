"""Ring-level operations: NTT tables, the NTT (CUDA kernel and plain torch
version; one transform, a chain of k, and the w22-prime form) and
automorphism indices."""

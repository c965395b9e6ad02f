"""Ring-level operations: the u64 word arithmetic, ring and NTT (torch ops),
RNS tools, samplers and RNS scalars of the setup path; NTT tables, the int32
NTT (CUDA kernel and plain torch version; one transform, a chain of k, and
the w22-prime form) and automorphisms."""

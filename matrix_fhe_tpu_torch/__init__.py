"""matrix_fhe_tpu_torch — the PyTorch and CUDA port of ``matrix_fhe_tpu``.

The JAX package beside it stays the reference: every function here is held
bit-for-bit against its counterpart there, on the same moduli and the same
input arrays.  The layout mirrors the JAX package (``ops/``, ``fast/``,
``utils/``) so each module's counterpart is easy to find.

Ported so far: the int32 CKKS multiply-relinearize-rescale path
(``fast/fckks.py:mul_relin_rescale``) and hoisted rotations, over
``fast/frns.py`` and ``fast/fring.py``, and the NTT in all its forms: one
transform or a chain of k (``ops/ntt_cuda.py``), and the w22-prime
transform (``ops/ntt_w22.py``).  They run one hand-written CUDA source
(``csrc/ntt.cu``) that CUDA tensors go through; CPU tensors take a plain
torch version of the same function (``ops/ntt_plain.py``).  Constructors
put their tensors on the card unless given another device.

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

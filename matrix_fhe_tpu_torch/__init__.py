"""matrix_fhe_tpu_torch — the PyTorch and CUDA port of ``matrix_fhe_tpu``.

The JAX package beside it stays the reference: every function here is held
bit-for-bit against its counterpart there, on the same moduli and the same
input arrays.  The layout mirrors the JAX package (``ops/``, ``rlwe/``,
``schemes/``, ``fast/``, ``utils/``) so each module's counterpart is easy to
find.

Ported so far:

* the setup path and the user-facing CKKS entry points: the u64 ring and
  its NTT as torch ops (``ops/modmath.py``, ``ops/rings.py``,
  ``ops/rns_tools.py``, ``ops/automorphism.py``, ``ops/scalar.py``), the
  samplers (``ops/samplers.py``, explicit ``torch.Generator``s), RLWE
  parameters, keys, encryption, decryption and key switching (``rlwe/``),
  the CKKS parameters, encoder, evaluator and precision statistics
  (``schemes/ckks/``), and ``carry.py``, which takes the JAX package's
  objects over;
* the int32 fast path: the CKKS multiply-relinearize-rescale step
  (``fast/fckks.py``) and hoisted rotations over ``fast/frns.py`` and
  ``fast/fring.py``, its context built from the port's own keys
  (``fckks.make_context``), and the evaluator over it (``fast/feval.py``);
* the NTT in all its forms: one transform or a chain of k
  (``ops/ntt_cuda.py``), and the w22-prime transform (``ops/ntt_w22.py``).
  They run one hand-written CUDA source (``csrc/ntt.cu``) that CUDA tensors
  go through; CPU tensors take a plain torch version of the same function
  (``ops/ntt_plain.py``);
* bootstrapping (``circuits/``, ``fast/fboot.py``), the wide path over
  41-61-bit primes (``fast/w*.py``, the NTT of 64-bit words in
  ``csrc/ntt64.cu``) and the comparison and inverse circuits;
* the fork's own rings: the 3N ring with its factorized NTT
  (``ops/ntt_3n.py``, ``csrc/ntt3n.cu``) and Matrix-CKKS
  (``schemes/matrix_ckks``), and the conjugate-invariant ring with CKKS
  over it.

Randomness is not part of the bit-exactness contract: the port draws from
torch generators, and its tests hand it the arrays the JAX package sampled.
Constructors put their tensors on the card unless given another device.

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

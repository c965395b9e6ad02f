"""Multi-device parallelism over ``torch.distributed``: the mesh, the
counted collectives, and sharded execution.

Counterpart of ``matrix_fhe_tpu/parallel`` (SURVEY.md section 2.8):

  * **limb axis (L)**: the RNS direction, communication-free for NTTs,
    vector ops and sampling; decompose, ModDown and rescale cross limbs
    (``fast_sharded.py``: one all-gather and a psum a dropped limb);
  * **batch axis (B)**: independent ciphertexts, pure data parallelism;
  * **coefficient axis (N)**: the four-step NTT with its column axis
    sharded, one all-to-all a transform (``ntt_sharded.py``).

A mesh is one process a device (``launch.py`` starts them); every exchange
is an explicit collective of ``api.py``, counted.
"""

from matrix_fhe_tpu_torch.parallel.api import (  # noqa: F401
    make_mesh, shard_ciphertext_batch, limb_sharding, batch_sharding,
)

"""Multiparty (threshold) HE protocols.

Counterpart of ``matrix_fhe_tpu/multiparty`` (the reference's multiparty/),
its mesh-sharded aggregation included (``mesh.py``: the collective public
key with the parties over a party axis, aggregated by one psum a plane)."""

from matrix_fhe_tpu_torch.multiparty.protocols import (  # noqa: F401
    PublicKeyGen, EvaluationKeyGen, GaloisKeyGen, RelinKeyGen,
    KeySwitch, PublicKeySwitch, sample_crp_qp, sample_crp_q,
)
from matrix_fhe_tpu_torch.multiparty.threshold import (  # noqa: F401
    Thresholdizer, Combiner,
)

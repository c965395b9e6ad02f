"""Schemes over the RLWE core: CKKS so far (``schemes/ckks``).  BGV and
matrix-CKKS are ROADMAP A8."""

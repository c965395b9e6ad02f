"""Schemes over the RLWE core: CKKS (``schemes/ckks``) and Matrix-CKKS over
the 3N ring (``schemes/matrix_ckks``).  BGV is ROADMAP A8."""

"""Host-side helpers: number theory (pure Python) and Decimal
transcendentals, copied from ``matrix_fhe_tpu.utils``, and the device policy
of the constructors."""

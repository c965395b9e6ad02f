"""Host-side helpers: number theory (pure Python), copied from
``matrix_fhe_tpu.utils``, and the device policy of the constructors."""

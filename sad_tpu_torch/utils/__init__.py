"""Host-side helpers copied from sad_tpu.utils."""

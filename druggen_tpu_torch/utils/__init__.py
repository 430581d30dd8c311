"""Host-side helpers of the trainer (copies of ``druggen_tpu.utils``)."""

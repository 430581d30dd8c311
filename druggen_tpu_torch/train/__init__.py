"""Training of the port (mirrors ``druggen_tpu.train``)."""

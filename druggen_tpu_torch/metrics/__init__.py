"""Report metrics of the port (copied subset of ``druggen_tpu.metrics``)."""

"""Dataset pipeline of the port (copied from ``druggen_tpu.data``)."""

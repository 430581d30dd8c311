"""Inference of the port (mirrors ``druggen_tpu.infer``)."""

"""Hand-written Hopper kernels of the port, each beside its plain version.

- :mod:`fused_mlp` — K1, the fused LN -> MLP -> residual -> LN edge tail
  (``csrc/fused_mlp.cu``), replacing ``druggen_tpu/ops/fused_mlp.py``.

Kernels are compiled with ``nvcc`` at first use (:mod:`_build`) and loaded
with ``ctypes``; nothing is built or imported when a module is imported.
"""

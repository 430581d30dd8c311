"""Hand-written Hopper kernels of the port, each beside its plain version.

- :mod:`fused_mlp` — K1/K2, the fused LN -> MLP -> residual -> LN edge tail
  and its backward (``csrc/fused_mlp{,_bwd}.cu``), replacing
  ``druggen_tpu/ops/fused_mlp.py``.
- :mod:`fused_attention` — K5/K6, the edge attention with its projections
  (``csrc/fused_attention{,_bwd}.cu``), replacing the v3 half of
  ``druggen_tpu/ops/fused_attention.py``.
- :mod:`fused_block` — K7/K8, an encoder block's whole edge stream
  (``csrc/fused_block{,_bwd}.cu``), replacing ``druggen_tpu/ops/fused_block.py``.

K1 and K7 share one tile routine (``csrc/tail_common.cuh``).  Kernels are
compiled with ``nvcc`` at first use (:mod:`_build`) and loaded with
``ctypes``; nothing is built or imported when a module is imported.
"""

"""Hand-written Hopper kernels of the port, each beside its plain version.

- :mod:`fused_mlp` — K1/K2, the fused LN -> MLP -> residual -> LN edge tail
  and its backward (``csrc/fused_mlp{,_bwd}.cu``), replacing
  ``druggen_tpu/ops/fused_mlp.py``.
- :mod:`fused_attention` — K5/K6, the edge attention with its projections
  (``csrc/fused_attention{,_bwd}.cu``), replacing the v3 half of
  ``druggen_tpu/ops/fused_attention.py``; and K3/K4, the v2 op without
  them (``edge_modulated_attention``, ``csrc/fused_attention_v2{,_bwd}.cu``),
  replacing its first half.  All four share ``csrc/attn_common.cuh``.
- :mod:`fused_block` — K7/K8, an encoder block's whole edge stream
  (``csrc/fused_block{,_bwd}.cu``), replacing ``druggen_tpu/ops/fused_block.py``.
- :mod:`fused_generator` — K9, the whole Generator forward of ``use_pallas``
  serving (``csrc/fused_generator.cu``), replacing
  ``druggen_tpu/ops/fused_generator.py``.

K1, K7 and K9 share one tile routine (``csrc/tail_common.cuh``; K9 with its
own rounding policy).  Kernels are
compiled with ``nvcc`` at first use (:mod:`_build`) and loaded with
``ctypes``; nothing is built or imported when a module is imported.
"""

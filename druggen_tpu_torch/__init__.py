"""PyTorch + CUDA port of :mod:`druggen_tpu` for NVIDIA Hopper.

The package mirrors the module layout of ``druggen_tpu`` so that each piece
has an obvious counterpart.  It imports ``torch`` and numpy and nothing of
the JAX package: the pure-Python host modules it needs are copied here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
request for ``cuda`` without a card raises instead of falling back.
"""

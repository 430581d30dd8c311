"""Reference torch checkpoints <-> flax parameter trees (port of
``druggen_tpu/interop/torch_ckpt.py``).

The reference checkpoints are plain ``torch.save(model.state_dict())``
files (``reference/train.py:259-263``; inference restore at
``inference.py:135-139``).  The port's models carry the reference's keys
(:mod:`..models.models`), so such a file loads into them with
``load_state_dict`` once the ``module.`` prefix of an ``nn.DataParallel``
save (reference train.py:220-223) is stripped; :func:`load_torch_state_dict`
reads one that way, and ``train.checkpoint.load_params_auto`` tells it from
a flax msgpack file.  What is left of the JAX module is the conversion
between those keys and the JAX package's flax trees, for the
``import_torch_ckpt`` tool: :mod:`..interop.weights` does it key by key
(``nn.Linear.weight`` is ``[out, in]``, flax ``Dense.kernel`` ``[in, out]``;
``LayerNorm.weight`` is flax ``scale``), and this module adds the prefix,
the check that no key is left unconverted, and the stacked ``scan_layers``
layout (``msgpack_ckpt.stack_block_params``).
"""

from __future__ import annotations

import torch

from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.interop.msgpack_ckpt import stack_block_params
from druggen_tpu_torch.interop.weights import (  # noqa: F401  (the JAX module's names)
    flax_discriminator_to_torch,
    flax_generator_to_torch,
    flax_simple_disc_to_torch,
    to_torch_tensors,
)

_TORCH_MAGIC = (b"PK\x03\x04", b"\x80")     # torch.save: a zip, or a legacy pickle


def strip_data_parallel_prefix(sd: dict) -> dict:
    """Remove the ``module.`` prefix nn.DataParallel adds on save."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def is_torch_file(path: str) -> bool:
    """True for a ``torch.save`` file, False for anything else (a flax
    msgpack file begins with a map's type byte)."""
    with open(path, "rb") as f:
        head = f.read(4)
    return any(head.startswith(m) for m in _TORCH_MAGIC)


def load_torch_state_dict(path: str) -> dict:
    """Read a reference ``.ckpt`` file (a pickled state_dict).

    Handles both a bare state_dict and a dict wrapping one under common
    keys (``state_dict`` / ``model``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(
            hasattr(v, "detach") for v in obj.values()):
        for key in ("state_dict", "model", "generator", "G"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return strip_data_parallel_prefix(obj)


def _convert(sd: dict, to_flax, to_torch, scan_layers: bool) -> dict:
    sd = strip_data_parallel_prefix(sd)
    variables = to_flax(sd)
    left = set(sd) - set(to_torch(variables))
    if left:
        raise ValueError(
            f"unconverted state_dict keys (wrong model kind?): "
            f"{sorted(left)[:8]}{'...' if len(left) > 8 else ''}")
    return stack_block_params(variables) if scan_layers else variables


def _has_blocks(sd: dict) -> None:
    if not any(k.startswith("TransformerEncoder.Encoder_Blocks.") for k in sd):
        raise ValueError("no Encoder_Blocks keys found in state_dict")


def torch_generator_to_flax(sd: dict, scan_layers: bool = False) -> dict:
    """Reference ``Generator.state_dict()`` -> druggen_tpu Generator
    variables (``{'params': ...}``); ``scan_layers=True`` emits the stacked
    ``blocks/block`` layout of the ``lax.scan`` encoder."""
    _has_blocks(strip_data_parallel_prefix(sd))
    return _convert(sd, weights.torch_generator_to_flax, flax_generator_to_torch,
                    scan_layers)


def torch_discriminator_to_flax(sd: dict, scan_layers: bool = False) -> dict:
    """Reference ``Discriminator.state_dict()`` -> druggen_tpu
    Discriminator variables."""
    _has_blocks(strip_data_parallel_prefix(sd))
    return _convert(sd, weights.torch_discriminator_to_flax,
                    flax_discriminator_to_torch, scan_layers)


def torch_simple_disc_to_flax(sd: dict) -> dict:
    """Reference ``simple_disc.state_dict()`` -> druggen_tpu SimpleDisc
    variables."""
    return _convert(sd, weights.torch_simple_disc_to_flax,
                    flax_simple_disc_to_torch, False)


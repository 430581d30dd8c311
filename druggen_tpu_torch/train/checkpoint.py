"""Checkpointing (port of ``druggen_tpu/train/checkpoint.py`` ``save_params``,
``load_params``, ``save_gd_params``).

Parameters are written in the JAX package's own format, flax msgpack of the
flax parameter tree (:mod:`..interop.msgpack_ckpt` writes it without flax),
so a ``{submodel}-G.ckpt`` trained by the port loads in the JAX
``load_params`` and in both inference engines, and the reference-style
``{epoch}-{iter}-G.ckpt`` / ``-D.ckpt`` exports keep their names
(reference train.py:259-263).  Full training-state checkpoints with the
optimizer moments (``save_state``, ``restore_state``, resume) are not
ported yet.
"""

from __future__ import annotations

import os

from druggen_tpu_torch.interop.msgpack_ckpt import (
    msgpack_serialize,
    read_flax_checkpoint,
)
from druggen_tpu_torch.interop.weights import (
    torch_discriminator_to_flax,
    torch_generator_to_flax,
)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params(path: str, variables: dict) -> None:
    """Write a flax parameter tree (``{'params': ...}``, numpy leaves), e.g.
    ``{submodel}-G.ckpt`` for inference."""
    _atomic_write(path, msgpack_serialize(variables))


def load_params(path: str) -> dict:
    """Read a flax parameter file (unrolled layout, numpy leaves)."""
    return read_flax_checkpoint(path)


def save_generator(path: str, G) -> None:
    save_params(path, torch_generator_to_flax(G.state_dict()))


def save_gd_params(model_dir: str, G, D, epoch: int, it: int) -> None:
    """Reference-style G/D exports (train.py:259-263 naming)."""
    os.makedirs(model_dir, exist_ok=True)
    save_generator(os.path.join(model_dir, f"{epoch}-{it}-G.ckpt"), G)
    save_params(os.path.join(model_dir, f"{epoch}-{it}-D.ckpt"),
                torch_discriminator_to_flax(D.state_dict()))


def save_state(*_args, **_kwargs):
    raise NotImplementedError("full training-state checkpoints (optimizer "
                              "moments, exact resume) are not ported yet "
                              "(ROADMAP queue A)")


def restore_state(*_args, **_kwargs):
    raise NotImplementedError("restoring a full training state (--resume) is "
                              "not ported yet (ROADMAP queue A)")

"""Checkpointing (port of ``druggen_tpu/train/checkpoint.py``).

Everything is written in the JAX package's own format, flax msgpack
(:mod:`..interop.msgpack_ckpt` reads and writes it without flax):

- parameter files: a ``{submodel}-G.ckpt`` trained by the port loads in the
  JAX ``load_params`` and in both inference engines, and the
  reference-style ``{epoch}-{iter}-G.ckpt`` / ``-D.ckpt`` exports keep
  their names (reference train.py:259-263);
- full training-state checkpoints ``state_{step}.msgpack``: the flax state
  dict of the JAX ``GANState`` (both parameter trees, both optimizers'
  AdamW moments and counts inside the non-finite guard's
  ``AllFiniteState``, the step), written atomically and pruned to the newest
  three, so that a state file goes both ways between the packages.  The
  port's side of a state is ``{g, d, g_opt, d_opt, step}``
  (:func:`..interop.weights.gan_state_to_port`).

``stacked=True`` writes every file in the stacked ``{'blocks': {'block':
…}}`` encoder layout of JAX ``--scan_layers`` (``models/layers.py:443-486``),
and :func:`restore_state` reads a state in that layout; the port's models are
unrolled either way.
"""

from __future__ import annotations

import os
import re

import numpy as np

from druggen_tpu_torch.interop.msgpack_ckpt import (
    msgpack_restore,
    msgpack_serialize,
    read_flax_checkpoint,
    stack_block_params,
)
from druggen_tpu_torch.interop.weights import (
    flax_discriminator_to_torch,
    flax_generator_to_torch,
    gan_state_to_port,
    port_to_gan_state,
    to_torch_tensors,
    torch_discriminator_to_flax,
    torch_generator_to_flax,
)

_STATE_RE = re.compile(r"^state_(\d+)\.msgpack$")


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params(path: str, variables: dict, stacked: bool = False) -> None:
    """Write a flax parameter tree (``{'params': ...}``, numpy leaves), e.g.
    ``{submodel}-G.ckpt`` for inference; in the stacked layout when
    ``stacked``."""
    if stacked:
        variables = stack_block_params(variables)
    _atomic_write(path, msgpack_serialize(variables))


def load_params(path: str) -> dict:
    """Read a flax parameter file (unrolled layout, numpy leaves)."""
    return read_flax_checkpoint(path)


def load_params_auto(path: str) -> dict:
    """A Generator export (``{submodel}-G.ckpt`` or ``{epoch}-{iter}-G.ckpt``)
    in the unrolled or the stacked ``scan_layers`` layout, as the port's
    Generator state_dict (torch tensors).  The counterpart of JAX
    ``load_params_auto`` (``train/checkpoint.py:57-74``): the port's
    Generator is always unrolled, so a stacked file is unstacked."""
    return to_torch_tensors(flax_generator_to_torch(read_flax_checkpoint(path)))


def save_generator(path: str, G, stacked: bool = False) -> None:
    save_params(path, torch_generator_to_flax(G.state_dict()), stacked)


def save_gd_params(model_dir: str, G, D, epoch: int, it: int,
                   stacked: bool = False) -> None:
    """Reference-style G/D exports (train.py:259-263 naming)."""
    os.makedirs(model_dir, exist_ok=True)
    save_generator(os.path.join(model_dir, f"{epoch}-{it}-G.ckpt"), G, stacked)
    save_params(os.path.join(model_dir, f"{epoch}-{it}-D.ckpt"),
                torch_discriminator_to_flax(D.state_dict()), stacked)


def save_state(model_dir: str, state: dict, keep: int = 3,
               guarded: bool = True, stacked: bool = False) -> str:
    """Full-state checkpoint of the port's ``state`` (``{g, d, g_opt, d_opt,
    step}``) named by its step, in the JAX ``GANState`` layout (optimizer
    states inside the guard's ``AllFiniteState`` when ``guarded``; the
    parameters and moments stacked when ``stacked``); prunes to ``keep``."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"state_{int(state['step'])}.msgpack")
    tree = port_to_gan_state(state, guarded)
    if stacked:
        tree = stack_block_params(tree)
    _atomic_write(path, msgpack_serialize(tree))
    _prune(model_dir, keep)
    return path


def latest_state_path(model_dir: str) -> str | None:
    if not os.path.isdir(model_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(model_dir):
        m = _STATE_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(model_dir, name)
    return best


_GUARD_FIELDS = {"notfinite_count", "total_notfinite", "inner_state"}


def _migrate_guard_structure(raw: dict, tstate: dict) -> dict:
    """Bridge the ``apply_if_all_finite`` wrapper across checkpoint eras
    (JAX ``checkpoint.py:111-137``): wrap an unguarded optimizer state with
    zeroed counters when the template is guarded, or unwrap
    ``inner_state`` when it is not."""
    out = dict(raw)
    for key in ("g_opt_state", "d_opt_state"):
        t, r = tstate.get(key), raw.get(key)
        if not isinstance(t, dict) or not isinstance(r, dict):
            continue
        t_guarded = set(t) == _GUARD_FIELDS
        r_guarded = set(r) == _GUARD_FIELDS
        if t_guarded and not r_guarded:
            zero = np.zeros((), np.int32)
            out[key] = {"notfinite_count": zero, "total_notfinite": zero,
                        "inner_state": r}
        elif r_guarded and not t_guarded:
            out[key] = r["inner_state"]
    return out


def _structure_mismatch(tree, template, path: str = "") -> str | None:
    """The first key path where ``tree`` and ``template`` differ in keys or
    in an array's shape, or None."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(map(str, tree)) != set(map(str, template)):
            return path or "/"
        for k, v in template.items():
            bad = _structure_mismatch(tree[str(k)], v, f"{path}/{k}")
            if bad:
                return bad
        return None
    if isinstance(tree, dict) or np.shape(tree) != np.shape(template):
        return path
    return None


def restore_state(model_dir: str, template: dict, path: str | None = None,
                  guarded: bool = True, stacked: bool = False) -> dict | None:
    """Restore the newest (or an explicit) full-state checkpoint, as the
    port's ``{g, d, g_opt, d_opt, step}``; None if there is none.

    ``template`` is the current state in the same form (and ``guarded`` its
    optimizers' guard flag, ``stacked`` the layout the file is expected in,
    as JAX's template fixes it): a guarded/unguarded layout mismatch is
    migrated, any other mismatch of keys or shapes raises ``ValueError``
    naming the checkpoint."""
    path = path or latest_state_path(model_dir)
    if path is None or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    tstate = port_to_gan_state(template, guarded)
    if stacked:
        tstate = stack_block_params(tstate)
    raw = _migrate_guard_structure(raw, tstate)
    bad = _structure_mismatch(raw, tstate)
    if bad:
        raise ValueError(
            f"checkpoint {path} does not match the current training state "
            f"structure (model size/depth, optimizer, or guard flags "
            f"changed since it was saved): first difference at {bad}")
    return gan_state_to_port(raw)


def restore_gd_params(model_dir: str, epoch: int, it: int) -> tuple[dict, dict]:
    """Reference-style resume from '{epoch}-{iter}-{G,D}.ckpt'
    (train.py:250-257): the two state_dicts (numpy values); the caller keeps
    its fresh optimizer states, like the reference (which never saves
    them)."""
    g = read_flax_checkpoint(os.path.join(model_dir, f"{epoch}-{it}-G.ckpt"))
    d = read_flax_checkpoint(os.path.join(model_dir, f"{epoch}-{it}-D.ckpt"))
    return flax_generator_to_torch(g), flax_discriminator_to_torch(d)


def _prune(model_dir: str, keep: int) -> None:
    entries = []
    for name in os.listdir(model_dir):
        m = _STATE_RE.match(name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    for _, name in entries[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(model_dir, name))
        except OSError:
            pass

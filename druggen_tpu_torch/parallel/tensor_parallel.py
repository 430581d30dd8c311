"""Tensor parallelism over a 'model' axis (port of
``druggen_tpu/parallel/tensor_parallel.py``).

The JAX package gives GSPMD parameter shardings and lets XLA partition the
step; here the split layers carry their collectives
(:class:`..models.layers.Dense` with ``tp_kind``), Megatron's column/row
pattern under the gradient rule of :mod:`..models.layers`:

- the attention projections ``attn.{q,k,v,e}`` and the MLPs' ``fc1`` are
  column-parallel: each rank keeps its output features (its rows of the
  torch ``weight`` and of ``bias``); the attention is per channel, so it runs
  on the rank's channels;
- ``attn.{out_e,out_n}`` and the MLPs' ``fc2`` are row-parallel: each rank
  keeps its input features (its columns of ``weight``), the partial outputs
  are summed over 'model', the bias is whole;
- everything else (LayerNorms, the input MLPs, readouts, the critic's head)
  is whole on every rank, as is a layer whose split dimension 'model' does
  not divide (JAX :169-180).

The fused edge tail (K1/K2) cannot be split: LN2 needs the whole ``fc2``
output.  Its ``fc1``/``fc2`` shards are gathered (each rank the whole
weights, :meth:`..models.layers.Dense.full`) and K2's weight gradients come
back through the gather's conjugate, which keeps this rank's slice; GSPMD
does the same around a Pallas call, which it cannot partition.  The other
kernels' paths (``use_pallas``, ``fused_block``) take every attention
parameter whole the same way.

Parameters are split before the optimizers are built, so the Adam moments
sit with their shards (:func:`shard_gan_state_tp`); :func:`gather_state_dict`
puts a state dict together again (collective) and
:func:`shard_state_dict` cuts a whole one down to this rank's shards.
"""

from __future__ import annotations

import torch

from druggen_tpu_torch.models.layers import Dense
from druggen_tpu_torch.parallel.mesh import Axis, Mesh, all_gather

COLUMN, ROW = "column", "row"

# module-name suffix -> kind (JAX _RULES, on the port's names)
_RULES = (
    ("attn.q", COLUMN),
    ("attn.k", COLUMN),
    ("attn.v", COLUMN),
    ("attn.e", COLUMN),
    ("attn.out_e", ROW),
    ("attn.out_n", ROW),
    ("mlp.fc1", COLUMN),
    ("mlp.fc2", ROW),
    ("mlp2.fc1", COLUMN),
    ("mlp2.fc2", ROW),
)


def make_dp_tp_mesh(dp: int, tp: int) -> Mesh:
    """2-D mesh ('data', 'model') over the first ``dp * tp`` ranks."""
    return Mesh({"data": dp, "model": tp})


def kind_for(module_name: str) -> str | None:
    """The rule of a Dense layer by its module name."""
    for suffix, kind in _RULES:
        if module_name == suffix or module_name.endswith("." + suffix):
            return kind
    return None


def split_dim(kind: str | None, param: str) -> int | None:
    """The dimension of a torch ``weight`` [out, in] or ``bias`` [out] that
    ``kind`` splits (None: whole)."""
    if kind == COLUMN:
        return 0
    if kind == ROW and param == "weight":
        return 1
    return None


def tp_param_shardings(module: torch.nn.Module, tp: int) -> dict:
    """``{parameter name: split dimension or None}`` for the port's
    Generator or Discriminator at 'model' size ``tp``; a layer whose split
    dimension ``tp`` does not divide stays whole (JAX
    ``tp_param_shardings``)."""
    out = dict.fromkeys(name for name, _ in module.named_parameters())
    for mname, m in module.named_modules():
        if not isinstance(m, Dense):
            continue
        kind = kind_for(mname)
        dims = {p: split_dim(kind, p) for p in ("weight", "bias")}
        w_dim = dims["weight"]
        if w_dim is not None and m.weight.shape[w_dim] % tp:
            dims = dict.fromkeys(dims)
        for p, d in dims.items():
            out[f"{mname}.{p}"] = d
    return out


def _dense_layers(module):
    return {name: m for name, m in module.named_modules() if isinstance(m, Dense)}


@torch.no_grad()
def shard_module_tp(module: torch.nn.Module, axis: Axis) -> None:
    """Cut ``module``'s split layers down to this rank's shards, in place
    (the ``Parameter`` objects stay), and set their ``tp_kind``."""
    dims = tp_param_shardings(module, axis.size)
    for mname, m in _dense_layers(module).items():
        if dims[f"{mname}.weight"] is None:
            continue
        for p in ("weight", "bias"):
            d = dims[f"{mname}.{p}"]
            if d is not None:
                param = getattr(m, p)
                n = param.shape[d] // axis.size
                param.data = param.data.narrow(d, axis.index * n, n).clone()
        m.tp_kind, m.tp_axis = kind_for(mname), axis


def shard_gan_state_tp(mesh: Mesh, G, D) -> None:
    """Split G's and D's layers over the mesh's 'model' axis (before the
    optimizers are built: the moments then sit with their shards)."""
    axis = mesh.axis("model")
    for model in (G, D):
        shard_module_tp(model, axis)


def _split(module) -> dict:
    """``{parameter name: (split dimension, axis)}`` of the split parameters."""
    out = {}
    for mname, m in _dense_layers(module).items():
        if m.tp_kind is not None:
            for p in ("weight", "bias"):
                d = split_dim(m.tp_kind, p)
                if d is not None:
                    out[f"{mname}.{p}"] = (d, m.tp_axis)
    return out


def gather_state_dict(module, sd: dict) -> dict:
    """A state dict of ``module``'s layout (its parameters, or moments by
    the same names) with every split entry gathered whole (collective over
    'model'; whole entries pass through)."""
    split = _split(module)
    out = {}
    for name, t in sd.items():
        if name in split:
            d, axis = split[name]
            t = all_gather(torch.as_tensor(t).contiguous(), axis, d)
        out[name] = t
    return out


def shard_state_dict(module, sd: dict) -> dict:
    """A whole state dict cut down to ``module``'s shards."""
    split = _split(module)
    out = {}
    for name, t in sd.items():
        if name in split:
            d, axis = split[name]
            t = torch.as_tensor(t)
            n = t.shape[d] // axis.size
            t = t.narrow(d, axis.index * n, n).clone()
        out[name] = t
    return out

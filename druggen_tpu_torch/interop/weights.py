"""flax parameter trees <-> the port's state_dicts (pure numpy).

Copied from ``druggen_tpu/interop/torch_ckpt.py:211-258``
(``flax_generator_to_torch`` and its helpers) plus the reverse direction and
per-module variants.  This is how the JAX package's parameters (as numpy)
are carried into the port, and how the port's weights go back.

Layout: ``nn.Linear.weight`` is ``[out, in]`` and flax ``Dense.kernel`` is
``[in, out]`` (transpose); ``LayerNorm.weight`` is flax ``LayerNorm.scale``.
Torch keys: ``node_layers.0/.2``, ``edge_layers.0/.2``,
``TransformerEncoder.Encoder_Blocks.i.{ln1,ln3..ln6, attn.*, mlp.*, mlp2.*}``,
``readout_n``, ``readout_e``.
"""

from __future__ import annotations

import numpy as np
import torch

from druggen_tpu_torch.interop.msgpack_ckpt import unstack_block_params

_LNS = (1, 3, 4, 5, 6)
_ATTN = ("q", "k", "v", "e", "out_e", "out_n")


def _unwrap(variables: dict) -> dict:
    return variables["params"] if "params" in variables else variables


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


# ---------------------------------------------------------------------------
# flax -> torch
# ---------------------------------------------------------------------------

def _emit_linear(out: dict, torch_prefix: str, p: dict) -> None:
    out[torch_prefix + ".weight"] = np.asarray(p["kernel"]).T.copy()
    out[torch_prefix + ".bias"] = np.asarray(p["bias"])


def _emit_ln(out: dict, torch_prefix: str, p: dict) -> None:
    out[torch_prefix + ".weight"] = np.asarray(p["scale"])
    out[torch_prefix + ".bias"] = np.asarray(p["bias"])


def _emit_mlp(out: dict, prefix: str, p: dict) -> None:
    _emit_linear(out, _join(prefix, "fc1"), p["fc1"])
    _emit_linear(out, _join(prefix, "fc2"), p["fc2"])


def _emit_mha(out: dict, prefix: str, p: dict) -> None:
    for name in _ATTN:
        _emit_linear(out, _join(prefix, name), p[name])


def _emit_block(out: dict, prefix: str, blk: dict) -> None:
    for i in _LNS:
        _emit_ln(out, _join(prefix, f"ln{i}"), blk[f"ln{i}"])
    _emit_mha(out, _join(prefix, "attn"), blk["attn"])
    for m in ("mlp", "mlp2"):
        _emit_mlp(out, _join(prefix, m), blk[m])


def _emit_trunk(out: dict, trunk: dict) -> None:
    _emit_linear(out, "node_layers.0", trunk["node_fc1"])
    _emit_linear(out, "node_layers.2", trunk["node_fc2"])
    _emit_linear(out, "edge_layers.0", trunk["edge_fc1"])
    _emit_linear(out, "edge_layers.2", trunk["edge_fc2"])
    enc = unstack_block_params({"encoder": trunk["encoder"]})["encoder"]
    for name, blk in enc.items():
        i = int(name.split("_")[1])
        _emit_block(out, f"TransformerEncoder.Encoder_Blocks.{i}", blk)


def flax_generator_to_torch(variables: dict) -> dict:
    """druggen_tpu Generator variables -> the port's state_dict (numpy
    values; wrap with :func:`to_torch_tensors`)."""
    p = _unwrap(variables)
    out: dict = {}
    _emit_trunk(out, p["trunk"])
    _emit_linear(out, "readout_n", p["readout_n"])
    _emit_linear(out, "readout_e", p["readout_e"])
    return out


def flax_mlp_to_torch(variables: dict) -> dict:
    out: dict = {}
    _emit_mlp(out, "", _unwrap(variables))
    return out


def flax_mha_to_torch(variables: dict) -> dict:
    out: dict = {}
    _emit_mha(out, "", _unwrap(variables))
    return out


def flax_encoder_block_to_torch(variables: dict) -> dict:
    out: dict = {}
    _emit_block(out, "", _unwrap(variables))
    return out


def to_torch_tensors(sd: dict) -> dict:
    """numpy-valued state_dict -> torch-tensor-valued."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# torch -> flax
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").numpy()
    return np.asarray(t)


def _linear(sd: dict, prefix: str) -> dict:
    return {"kernel": _np(sd[prefix + ".weight"]).T.copy(),
            "bias": _np(sd[prefix + ".bias"]).copy()}


def _ln(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[prefix + ".weight"]).copy(),
            "bias": _np(sd[prefix + ".bias"]).copy()}


def _block(sd: dict, prefix: str) -> dict:
    out = {f"ln{i}": _ln(sd, f"{prefix}.ln{i}") for i in _LNS}
    out["attn"] = {n: _linear(sd, f"{prefix}.attn.{n}") for n in _ATTN}
    for m in ("mlp", "mlp2"):
        out[m] = {f: _linear(sd, f"{prefix}.{m}.{f}") for f in ("fc1", "fc2")}
    return out


def torch_generator_to_flax(sd: dict) -> dict:
    """The port's Generator state_dict -> druggen_tpu Generator variables
    (``{'params': ...}``, unrolled layout)."""
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("TransformerEncoder.Encoder_Blocks."))
    trunk = {
        "node_fc1": _linear(sd, "node_layers.0"),
        "node_fc2": _linear(sd, "node_layers.2"),
        "edge_fc1": _linear(sd, "edge_layers.0"),
        "edge_fc2": _linear(sd, "edge_layers.2"),
        "encoder": {f"block_{i}": _block(
            sd, f"TransformerEncoder.Encoder_Blocks.{i}") for i in range(depth)},
    }
    return {"params": {"trunk": trunk,
                       "readout_n": _linear(sd, "readout_n"),
                       "readout_e": _linear(sd, "readout_e")}}

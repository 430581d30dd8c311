"""flax parameter trees <-> the port's state_dicts (pure numpy).

Copied from ``druggen_tpu/interop/torch_ckpt.py:211-258``
(``flax_generator_to_torch`` and its helpers) plus the reverse direction,
the Discriminator (head ``mlp_fc{1..4}`` <-> ``node_mlp.{0,2,4,6}``,
``torch_ckpt.py:25, 180-194``) and per-module variants.  This is how the JAX
package's parameters (as numpy) are carried into the port, and how the
port's weights go back.  :func:`gan_state_to_port` carries a whole JAX
``GANState`` (both parameter trees, both optimizers' AdamW moments and
counts, the non-finite guard's counters, the step) into the port's layout,
and :func:`port_to_gan_state` carries it back, as the flax state dict that a
full-state checkpoint (``state_*.msgpack``) holds.

Layout: ``nn.Linear.weight`` is ``[out, in]`` and flax ``Dense.kernel`` is
``[in, out]`` (transpose); ``LayerNorm.weight`` is flax ``LayerNorm.scale``.
Torch keys: ``node_layers.0/.2``, ``edge_layers.0/.2``,
``TransformerEncoder.Encoder_Blocks.i.{ln1,ln3..ln6, attn.*, mlp.*, mlp2.*}``,
``readout_n``, ``readout_e`` (Generator), ``node_mlp.{0,2,4,6}``
(Discriminator), ``predictor.{0,2,4,6,8,10}`` (SimpleDisc, flax
``fc1..fc6``).
"""

from __future__ import annotations

import numpy as np
import torch

from druggen_tpu_torch.interop.msgpack_ckpt import unstack_block_params

_LNS = (1, 3, 4, 5, 6)
_HEAD = (0, 2, 4, 6)        # node_mlp indices of mlp_fc1..mlp_fc4
_PREDICTOR = (0, 2, 4, 6, 8, 10)    # SimpleDisc's predictor indices of fc1..fc6
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


def flax_discriminator_to_torch(variables: dict) -> dict:
    """druggen_tpu Discriminator variables -> the port's state_dict."""
    p = _unwrap(variables)
    out: dict = {}
    _emit_trunk(out, p["trunk"])
    for i, tidx in enumerate(_HEAD, start=1):
        _emit_linear(out, f"node_mlp.{tidx}", p[f"mlp_fc{i}"])
    return out


def flax_simple_disc_to_torch(variables: dict) -> dict:
    """druggen_tpu SimpleDisc variables (``fc1..fc6``) -> the port's
    state_dict (``predictor.{0,2,4,6,8,10}``)."""
    p = _unwrap(variables)
    out: dict = {}
    for i, tidx in enumerate(_PREDICTOR, start=1):
        _emit_linear(out, f"predictor.{tidx}", p[f"fc{i}"])
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


def _trunk(sd: dict) -> dict:
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("TransformerEncoder.Encoder_Blocks."))
    return {
        "node_fc1": _linear(sd, "node_layers.0"),
        "node_fc2": _linear(sd, "node_layers.2"),
        "edge_fc1": _linear(sd, "edge_layers.0"),
        "edge_fc2": _linear(sd, "edge_layers.2"),
        "encoder": {f"block_{i}": _block(
            sd, f"TransformerEncoder.Encoder_Blocks.{i}") for i in range(depth)},
    }


def torch_generator_to_flax(sd: dict) -> dict:
    """The port's Generator state_dict -> druggen_tpu Generator variables
    (``{'params': ...}``, unrolled layout)."""
    return {"params": {"trunk": _trunk(sd),
                       "readout_n": _linear(sd, "readout_n"),
                       "readout_e": _linear(sd, "readout_e")}}


def torch_discriminator_to_flax(sd: dict) -> dict:
    """The port's Discriminator state_dict -> druggen_tpu Discriminator
    variables (``{'params': ...}``, unrolled layout)."""
    params = {"trunk": _trunk(sd)}
    for i, tidx in enumerate(_HEAD, start=1):
        params[f"mlp_fc{i}"] = _linear(sd, f"node_mlp.{tidx}")
    return {"params": params}


def torch_simple_disc_to_flax(sd: dict) -> dict:
    """The port's SimpleDisc state_dict -> druggen_tpu SimpleDisc
    variables."""
    return {"params": {f"fc{i}": _linear(sd, f"predictor.{tidx}")
                       for i, tidx in enumerate(_PREDICTOR, start=1)}}


# ---------------------------------------------------------------------------
# the JAX training state <-> the port's
# ---------------------------------------------------------------------------

_GUARD_FIELDS = {"notfinite_count", "total_notfinite", "inner_state"}


def _np_scalar(x) -> np.ndarray:
    return np.asarray(x).reshape(())


def _i32(x) -> np.ndarray:
    return np.asarray(x, np.int32).reshape(())


def _field(node, name: str):
    """A field of a NamedTuple state, or the same key of its flax state dict."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _guarded(opt_state) -> bool:
    if isinstance(opt_state, dict):
        return set(opt_state) == _GUARD_FIELDS
    return hasattr(opt_state, "inner_state")


def _opt_to_port(opt_state, to_torch) -> dict:
    """An ``optax.adamw`` state (``(ScaleByAdamState, EmptyState,
    EmptyState)``), bare or inside ``apply_if_all_finite``'s
    ``AllFiniteState`` (JAX ``train/step.py:62-65``), as objects or as their
    flax state dict -> ``{count, mu, nu, notfinite_count,
    total_notfinite}``; ``mu`` and ``nu`` as state_dicts of the model, the
    guard's counters 0 for a bare state."""
    guarded = _guarded(opt_state)
    chain = _field(opt_state, "inner_state") if guarded else opt_state
    adam = chain["0"] if isinstance(chain, dict) else chain[0]
    return {"count": _np_scalar(_field(adam, "count")),
            "mu": to_torch(_field(adam, "mu")), "nu": to_torch(_field(adam, "nu")),
            "notfinite_count": (_np_scalar(_field(opt_state, "notfinite_count"))
                                if guarded else _i32(0)),
            "total_notfinite": (_np_scalar(_field(opt_state, "total_notfinite"))
                                if guarded else _i32(0))}


def gan_state_to_port(state) -> dict:
    """A JAX ``GANState`` (``train/step.py:29-36``, fetched to numpy), or its
    flax state dict as a state file holds it -> ``{"g": state_dict, "d":
    state_dict, "g_opt": {...}, "d_opt": {...}, "step": int}`` in the port's
    layout (numpy values)."""
    return {"g": flax_generator_to_torch(_field(state, "g_params")),
            "d": flax_discriminator_to_torch(_field(state, "d_params")),
            "g_opt": _opt_to_port(_field(state, "g_opt_state"),
                                  flax_generator_to_torch),
            "d_opt": _opt_to_port(_field(state, "d_opt_state"),
                                  flax_discriminator_to_torch),
            "step": int(np.asarray(_field(state, "step")))}


def _opt_to_flax(opt: dict, to_flax, guarded: bool) -> dict:
    chain = {"0": {"count": _i32(opt["count"]), "mu": to_flax(opt["mu"]),
                   "nu": to_flax(opt["nu"])},
             "1": {}, "2": {}}          # add_decayed_weights, scale_by_lr
    if not guarded:
        return chain
    return {"notfinite_count": _i32(opt["notfinite_count"]),
            "total_notfinite": _i32(opt["total_notfinite"]),
            "inner_state": chain}


def port_to_gan_state(port: dict, guarded: bool = True) -> dict:
    """The reverse of :func:`gan_state_to_port`: the port's ``{g, d, g_opt,
    d_opt, step}`` -> the flax state dict of the JAX ``GANState``
    (``serialization.to_state_dict``; the guard's ``AllFiniteState`` around
    each optimizer state when ``guarded``), numpy leaves, f32 parameters and
    moments, int32 counters."""
    return {"g_params": torch_generator_to_flax(port["g"]),
            "d_params": torch_discriminator_to_flax(port["d"]),
            "g_opt_state": _opt_to_flax(port["g_opt"], torch_generator_to_flax,
                                        guarded),
            "d_opt_state": _opt_to_flax(port["d_opt"],
                                        torch_discriminator_to_flax, guarded),
            "step": _i32(port["step"])}

"""The native corrector's flax parameter tree <-> the port's state_dict
(pure numpy, exact both ways).

``druggen_tpu/infer/seq2seq.py``'s flax modules name their parameters by
creation order; :class:`..infer.seq2seq.Seq2Seq` names them by role:

========================================  ==============================
flax path (under ``params``)               port key
========================================  ==============================
``tok_emb/embedding``, ``pos_emb/...``     ``tok_emb.weight``, ``pos_emb.weight``
``{enc,dec}_layers_i/LayerNorm_0``         ``{enc,dec}_layers.i.ln_attn``
``.../MultiHeadDotProductAttention_0``     ``.../attn``
``dec_layers_i/LayerNorm_1``               ``dec_layers.i.ln_cross``
``dec_layers_i/MultiHeadDotProductAttention_1``  ``dec_layers.i.cross_attn``
``dec_layers_i/LayerNorm_2`` (on ctx)      ``dec_layers.i.ln_ctx``
``enc_layers_i/LayerNorm_1``, ``dec_layers_i/LayerNorm_3``  ``.../ln_mlp``
``.../Dense_0``, ``.../Dense_1``           ``.../fc1``, ``.../fc2``
``out``, ``final_ln``                      ``out``, ``final_ln``
========================================  ==============================

Values: ``Dense.kernel [in, out]`` is ``Linear.weight`` transposed;
``DenseGeneral`` query/key/value kernels ``[in, heads, head_dim]`` and
biases ``[heads, head_dim]`` flatten their last two axes, the out kernel
``[heads, head_dim, out]`` its first two; ``LayerNorm.scale`` is
``weight``.  The flax tree is emitted with its keys sorted at every level,
the order in which flax writes a tree it initialised or a step updated, so
that :func:`..interop.msgpack_ckpt.msgpack_serialize` writes the JAX
package's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

_ENC = {"LayerNorm_0": "ln_attn", "MultiHeadDotProductAttention_0": "attn",
        "LayerNorm_1": "ln_mlp", "Dense_0": "fc1", "Dense_1": "fc2"}
_DEC = {"LayerNorm_0": "ln_attn", "MultiHeadDotProductAttention_0": "attn",
        "LayerNorm_1": "ln_cross", "MultiHeadDotProductAttention_1": "cross_attn",
        "LayerNorm_2": "ln_ctx", "LayerNorm_3": "ln_mlp", "Dense_0": "fc1",
        "Dense_1": "fc2"}
_PROJ = ("query", "key", "value")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").numpy()
    return np.asarray(t)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _layers(sd: dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})


# ---------------------------------------------------------------------------
# port -> flax
# ---------------------------------------------------------------------------

def _dense(sd: dict, p: str) -> dict:
    return {"kernel": _np(sd[p + ".weight"]).T.copy(), "bias": _np(sd[p + ".bias"]).copy()}


def _ln(sd: dict, p: str) -> dict:
    return {"scale": _np(sd[p + ".weight"]).copy(), "bias": _np(sd[p + ".bias"]).copy()}


def _mha(sd: dict, p: str, heads: int) -> dict:
    out = {}
    for name in _PROJ:
        w, b = _np(sd[f"{p}.{name}.weight"]), _np(sd[f"{p}.{name}.bias"])
        out[name] = {"kernel": w.T.reshape(w.shape[1], heads, -1).copy(),
                     "bias": b.reshape(heads, -1).copy()}
    w = _np(sd[f"{p}.out.weight"])
    out["out"] = {"kernel": w.T.reshape(heads, -1, w.shape[0]).copy(),
                  "bias": _np(sd[f"{p}.out.bias"]).copy()}
    return out


def _layer_to_flax(sd: dict, p: str, names: dict, heads: int) -> dict:
    out = {}
    for flax_name, port_name in names.items():
        q = f"{p}.{port_name}"
        if flax_name.startswith("LayerNorm"):
            out[flax_name] = _ln(sd, q)
        elif flax_name.startswith("Dense"):
            out[flax_name] = _dense(sd, q)
        else:
            out[flax_name] = _mha(sd, q, heads)
    return out


def seq2seq_to_flax(sd: dict, heads: int) -> dict:
    """The port's :class:`Seq2Seq` state_dict -> the JAX ``Seq2Seq``
    variables ``{"params": ...}`` (numpy leaves, sorted keys)."""
    params = {"tok_emb": {"embedding": _np(sd["tok_emb.weight"]).copy()},
              "pos_emb": {"embedding": _np(sd["pos_emb.weight"]).copy()},
              "out": _dense(sd, "out"), "final_ln": _ln(sd, "final_ln")}
    for i in range(_layers(sd, "enc_layers")):
        params[f"enc_layers_{i}"] = _layer_to_flax(sd, f"enc_layers.{i}", _ENC, heads)
    for i in range(_layers(sd, "dec_layers")):
        params[f"dec_layers_{i}"] = _layer_to_flax(sd, f"dec_layers.{i}", _DEC, heads)
    return _sorted({"params": params})


# ---------------------------------------------------------------------------
# flax -> port
# ---------------------------------------------------------------------------

def _emit_dense(out: dict, p: str, d: dict) -> None:
    out[p + ".weight"] = np.asarray(d["kernel"]).T.copy()
    out[p + ".bias"] = np.asarray(d["bias"]).copy()


def _emit_ln(out: dict, p: str, d: dict) -> None:
    out[p + ".weight"] = np.asarray(d["scale"]).copy()
    out[p + ".bias"] = np.asarray(d["bias"]).copy()


def _emit_mha(out: dict, p: str, d: dict) -> None:
    for name in _PROJ:
        k = np.asarray(d[name]["kernel"])
        out[f"{p}.{name}.weight"] = k.reshape(k.shape[0], -1).T.copy()
        out[f"{p}.{name}.bias"] = np.asarray(d[name]["bias"]).reshape(-1).copy()
    k = np.asarray(d["out"]["kernel"])
    out[f"{p}.out.weight"] = k.reshape(-1, k.shape[-1]).T.copy()
    out[f"{p}.out.bias"] = np.asarray(d["out"]["bias"]).copy()


def flax_to_seq2seq_numpy(variables: dict) -> dict:
    """The JAX ``Seq2Seq`` variables (``{"params": ...}`` or the bare tree)
    -> the port's state_dict with numpy values."""
    p = variables["params"] if "params" in variables else variables
    out = {"tok_emb.weight": np.asarray(p["tok_emb"]["embedding"]).copy(),
           "pos_emb.weight": np.asarray(p["pos_emb"]["embedding"]).copy()}
    for side, names in (("enc_layers", _ENC), ("dec_layers", _DEC)):
        n = sum(1 for k in p if k.startswith(side + "_"))
        for i in range(n):
            layer = p[f"{side}_{i}"]
            for flax_name, port_name in names.items():
                q = f"{side}.{i}.{port_name}"
                if flax_name.startswith("LayerNorm"):
                    _emit_ln(out, q, layer[flax_name])
                elif flax_name.startswith("Dense"):
                    _emit_dense(out, q, layer[flax_name])
                else:
                    _emit_mha(out, q, layer[flax_name])
    _emit_dense(out, "out", p["out"])
    _emit_ln(out, "final_ln", p["final_ln"])
    return out


def flax_to_seq2seq(variables: dict) -> dict:
    """As :func:`flax_to_seq2seq_numpy`, with torch tensors (for
    ``load_state_dict``)."""
    return {k: torch.from_numpy(v) for k, v in flax_to_seq2seq_numpy(variables).items()}

"""Import the reference's released corrector (PAPYRUS_200) artifacts (port
of ``druggen_tpu/interop/corrector_ckpt.py``).

Three artifacts ship with the reference (downloaded by ``setup.sh``):

- ``<name>.pkg``          — torch ``state_dict`` of the Seq2Seq
  (saved/loaded at ``smiles_cor.py:1209``),
- ``<name>_vocab_src.pth``/``_vocab_trg.pth`` — ``torch.save``d
  ``torchtext.vocab.Vocab`` objects (``smiles_cor.py:1038-1039``).

torchtext is not a dependency, so :func:`install_torchtext_shim` registers
stand-in classes under the ``torchtext.vocab`` module names before
unpickling — the pickle only needs the class to exist and absorb its
``__dict__`` (freqs/itos/stoi).  A ``.pkg`` loads straight into
:class:`..infer.seq2seq_ref.ReferenceSeq2Seq`, whose keys are the
reference's; :func:`convert_corrector_state_dict` (copied, with the shim,
from the JAX module) and its inverse :func:`corrector_params_to_state_dict`
carry the JAX package's parameter pytree to and from those keys, which is
how :meth:`ReferenceCorrector.load_trained` reads a directory trained by
either package (``params.msgpack`` + ``vocab.json``, read without flax).
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch



# ------------------------------------------------------------- vocab shim

def _default_unk_index():
    return 0


class _ShimVocab:
    """Absorbs a pickled torchtext 0.6 ``Vocab`` (attrs: freqs, itos,
    stoi, vectors)."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def install_torchtext_shim() -> None:
    """Register minimal ``torchtext``/``torchtext.vocab`` modules so
    ``torch.load`` can unpickle saved Vocab objects without torchtext."""
    if "torchtext" in sys.modules and hasattr(sys.modules["torchtext"],
                                              "vocab"):
        return
    tt = types.ModuleType("torchtext")
    vocab_mod = types.ModuleType("torchtext.vocab")
    vocab_mod.Vocab = _ShimVocab
    vocab_mod._default_unk_index = _default_unk_index
    tt.vocab = vocab_mod
    sys.modules["torchtext"] = tt
    sys.modules["torchtext.vocab"] = vocab_mod
    # torchtext 0.6 pickles may also reference torchtext.data.utils
    data_mod = types.ModuleType("torchtext.data")
    utils_mod = types.ModuleType("torchtext.data.utils")
    tt.data = data_mod
    data_mod.utils = utils_mod
    sys.modules["torchtext.data"] = data_mod
    sys.modules["torchtext.data.utils"] = utils_mod


def load_torchtext_vocab(path: str) -> tuple[list[str], dict[str, int]]:
    """Load a ``torch.save``d torchtext Vocab -> (itos, stoi)."""
    import torch

    install_torchtext_shim()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    itos = list(obj.itos)
    stoi = {s: i for i, s in enumerate(itos)}
    # the pickled stoi is a defaultdict(unk); rebuild from itos for
    # determinism, then overlay any extra mappings
    for k, v in dict(getattr(obj, "stoi", {})).items():
        stoi.setdefault(k, v)
    return itos, stoi


# --------------------------------------------------------- weight convert

def _lin(sd, prefix):
    return {"kernel": np.asarray(sd[f"{prefix}.weight"]).T,
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _lnp(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _attn(sd, prefix):
    return {k: _lin(sd, f"{prefix}.{k}")
            for k in ("fc_q", "fc_k", "fc_v", "fc_o")}


def convert_corrector_state_dict(sd) -> dict:
    """torch state_dict (reference Seq2Seq) -> seq2seq_ref params pytree."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else
              np.asarray(v)) for k, v in sd.items()}
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("encoder.layers."))

    def block(side, i, decoder=False):
        p = f"{side}.layers.{i}"
        out = {
            "self_attention": _attn(sd, f"{p}.self_attention"),
            "self_attn_layer_norm": _lnp(sd, f"{p}.self_attn_layer_norm"),
            "positionwise_feedforward": {
                "fc_1": _lin(sd, f"{p}.positionwise_feedforward.fc_1"),
                "fc_2": _lin(sd, f"{p}.positionwise_feedforward.fc_2"),
            },
            "ff_layer_norm": _lnp(sd, f"{p}.ff_layer_norm"),
        }
        if decoder:
            out["encoder_attention"] = _attn(sd, f"{p}.encoder_attention")
            out["enc_attn_layer_norm"] = _lnp(sd, f"{p}.enc_attn_layer_norm")
        return out

    return {
        "encoder": {
            "tok_embedding": np.asarray(sd["encoder.tok_embedding.weight"]),
            "pos_embedding": np.asarray(sd["encoder.pos_embedding.weight"]),
            "layers": [block("encoder", i) for i in range(n_layers)],
        },
        "decoder": {
            "tok_embedding": np.asarray(sd["decoder.tok_embedding.weight"]),
            "pos_embedding": np.asarray(sd["decoder.pos_embedding.weight"]),
            "layers": [block("decoder", i, decoder=True)
                       for i in range(n_layers)],
            "fc_out": _lin(sd, "decoder.fc_out"),
        },
    }


def corrector_params_to_state_dict(params: dict) -> dict:
    """The inverse of :func:`convert_corrector_state_dict`: seq2seq_ref
    params pytree -> the reference Seq2Seq state_dict (numpy values)."""
    out: dict = {}

    def lin(prefix, p):
        out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T.copy()
        out[f"{prefix}.bias"] = np.asarray(p["bias"]).copy()

    def lnp(prefix, p):
        out[f"{prefix}.weight"] = np.asarray(p["scale"]).copy()
        out[f"{prefix}.bias"] = np.asarray(p["bias"]).copy()

    for side in ("encoder", "decoder"):
        p = params[side]
        out[f"{side}.tok_embedding.weight"] = np.asarray(p["tok_embedding"]).copy()
        out[f"{side}.pos_embedding.weight"] = np.asarray(p["pos_embedding"]).copy()
        for i, lp in enumerate(p["layers"]):
            q = f"{side}.layers.{i}"
            for attn in ("self_attention", "encoder_attention"):
                if attn in lp:
                    for k in ("fc_q", "fc_k", "fc_v", "fc_o"):
                        lin(f"{q}.{attn}.{k}", lp[attn][k])
            for ln in ("self_attn_layer_norm", "enc_attn_layer_norm", "ff_layer_norm"):
                if ln in lp:
                    lnp(f"{q}.{ln}", lp[ln])
            for k in ("fc_1", "fc_2"):
                lin(f"{q}.positionwise_feedforward.{k}", lp["positionwise_feedforward"][k])
        if "fc_out" in p:
            lin(f"{side}.fc_out", p["fc_out"])
    return out


def params_to_state_dict_file_layout(params: dict) -> dict:
    """The params pytree as flax's ``to_state_dict`` lays it out for a file:
    every dict's keys sorted (the order a tree updated by a JAX step has),
    every list a dict ``{"0": ..., "1": ...}``."""
    if isinstance(params, dict):
        return {k: params_to_state_dict_file_layout(params[k]) for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return {str(i): params_to_state_dict_file_layout(v) for i, v in enumerate(params)}
    return np.asarray(params)


def params_from_file_layout(tree):
    """The inverse of :func:`params_to_state_dict_file_layout` for the
    seq2seq_ref pytree: the ``layers`` dicts back to lists."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = [params_from_file_layout(v[str(i)]) for i in range(len(v))]
        else:
            out[k] = params_from_file_layout(v)
    return out


# -------------------------------------------------------------- wrapper

class ReferenceCorrector:
    """Run the released reference corrector on a device.

    ``ReferenceCorrector.load(model_pkg, src_vocab_pth, trg_vocab_pth)``
    then ``translate_batch(invalid_smiles) -> corrected_smiles`` (greedy,
    reversed-target decoding, reference smi_tokenizer regex).  ``params``:
    the JAX package's pytree (numpy leaves), as
    :func:`convert_corrector_state_dict` gives it."""

    def __init__(self, params, src_stoi, trg_itos, heads: int = 8,
                 max_len: int = 202, device: str | torch.device = "cuda"):
        from druggen_tpu_torch.infer.engine import resolve_device
        from druggen_tpu_torch.infer.seq2seq_ref import ReferenceSeq2Seq

        enc, dec = params["encoder"], params["decoder"]
        src_vocab, hid = np.shape(enc["tok_embedding"])
        self.model = ReferenceSeq2Seq(
            src_vocab, len(dec["tok_embedding"]), hid=hid, heads=heads,
            pf=np.shape(enc["layers"][0]["positionwise_feedforward"]["fc_1"]["kernel"])[1],
            n_layers=len(enc["layers"]), pos_rows=len(enc["pos_embedding"]))
        self.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                    corrector_params_to_state_dict(params).items()})
        self.model.to(resolve_device(device)).eval()
        self.src_stoi = src_stoi
        self.trg_itos = trg_itos
        self.heads = heads
        self.max_len = max_len
        # what train_reference_corrector recorded: the losses, the step's ms
        self.train_log: dict = {}

    @property
    def device(self) -> torch.device:
        return self.model.encoder.tok_embedding.weight.device

    @classmethod
    def load_trained(cls, path: str, device: str | torch.device = "cuda"
                     ) -> "ReferenceCorrector":
        """Load a from-scratch-trained reference-topology corrector
        (``train_corrector --arch reference`` of either package:
        params.msgpack + vocab.json in one directory)."""
        from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_restore

        with open(os.path.join(path, "vocab.json")) as f:
            meta = json.load(f)
        itos = meta["itos"]
        with open(os.path.join(path, "params.msgpack"), "rb") as f:
            params = params_from_file_layout(msgpack_restore(f.read()))
        stoi = {t: i for i, t in enumerate(itos)}
        return cls(params, stoi, itos, max_len=meta["max_len"], device=device)

    @classmethod
    def load(cls, model_pkg: str, src_vocab_pth: str, trg_vocab_pth: str,
             **kw) -> "ReferenceCorrector":
        sd = torch.load(model_pkg, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        _, src_stoi = load_torchtext_vocab(src_vocab_pth)
        trg_itos, _ = load_torchtext_vocab(trg_vocab_pth)
        return cls(convert_corrector_state_dict(sd), src_stoi, trg_itos, **kw)

    def _encode_src(self, smiles_list):
        from druggen_tpu_torch.infer.seq2seq import tokenize
        from druggen_tpu_torch.infer.seq2seq_ref import EOS, PAD, SOS, UNK

        L = self.max_len + 2
        arr = np.full((len(smiles_list), L), PAD, np.int32)
        for r, smi in enumerate(smiles_list):
            ids = [SOS] + [self.src_stoi.get(t, UNK)
                           for t in tokenize(smi)][:self.max_len] + [EOS]
            arr[r, :len(ids)] = ids
        return arr

    def translate_batch(self, smiles_list) -> list[str]:
        from druggen_tpu_torch.infer.seq2seq_ref import (
            decode_tokens,
            greedy_translate,
        )

        if not smiles_list:
            return []
        src = torch.as_tensor(self._encode_src(smiles_list), dtype=torch.long,
                              device=self.device)
        out = greedy_translate(self.model, src, max_len=self.max_len).cpu().numpy()
        return [decode_tokens(row, self.trg_itos, reverse=True)
                for row in out]

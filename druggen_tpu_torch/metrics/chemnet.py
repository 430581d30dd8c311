"""ChemNet SMILES embedder for literal FCD, in PyTorch on an explicit device.

Port of ``druggen_tpu/metrics/chemnet.py``.  The reference computes FCD
through ``fcd_torch`` (``reference/results/evaluate.py:12,36,69-83``):
SMILES are one-hot encoded over a fixed symbol table, run through the
pretrained ChemNet (Preuer et al. 2018, "Fréchet ChemNet Distance") — a
stack of 1-D convolutions and LSTMs — and the penultimate-layer activations
are fitted with a Gaussian on each side of the comparison.

The tokenizer, the one-hot encoding, the weight formats and
:meth:`ChemNet.random_init`'s numpy draws are the JAX module's, so both
packages build the same network from one seed or one file.  The layers:

- conv: ``F.conv1d`` with keras SAME padding made explicit
  (``(k - 1) // 2`` zeros on the left, ``k // 2`` on the right, as XLA pads
  an even kernel), then the activation; kernels ``[k, in, out]`` are stored
  as ``[out, in, k]``;
- LSTM: ``nn.LSTM`` (gates i, f, g, o; the one bias as ``bias_ih``) over
  each sequence's real tokens only (``pack_padded_sequence``): padded steps
  leave the carry unchanged and their outputs are zero (``h * m_t`` in JAX).
  A row with no token (an empty SMILES) never enters the LSTM and keeps the
  zero state, as in JAX.  When the last layer returns sequences the output
  is the one at the last step, ``x[:, -1, :]``, as in JAX;
- dense: ``x @ kernel + bias``, then the activation.

Precision: every call runs in full f32, as the JAX module does on the CPU:
TF32 is off for cuDNN (the convs and the LSTM) and for matmuls for the
call's own duration (:func:`_f32`), and the switches are restored after
it.  Unlike the JAX module the last chunk of a call is not padded to
``batch_size`` (nothing here compiles per shape).

``.npz`` naming scheme (layer index ``i`` in forward order)::

    conv{i}_kernel [k, in, out]    conv{i}_bias [out]
    lstm{i}_Wx [in, 4*h]           lstm{i}_Wh [h, 4*h]   lstm{i}_b [4*h]
    dense{i}_kernel [in, out]      dense{i}_bias [out]

with gate order i, f, g, o and a JSON architecture string under the key
``config`` (list of layer dicts, as produced by :func:`default_config`).
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from druggen_tpu_torch.infer.engine import resolve_device

# ---------------------------------------------------------------- tokens

# fcd_torch one-hot symbol table: two-char halogens/silicon first, then
# single chars, with a final "unknown" bucket.  Sequences are padded to
# PAD_LEN.
CHEMNET_SYMBOLS = (
    "Cl", "Br", "Si",
    "#", "(", ")", "+", "-", "/", "\\", "=", "@", "[", "]",
    "1", "2", "3", "4", "5", "6", "7", "8", "9",
    "B", "C", "F", "H", "I", "N", "O", "P", "S",
    "b", "c", "n", "o", "s", ".", "%",
)
_UNK = len(CHEMNET_SYMBOLS)          # final bucket
VOCAB_SIZE = len(CHEMNET_SYMBOLS) + 1
PAD_LEN = 350

_TWO_CHAR = {s for s in CHEMNET_SYMBOLS if len(s) == 2}
_ONE_CHAR = {s: i for i, s in enumerate(CHEMNET_SYMBOLS) if len(s) == 1}
_TWO_CHAR_IDX = {s: i for i, s in enumerate(CHEMNET_SYMBOLS) if len(s) == 2}


def tokenize(smiles: str) -> list[int]:
    out = []
    i = 0
    while i < len(smiles):
        two = smiles[i:i + 2]
        if two in _TWO_CHAR:
            out.append(_TWO_CHAR_IDX[two])
            i += 2
            continue
        out.append(_ONE_CHAR.get(smiles[i], _UNK))
        i += 1
    return out[:PAD_LEN]


def one_hot_batch(smiles_list) -> np.ndarray:
    """[B, PAD_LEN, VOCAB_SIZE] float32 (zero rows = padding)."""
    arr = np.zeros((len(smiles_list), PAD_LEN, VOCAB_SIZE), np.float32)
    for b, s in enumerate(smiles_list):
        for t, tok in enumerate(tokenize(s)):
            arr[b, t, tok] = 1.0
    return arr


# ---------------------------------------------------------------- layers

def default_config() -> list[dict]:
    """ChemNet-shaped architecture: conv stack -> LSTM stack -> 512-d
    penultimate activations.  Used for random-init testing; when a weight
    file carries its own architecture spec (fcd_torch .pt or the npz
    ``config`` key), that spec wins."""
    return [
        {"type": "conv", "filters": 32, "kernel": 9, "activation": "selu"},
        {"type": "conv", "filters": 64, "kernel": 9, "activation": "selu"},
        {"type": "conv", "filters": 128, "kernel": 10, "activation": "selu"},
        {"type": "lstm", "units": 256, "return_sequences": True},
        {"type": "lstm", "units": 512, "return_sequences": False},
    ]


_ACTIVATIONS = {"selu": F.selu, "relu": F.relu, "tanh": torch.tanh,
                "linear": lambda x: x}


@contextlib.contextmanager
def _f32():
    """cuDNN's and the matmuls' TF32 switches off for one call, then
    restored."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _masked_lstm(lstm: nn.LSTM, x: torch.Tensor, lengths: torch.Tensor,
                 return_sequences: bool) -> torch.Tensor:
    """The LSTM over each row's first ``lengths`` steps: outputs zero past
    them, the final state the one at the last real step, a row of length 0
    all zeros."""
    b, t, _ = x.shape
    rows = torch.nonzero(lengths > 0).flatten()
    out = x.new_zeros((b, t, lstm.hidden_size) if return_sequences
                      else (b, lstm.hidden_size))
    if len(rows) == 0:
        return out
    packed = pack_padded_sequence(x[rows], lengths[rows].cpu(), batch_first=True,
                                  enforce_sorted=False)
    seq, (h_last, _) = lstm(packed)
    if return_sequences:
        out[rows] = pad_packed_sequence(seq, batch_first=True, total_length=t)[0]
    else:
        out[rows] = h_last[0]
    return out


# ---------------------------------------------------------------- model

class ChemNet(nn.Module):
    """Config-driven ChemNet embedder on ``device``.

    ``config``: list of layer dicts (see :func:`default_config`).
    ``params``: list of per-layer tuples of numpy arrays, in the JAX
    module's layout.
    """

    def __init__(self, config: list[dict], params: list[tuple],
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.config = config
        self.params = [tuple(np.asarray(w, np.float32) for w in p)
                       for p in params]
        self.device = resolve_device(device)
        layers = []
        for layer, p in zip(config, self.params):
            if layer["type"] == "conv":
                kernel, bias = p
                mod = nn.Conv1d(kernel.shape[1], kernel.shape[2], kernel.shape[0])
                weights = (np.transpose(kernel, (2, 1, 0)), bias)
            elif layer["type"] == "lstm":
                wx, wh, b = p
                mod = nn.LSTM(wx.shape[0], wh.shape[0], batch_first=True)
                weights = (wx.T, wh.T, b, np.zeros_like(b))
            elif layer["type"] == "dense":
                kernel, bias = p
                mod = nn.Linear(kernel.shape[0], kernel.shape[1])
                weights = (kernel.T, bias)
            else:
                raise ValueError(f"unknown layer {layer}")
            with torch.no_grad():
                for param, w in zip(mod.parameters(), weights):
                    param.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            layers.append(mod)
        self.layers = nn.ModuleList(layers).to(self.device).eval()

    # ------------------------------------------------------- construction
    @classmethod
    def random_init(cls, seed: int = 0, config: list[dict] | None = None,
                    in_dim: int = VOCAB_SIZE,
                    device: str | torch.device = "cuda") -> "ChemNet":
        config = config or default_config()
        rng = np.random.default_rng(seed)
        params = []
        c = in_dim
        for layer in config:
            if layer["type"] == "conv":
                k, f = layer["kernel"], layer["filters"]
                params.append((rng.standard_normal((k, c, f)) / np.sqrt(k * c),
                               np.zeros(f)))
                c = f
            elif layer["type"] == "lstm":
                h = layer["units"]
                params.append((
                    rng.standard_normal((c, 4 * h)) / np.sqrt(c),
                    rng.standard_normal((h, 4 * h)) / np.sqrt(h),
                    np.zeros(4 * h)))
                c = h
            elif layer["type"] == "dense":
                u = layer["units"]
                params.append((rng.standard_normal((c, u)) / np.sqrt(c),
                               np.zeros(u)))
                c = u
            else:
                raise ValueError(f"unknown layer {layer}")
        return cls(config, params, device)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "ChemNet":
        """Load weights from ``.npz`` (documented scheme) or an
        fcd_torch-style ``.pt``."""
        if path.endswith(".npz"):
            config, params = _read_npz(path)
        else:
            config, params = _read_torch(path)
        return cls(config, params, device)

    def save_npz(self, path: str) -> None:
        out = {"config": json.dumps(self.config)}
        for i, (layer, p) in enumerate(zip(self.config, self.params)):
            if layer["type"] == "conv":
                out[f"conv{i}_kernel"], out[f"conv{i}_bias"] = p
            elif layer["type"] == "lstm":
                (out[f"lstm{i}_Wx"], out[f"lstm{i}_Wh"],
                 out[f"lstm{i}_b"]) = p
            elif layer["type"] == "dense":
                out[f"dense{i}_kernel"], out[f"dense{i}_bias"] = p
        np.savez(path, **out)

    # ---------------------------------------------------------- forward
    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One-hot ``x`` [B, T, VOCAB_SIZE] on the module's device -> [B, D]
        activations.  A row's tokens are a prefix (one-hot rows), its pads
        all-zero rows."""
        lengths = (x.sum(-1) > 0).sum(-1)
        with _f32():
            for layer, mod in zip(self.config, self.layers):
                if layer["type"] == "conv":
                    k = mod.kernel_size[0]
                    y = mod(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)))
                    x = _ACTIVATIONS[layer.get("activation", "selu")](y.transpose(1, 2))
                elif layer["type"] == "lstm":
                    x = _masked_lstm(mod, x, lengths,
                                     layer.get("return_sequences", False))
                else:
                    x = _ACTIVATIONS[layer.get("activation", "linear")](mod(x))
        if x.ndim == 3:                 # last layer returned sequences
            x = x[:, -1, :]
        return x

    def __call__(self, smiles_list, batch_size: int = 128) -> np.ndarray:
        """Embed SMILES -> [N, D] float32 activations (ChemNet featurizer
        contract for :class:`druggen_tpu_torch.metrics.fcd.FCD`)."""
        smiles_list = [s for s in smiles_list if s]
        if not smiles_list:
            dim = (self.config[-1].get("units")
                   or self.config[-1].get("filters"))
            return np.zeros((0, dim), np.float32)
        outs = []
        for i in range(0, len(smiles_list), batch_size):
            x = torch.from_numpy(one_hot_batch(smiles_list[i:i + batch_size]))
            outs.append(self.forward(x.to(self.device)).cpu().numpy())
        return np.concatenate(outs, axis=0)


def _read_npz(path: str) -> tuple[list[dict], list[tuple]]:
    data = np.load(path, allow_pickle=False)
    config = json.loads(str(data["config"]))
    params = []
    for i, layer in enumerate(config):
        if layer["type"] == "conv":
            params.append((data[f"conv{i}_kernel"], data[f"conv{i}_bias"]))
        elif layer["type"] == "lstm":
            params.append((data[f"lstm{i}_Wx"], data[f"lstm{i}_Wh"],
                           data[f"lstm{i}_b"]))
        elif layer["type"] == "dense":
            params.append((data[f"dense{i}_kernel"],
                           data[f"dense{i}_bias"]))
    return config, params


def _read_torch(path: str) -> tuple[list[dict], list[tuple]]:
    """Parse an fcd_torch-style checkpoint: torch.load yields a structure
    carrying keras-exported layer configs + weights.  Parsed defensively
    (conv kernels may arrive [out,in,k] torch-style or [k,in,out]
    keras-style; LSTM gate order keras i,f,c,o is our i,f,g,o)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "config" in obj and "params" in obj:
        # our own serialization round-trip
        return obj["config"], [[np.asarray(w) for w in p] for p in obj["params"]]
    config: list[dict] = []
    params: list[tuple] = []
    entries = obj if isinstance(obj, (list, tuple)) else obj.items()
    for entry in entries:
        name, payload = entry if isinstance(entry, tuple) else (
            entry.get("name", ""), entry)
        lname = str(name).lower()
        ws = [np.asarray(w) for w in
              (payload.get("weights") if isinstance(payload, dict)
               else payload)]
        if "conv" in lname:
            k = ws[0]
            if k.ndim == 3 and k.shape[0] < k.shape[2]:
                pass                       # already [k, in, out]
            elif k.ndim == 3:
                k = np.transpose(k, (2, 1, 0))  # torch [out,in,k]
            config.append({"type": "conv", "filters": k.shape[2],
                           "kernel": k.shape[0], "activation": "selu"})
            params.append((k, ws[1]))
        elif "lstm" in lname:
            Wx, Wh, b = ws[0], ws[1], ws[2]
            if Wx.shape[0] == 4 * Wh.shape[-1]:   # torch [4h, in]
                Wx, Wh = Wx.T, Wh.T
            config.append({"type": "lstm", "units": Wh.shape[0],
                           "return_sequences": True})
            params.append((Wx, Wh, b))
        elif "dense" in lname:
            kern = ws[0]
            if kern.ndim == 2 and kern.shape[0] < kern.shape[1]:
                kern = kern.T
            config.append({"type": "dense", "units": kern.shape[1],
                           "activation": "linear"})
            params.append((kern, ws[1]))
    if not config:
        raise ValueError(f"unrecognized ChemNet checkpoint: {path}")
    if config[-1]["type"] == "lstm":
        config[-1]["return_sequences"] = False
    return config, params


def chemnet_from_env(device: str | torch.device = "cuda") -> ChemNet | None:
    """Load ChemNet weights from $DRUGGEN_CHEMNET_WEIGHTS if set."""
    path = os.environ.get("DRUGGEN_CHEMNET_WEIGHTS")
    if path and os.path.exists(path):
        return ChemNet.load(path, device)
    return None

"""Reference-exact corrector transformer, weight-compatible (port of
``druggen_tpu/infer/seq2seq_ref.py``).

The reference's SMILES corrector (``reference/src/util/smiles_cor.py``) is a
post-LN encoder/decoder transformer (Encoder 575-606, EncoderLayer 608-637,
MultiHeadAttentionLayer 639-690, PositionwiseFeedforward 692-705, Decoder
708-753, DecoderLayer 755-795, Seq2Seq 798-882) with separate source/target
embeddings, sqrt(hid) embedding scale, and greedy 202-step decode over
reversed-target tokens (``translate_sentence``, 864-882).

:class:`ReferenceSeq2Seq` computes what the JAX package's pure functions
compute (LayerNorm epsilon 1e-5, masked logits ``-1e10``), and its
submodules carry the reference's own ``state_dict`` keys
(``encoder.layers.i.self_attention.fc_q``, ..., ``decoder.fc_out``), so a
released ``.pkg`` loads with ``load_state_dict``.  The JAX package's
parameter pytree (``encoder``/``decoder`` with ``layers`` lists, flax
``kernel``/``scale`` leaves) converts to and from it through
``interop/corrector_ckpt.py``.  Inference only (the reference's dropout
layers are identity there); :func:`greedy_translate` runs the fixed-length
buffer as JAX's scan does, until every row has emitted EOS.

:func:`init_params` and :func:`decode_tokens` are copied from the JAX
module: ``init_params`` draws with numpy, so a seed gives the JAX package's
weights bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# torchtext Field default specials order (Field(init/eos specified):
# ['<unk>', '<pad>', '<sos>', '<eos>'] — smiles_cor.py:953-965)
UNK, PAD, SOS, EOS = 0, 1, 2, 3
_MASKED = -1e10     # the reference's masked energy (smiles_cor.py:675)


class MultiHeadAttentionLayer(nn.Module):
    """Reference MultiHeadAttentionLayer.forward (smiles_cor.py:655-690):
    standard scaled dot-product; mask==0 positions get -1e10."""

    def __init__(self, hid: int, heads: int):
        super().__init__()
        self.heads = heads
        self.fc_q = nn.Linear(hid, hid)
        self.fc_k = nn.Linear(hid, hid)
        self.fc_v = nn.Linear(hid, hid)
        self.fc_o = nn.Linear(hid, hid)

    def forward(self, q_in, k_in, v_in, mask):
        b, ql, d = q_in.shape
        hd = d // self.heads
        q = self.fc_q(q_in).view(b, ql, self.heads, hd).transpose(1, 2)
        k = self.fc_k(k_in).view(b, -1, self.heads, hd).transpose(1, 2)
        v = self.fc_v(v_in).view(b, -1, self.heads, hd).transpose(1, 2)
        energy = q @ k.transpose(-1, -2) / math.sqrt(hd)
        energy = energy.masked_fill(~mask, _MASKED)
        attn = torch.softmax(energy, dim=-1)
        return self.fc_o((attn @ v).transpose(1, 2).reshape(b, ql, d))


class PositionwiseFeedforwardLayer(nn.Module):
    def __init__(self, hid: int, pf: int):
        super().__init__()
        self.fc_1 = nn.Linear(hid, pf)
        self.fc_2 = nn.Linear(pf, hid)

    def forward(self, x):
        return self.fc_2(torch.relu(self.fc_1(x)))


class _Layer(nn.Module):
    """EncoderLayer (smiles_cor.py:608-637) or, with ``decoder``,
    DecoderLayer (755-795): post-LN residual sublayers."""

    def __init__(self, hid: int, heads: int, pf: int, decoder: bool = False):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(hid)
        if decoder:
            self.enc_attn_layer_norm = nn.LayerNorm(hid)
        self.ff_layer_norm = nn.LayerNorm(hid)
        self.self_attention = MultiHeadAttentionLayer(hid, heads)
        if decoder:
            self.encoder_attention = MultiHeadAttentionLayer(hid, heads)
        self.positionwise_feedforward = PositionwiseFeedforwardLayer(hid, pf)

    def forward(self, x, mask, enc=None, enc_mask=None):
        x = self.self_attn_layer_norm(x + self.self_attention(x, x, x, mask))
        if enc is not None:
            x = self.enc_attn_layer_norm(
                x + self.encoder_attention(x, enc, enc, enc_mask))
        return self.ff_layer_norm(x + self.positionwise_feedforward(x))


class _Side(nn.Module):
    """Encoder (smiles_cor.py:575-606) or Decoder (708-753)."""

    def __init__(self, vocab: int, hid: int, heads: int, pf: int,
                 n_layers: int, pos_rows: int, decoder: bool = False):
        super().__init__()
        self.tok_embedding = nn.Embedding(vocab, hid)
        self.pos_embedding = nn.Embedding(pos_rows, hid)
        self.layers = nn.ModuleList([_Layer(hid, heads, pf, decoder)
                                     for _ in range(n_layers)])
        if decoder:
            self.fc_out = nn.Linear(hid, vocab)

    def embed(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        scale = math.sqrt(self.tok_embedding.embedding_dim)
        return self.tok_embedding(ids) * scale + self.pos_embedding(pos)


class ReferenceSeq2Seq(nn.Module):
    """The reference Seq2Seq (smiles_cor.py:798-882) with its state_dict
    keys.  ``pos_rows``: rows of each positional table (``max_len + 2``
    for a model of :func:`init_params`)."""

    def __init__(self, src_vocab: int, trg_vocab: int, hid: int = 256,
                 heads: int = 8, pf: int = 512, n_layers: int = 3,
                 pos_rows: int = 204):
        super().__init__()
        self.heads = heads
        self.encoder = _Side(src_vocab, hid, heads, pf, n_layers, pos_rows)
        self.decoder = _Side(trg_vocab, hid, heads, pf, n_layers, pos_rows,
                             decoder=True)

    def encode(self, src, src_mask):
        x = self.encoder.embed(src)
        for layer in self.encoder.layers:
            x = layer(x, src_mask)
        return x

    def decode(self, trg, enc, src_mask, trg_pad: int = PAD):
        x = self.decoder.embed(trg)
        trg_mask = make_trg_mask(trg, trg_pad)
        for layer in self.decoder.layers:
            x = layer(x, trg_mask, enc, src_mask)
        return self.decoder.fc_out(x)

    def forward(self, src, trg, src_pad: int = PAD, trg_pad: int = PAD):
        """Reference Seq2Seq.forward (logits over target positions)."""
        src_mask = make_src_mask(src, src_pad)
        return self.decode(trg, self.encode(src, src_mask), src_mask, trg_pad)


def make_src_mask(src, pad_idx=PAD):
    return (src != pad_idx)[:, None, None, :]


def make_trg_mask(trg, pad_idx=PAD):
    n = trg.shape[1]
    pad_mask = (trg != pad_idx)[:, None, None, :]
    sub = torch.ones(n, n, dtype=torch.bool, device=trg.device).tril()
    return pad_mask & sub[None, None, :, :]


@torch.no_grad()
def greedy_translate(model: ReferenceSeq2Seq, src, *, max_len: int = 202):
    """Reference translate_sentence (smiles_cor.py:864-882), batched as
    JAX's scan: a ``max_len + 1`` buffer starting with SOS, one decoder pass
    over the whole buffer per emitted token, no done mask; returns
    ``buf[:, 1:]``.  The loop ends once every row holds an EOS: each row's
    tokens up to its first EOS are JAX's (the causal mask hides the later
    positions), the rest stay PAD where JAX's scan writes on, and
    :func:`decode_tokens`, which stops at the first EOS, reads the same
    strings from both."""
    b = src.shape[0]
    src_mask = make_src_mask(src)
    enc = model.encode(src, src_mask)
    buf = torch.full((b, max_len + 1), PAD, dtype=torch.long, device=src.device)
    buf[:, 0] = SOS
    seen_eos = torch.zeros(b, dtype=torch.bool, device=src.device)
    for t in range(1, max_len + 1):
        logits = model.decode(buf, enc, src_mask)
        buf[:, t] = logits[:, t - 1].argmax(-1)
        seen_eos |= buf[:, t] == EOS
        if bool(seen_eos.all()):
            break
    return buf[:, 1:]



def init_params(seed: int, src_vocab_size: int, trg_vocab_size: int,
                hid: int = 256, pf: int = 512, n_layers: int = 3,
                max_len: int = 202) -> dict:
    """Random init of the reference-topology params pytree — the same
    nesting ``interop.corrector_ckpt.convert_corrector_state_dict``
    produces, so a from-scratch-trained model and an imported PAPYRUS_200
    checkpoint are interchangeable.  Xavier-uniform linears and N(0,1)
    embeddings match the reference's torch defaults
    (``smiles_cor.py:575-606`` nn.Linear / nn.Embedding)."""
    rng = np.random.default_rng(seed)

    def lin(i, o):
        bound = math.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    def lnp():
        return {"scale": np.ones(hid, np.float32),
                "bias": np.zeros(hid, np.float32)}

    def attn():
        return {"fc_q": lin(hid, hid), "fc_k": lin(hid, hid),
                "fc_v": lin(hid, hid), "fc_o": lin(hid, hid)}

    def block(decoder=False):
        out = {
            "self_attention": attn(),
            "self_attn_layer_norm": lnp(),
            "positionwise_feedforward": {"fc_1": lin(hid, pf),
                                         "fc_2": lin(pf, hid)},
            "ff_layer_norm": lnp(),
        }
        if decoder:
            out["encoder_attention"] = attn()
            out["enc_attn_layer_norm"] = lnp()
        return out

    def emb(v):
        return rng.standard_normal((v, hid)).astype(np.float32)

    pos_rows = max_len + 2          # SOS + tokens + EOS buffer length
    return {
        "encoder": {
            "tok_embedding": emb(src_vocab_size),
            "pos_embedding": emb(pos_rows),
            "layers": [block() for _ in range(n_layers)],
        },
        "decoder": {
            "tok_embedding": emb(trg_vocab_size),
            "pos_embedding": emb(pos_rows),
            "layers": [block(decoder=True) for _ in range(n_layers)],
            "fc_out": lin(hid, trg_vocab_size),
        },
    }


def decode_tokens(ids_row, itos, reverse: bool = True) -> str:
    """Token ids -> SMILES string.  The reference trains the target field
    REVERSED (Field(tokenize=smi_tokenizer(x, reverse=True)),
    smiles_cor.py:959-965), so decoding reverses back."""
    toks = []
    for i in ids_row:
        i = int(i)
        if i == EOS:
            break
        if i in (PAD, SOS, UNK):
            continue
        toks.append(itos[i] if i < len(itos) else "")
    if reverse:
        toks = toks[::-1]
    return "".join(toks)

"""Neural SMILES corrector: sequence-to-sequence transformer (port of
``druggen_tpu/infer/seq2seq.py``).

The reference's adapted SMILES-corrector (``src/util/smiles_cor.py:575-882``:
3-layer encoder/decoder transformer, hidden 256, 8 heads, feed-forward 512,
max length 202, greedy decode), as the JAX package's pre-LN redesign:
:class:`TransformerLayer` and :class:`Seq2Seq` compute what the flax modules
compute (``nn.LayerNorm`` with epsilon 1e-6, ``nn.MultiHeadDotProductAttention``
dividing the query by sqrt(head_dim) and filling masked logits with the
dtype's lowest finite value), in plain tensor ops.  :func:`greedy_decode`
is JAX's scan as a loop, with the ``done`` mask and PAD after EOS; it stops
once every row has emitted EOS, where the remaining steps would write only
PAD.

:class:`Seq2SeqCorrector` saves and loads the JAX directory layout
(``meta.json``, ``tokenizer.json``, ``params.msgpack`` in flax's
``{"params": ...}`` tree, :mod:`..interop.corrector_weights`), so a corrector
trained by either package loads in the other.  :func:`train_corrector`
draws its pairs and batches from one ``np.random.default_rng(seed)`` in
JAX's order and steps ``optax.adamw``'s defaults (weight decay 1e-4 on every
parameter, no non-finite guard).

The tokenizer and the pair functions are copied from the JAX module.
"""

from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from druggen_tpu_torch.interop.corrector_weights import flax_to_seq2seq, seq2seq_to_flax
from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_restore, msgpack_serialize


_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|se|as|[BCNOSPFI]|[bcnops]|\(|\)|\.|=|#|-|\+|\\|/|:"
    r"|@@?|\?|>|\*|\$|%[0-9]{2}|[0-9])")

PAD, SOS, EOS, UNK = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<sos>", "<eos>", "<unk>"]


def tokenize(smiles: str) -> list[str]:
    return [t for t in _TOKEN_RE.findall(smiles)]


@dataclass
class Tokenizer:
    vocab: dict[str, int] = field(default_factory=dict)

    @classmethod
    def build(cls, smiles_iter) -> "Tokenizer":
        toks: set[str] = set()
        for s in smiles_iter:
            toks.update(tokenize(s))
        vocab = {t: i for i, t in enumerate(_SPECIALS + sorted(toks))}
        return cls(vocab)

    @property
    def size(self) -> int:
        return len(self.vocab)

    def encode(self, smiles: str, max_len: int) -> np.ndarray:
        ids = [SOS] + [self.vocab.get(t, UNK) for t in tokenize(smiles)][
            : max_len - 2] + [EOS]
        out = np.full(max_len, PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        inv = {i: t for t, i in self.vocab.items()}
        out = []
        for i in np.asarray(ids).tolist():
            if i == EOS:
                break
            if i in (PAD, SOS):
                continue
            out.append(inv.get(int(i), ""))
        return "".join(out)

    def to_json(self) -> str:
        return json.dumps(self.vocab)

    @classmethod
    def from_json(cls, s: str) -> "Tokenizer":
        return cls(json.loads(s))


# ---------------------------------------------------------------- model

_LN_EPS = 1e-6      # flax nn.LayerNorm's default epsilon


def _layer_norm(hid: int) -> nn.LayerNorm:
    return nn.LayerNorm(hid, eps=_LN_EPS)


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads=heads,
    qkv_features=hid)`` with no dropout: ``query``/``key``/``value`` project
    to ``heads x head_dim``, the query is divided by sqrt(head_dim) before
    the product, masked logits are the dtype's lowest finite value, and
    ``out`` projects the heads back."""

    def __init__(self, hid: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hid, hid)
        self.key = nn.Linear(hid, hid)
        self.value = nn.Linear(hid, hid)
        self.out = nn.Linear(hid, hid)

    def forward(self, x, kv, mask):
        """``x [B, Lq, hid]``, ``kv [B, Lk, hid]``, ``mask`` broadcastable
        to ``[B, heads, Lq, Lk]`` (True where a key is seen)."""
        b, lq, hid = x.shape
        hd = hid // self.heads
        q = self.query(x).view(b, lq, self.heads, hd)
        k = self.key(kv).view(b, kv.shape[1], self.heads, hd)
        v = self.value(kv).view(b, kv.shape[1], self.heads, hd)
        q = q / math.sqrt(hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, hid))


class TransformerLayer(nn.Module):
    """Pre-LN block (JAX ``TransformerLayer``): self-attention (causal in the
    decoder), in the decoder cross-attention on the LayerNormed context, then
    the ReLU MLP, each on a residual."""

    def __init__(self, hid: int, heads: int, pf: int, causal: bool = False,
                 cross: bool = False):
        super().__init__()
        self.causal, self.cross = causal, cross
        self.ln_attn = _layer_norm(hid)
        self.attn = Attention(hid, heads)
        if cross:
            self.ln_cross = _layer_norm(hid)
            self.cross_attn = Attention(hid, heads)
            self.ln_ctx = _layer_norm(hid)
        self.ln_mlp = _layer_norm(hid)
        self.fc1 = nn.Linear(hid, pf)
        self.fc2 = nn.Linear(pf, hid)

    def forward(self, x, mask, ctx=None, ctx_mask=None):
        h = self.ln_attn(x)
        attn_mask = mask[:, None, None, :]
        if self.causal:
            n = x.shape[1]
            causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            attn_mask = attn_mask & causal[None, None, :, :]
        x = x + self.attn(h, h, attn_mask)
        if self.cross:
            h = self.ln_cross(x)
            x = x + self.cross_attn(h, self.ln_ctx(ctx), ctx_mask[:, None, None, :])
        h = self.fc2(torch.relu(self.fc1(self.ln_mlp(x))))
        return x + h


class Seq2Seq(nn.Module):
    """Encoder-decoder over token ids; reference topology
    (smiles_cor.py:931-1120: enc/dec layers 3, hid 256, heads 8, pf 512,
    max_len 202).  Parameters are drawn as flax initialises them (LeCun
    truncated normal kernels, zero biases, unit-variance-over-fan-in
    embeddings) from ``generator`` (a fixed seed when none is given)."""

    def __init__(self, vocab_size: int, hid: int = 256, heads: int = 8,
                 pf: int = 512, n_layers: int = 3, max_len: int = 202,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.vocab_size, self.hid, self.heads = vocab_size, hid, heads
        self.pf, self.n_layers, self.max_len = pf, n_layers, max_len
        self.tok_emb = nn.Embedding(vocab_size, hid)
        self.pos_emb = nn.Embedding(max_len, hid)
        self.enc_layers = nn.ModuleList(
            [TransformerLayer(hid, heads, pf) for _ in range(n_layers)])
        self.dec_layers = nn.ModuleList(
            [TransformerLayer(hid, heads, pf, causal=True, cross=True)
             for _ in range(n_layers)])
        self.out = nn.Linear(hid, vocab_size)
        self.final_ln = _layer_norm(hid)
        _flax_init_(self, generator or torch.Generator().manual_seed(0))

    def meta(self) -> dict:
        return {"vocab_size": self.vocab_size, "hid": self.hid,
                "heads": self.heads, "pf": self.pf,
                "n_layers": self.n_layers, "max_len": self.max_len}

    def _embed(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        return self.tok_emb(ids) + self.pos_emb(pos)

    def encode(self, src):
        mask = src != PAD
        x = self._embed(src)
        for layer in self.enc_layers:
            x = layer(x, mask)
        return x, mask

    def decode_logits(self, tgt, ctx, ctx_mask):
        mask = tgt != PAD
        x = self._embed(tgt)
        for layer in self.dec_layers:
            x = layer(x, mask, ctx, ctx_mask)
        return self.out(self.final_ln(x))

    def forward(self, src, tgt):
        ctx, ctx_mask = self.encode(src)
        return self.decode_logits(tgt, ctx, ctx_mask)


@torch.no_grad()
def _flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers: ``nn.Dense``/``DenseGeneral`` kernels
    LeCun truncated normal over the fan-in (bias zero), ``nn.Embed``
    normal with variance 1 / features, ``nn.LayerNorm`` ones and zeros."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            # variance_scaling(1, fan_in, truncated_normal): the standard
            # deviation of a normal truncated at +-2 is 0.8796... of 1
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim),
                             generator=generator)


@torch.no_grad()
def greedy_decode(model: Seq2Seq, src, max_len: int | None = None):
    """Batched greedy decoding (reference's 202-step loop,
    smiles_cor.py:864-882; JAX's ``lax.scan``): ``src [B, L]`` token ids on
    the model's device -> ``[B, max_len]`` with SOS first and PAD after each
    row's EOS.  The loop ends once every row is done: the steps it skips
    would write PAD over PAD."""
    max_len = max_len or model.max_len
    ctx, ctx_mask = model.encode(src)
    b = src.shape[0]
    tgt = torch.full((b, max_len), PAD, dtype=torch.long, device=src.device)
    tgt[:, 0] = SOS
    done = torch.zeros(b, dtype=torch.bool, device=src.device)
    for t in range(max_len - 1):
        logits = model.decode_logits(tgt, ctx, ctx_mask)
        nxt = logits[:, t, :].argmax(-1)
        nxt = torch.where(done, PAD, nxt)
        tgt[:, t + 1] = nxt
        done = done | (nxt == EOS)
        if bool(done.all()):
            break
    return tgt


# ---------------------------------------------------------------- wrapper

class Seq2SeqCorrector:
    """Checkpointable corrector with the reference's translate contract
    (``correct_SMILES``, smiles_cor.py:1180-1215).  ``model`` holds the
    weights and runs on its own device."""

    def __init__(self, model: Seq2Seq, tokenizer: Tokenizer):
        self.model = model.eval()
        self.tokenizer = tokenizer
        # what train_corrector recorded: the losses, the step's device ms
        self.train_log: dict = {}

    @property
    def device(self) -> torch.device:
        return self.model.tok_emb.weight.device

    def _decode(self, smiles_list) -> np.ndarray:
        src = np.stack([self.tokenizer.encode(s, self.model.max_len)
                        for s in smiles_list])
        src = torch.as_tensor(src, dtype=torch.long, device=self.device)
        return greedy_decode(self.model, src).cpu().numpy()

    def translate(self, smiles: str) -> str:
        return self.tokenizer.decode(self._decode([smiles])[0])

    def translate_batch(self, smiles_list: list[str]) -> list[str]:
        if not smiles_list:
            return []
        return [self.tokenizer.decode(row) for row in self._decode(smiles_list)]

    def save(self, path: str) -> None:
        """The JAX ``Seq2SeqCorrector.save`` layout, byte for byte."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self.model.meta(), f)
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            f.write(self.tokenizer.to_json())
        with open(os.path.join(path, "params.msgpack"), "wb") as f:
            f.write(msgpack_serialize(seq2seq_to_flax(self.model.state_dict(),
                                                     self.model.heads)))

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "Seq2SeqCorrector":
        """A corrector saved by this class or by the JAX package's, on
        ``device``."""
        from druggen_tpu_torch.infer.engine import resolve_device

        device = resolve_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "tokenizer.json")) as f:
            tokenizer = Tokenizer.from_json(f.read())
        model = Seq2Seq(**meta)
        with open(os.path.join(path, "params.msgpack"), "rb") as f:
            model.load_state_dict(flax_to_seq2seq(msgpack_restore(f.read())))
        return cls(model.to(device), tokenizer)


# ---------------------------------------------------------------- training

def corruption_pairs(smiles_list, rng: np.random.Generator,
                     n_per_mol: int = 2) -> list[tuple[str, str]]:
    """(corrupted, correct) pairs by random token edits — the offline
    substitute for the reference's pretraining corpus."""
    ops = ("delete", "duplicate", "swap", "replace")
    alphabet = ["C", "c", "N", "n", "O", "o", "(", ")", "1", "2", "=", "#"]
    pairs = []
    for s in smiles_list:
        toks = tokenize(s)
        if len(toks) < 3:
            continue
        for _ in range(n_per_mol):
            t = list(toks)
            for _ in range(rng.integers(1, 3)):
                op = ops[rng.integers(0, len(ops))]
                i = int(rng.integers(0, len(t)))
                if op == "delete" and len(t) > 2:
                    del t[i]
                elif op == "duplicate":
                    t.insert(i, t[i])
                elif op == "swap" and i + 1 < len(t):
                    t[i], t[i + 1] = t[i + 1], t[i]
                elif op == "replace":
                    t[i] = alphabet[rng.integers(0, len(alphabet))]
            pairs.append(("".join(t), s))
    return pairs


def _repair_to_valid(mol):
    """Minimal-intervention repair of a failed decode, for use as a
    correction TARGET: (1) the reference's valence repair (bond removal,
    dataset.py:251-277), then (2) demote aromatic bonds outside rings to
    single (the generator's dominant aromatic failure mode), then (3) as a
    last resort fully de-aromatize.  Returns a sanitized Mol or None."""
    from druggen_tpu_torch.chem.codec import correct_mol
    from druggen_tpu_torch.chem.mol import BondType

    def _try(m):
        try:
            m.sanitize()
            return True
        except Exception:
            return False

    def _reset(m):
        m._adj = None
        m._kekule_double = None
        m.sanitized = False

    mol = correct_mol(mol, max_steps=4 * len(mol.bonds) + 50)
    if _try(mol):
        return mol
    ring_bonds = {frozenset((r[i], r[(i + 1) % len(r)]))
                  for r in mol.ring_info() for i in range(len(r))}
    for b in mol.bonds:
        if (b.type == BondType.AROMATIC
                and frozenset((b.a1, b.a2)) not in ring_bonds):
            b.type = BondType.SINGLE
    _reset(mol)
    if _try(mol):
        return mol
    for b in mol.bonds:
        if b.type == BondType.AROMATIC:
            b.type = BondType.SINGLE
    for a in mol.atoms:
        a.aromatic = False
    _reset(mol)
    mol = correct_mol(mol, max_steps=4 * len(mol.bonds) + 50)
    return mol if _try(mol) else None


def generator_failure_pairs(node_labels, edge_labels, vocab,
                            max_pairs: int | None = None,
                            max_src_tokens: int = 200
                            ) -> list[tuple[str, str]]:
    """(invalid_raw_smiles, repaired_valid_smiles) pairs from *actual*
    generator outputs.

    The reference's corrector is applied to the raw SMILES the generator
    writes at inference (inference.py:233, smiles_cor.py:1180-1215).  To
    train on the same failure distribution, take argmax label matrices
    whose strict decode fails, write the unsanitized molecule as a (by
    construction invalid) SMILES string, and use the valence-repaired
    decode (reference correct_mol semantics, dataset.py:251-277) as the
    ground-truth correction target."""
    from druggen_tpu_torch.chem.canon import mol_to_smiles
    from druggen_tpu_torch.chem.codec import (
        matrices_to_mol,
        strip_to_largest_fragment,
    )
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    pairs: list[tuple[str, str]] = []
    seen: set[str] = set()
    for x_l, a_l in zip(node_labels, edge_labels):
        if matrices_to_mol(x_l, a_l, vocab, strict=True) is not None:
            continue                      # decodes fine; nothing to learn
        raw = matrices_to_mol(x_l, a_l, vocab, strict=False)
        if raw is None:
            continue
        try:
            src = strip_to_largest_fragment(mol_to_smiles(raw,
                                                          canonical=False))
        except Exception:
            continue
        if not src or src in seen:
            continue
        # a seq2seq with max_len ~202 can't learn from fully-dense garbage
        # graphs whose SMILES blow the context — skip monsters (the
        # reference's corrector likewise sees only inference-written
        # near-valid strings, smiles_cor.py:1180-1215)
        if len(tokenize(src)) > max_src_tokens:
            continue
        repaired = _repair_to_valid(matrices_to_mol(x_l, a_l, vocab,
                                                    strict=False))
        if repaired is None:
            continue
        try:
            tgt = strip_to_largest_fragment(mol_to_smiles(repaired))
        except Exception:
            continue
        m = mol_from_smiles(tgt)
        if m is None or not tgt:
            continue
        try:
            m.sanitize()
        except Exception:
            continue
        seen.add(src)
        pairs.append((src, tgt))
        if max_pairs and len(pairs) >= max_pairs:
            break
    return pairs


def masked_token_loss(logits, tgt, pad: int = PAD):
    """Mean cross-entropy of predicting token t+1 from the prefix ..t over
    the labels that are not ``pad`` (JAX:
    ``softmax_cross_entropy_with_integer_labels`` masked and averaged)."""
    labels = tgt[:, 1:]
    lg = logits[:, :-1]
    mask = labels != pad
    ll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                         labels.reshape(-1), reduction="none")
    return (ll * mask.reshape(-1)).sum() / mask.sum().clamp(min=1)


def fit(model: nn.Module, loss_fn, src: np.ndarray, tgt: np.ndarray,
        rng: np.random.Generator, *, steps: int, batch: int, lr: float,
        log_every: int, label: str) -> dict:
    """``steps`` AdamW steps of ``loss_fn(model, src_b, tgt_b)`` on batches
    drawn with ``rng.integers(0, n, size=batch)`` (JAX's order), with
    ``optax.adamw(lr)``'s defaults.  Returns ``{"losses": [...],
    "step_ms": mean device ms of a step after the first (CUDA events; None
    off the card)}``."""
    from druggen_tpu_torch.train.optim import AdamW

    device = next(model.parameters()).device
    opt = AdamW(model, lr, b1=0.9, b2=0.999, weight_decay=1e-4, eps=1e-8,
                guard=False)
    src_t = torch.as_tensor(src, dtype=torch.long)
    tgt_t = torch.as_tensor(tgt, dtype=torch.long)
    on_card = device.type == "cuda"
    if on_card:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses = []
    n = len(src)
    for step in range(steps):
        if on_card and step == 1:
            events[0].record()
        idx = torch.as_tensor(rng.integers(0, n, size=batch))
        src_b = src_t[idx].to(device, non_blocking=True)
        tgt_b = tgt_t[idx].to(device, non_blocking=True)
        loss = loss_fn(model, src_b, tgt_b)
        grads = torch.autograd.grad(loss, opt.params)
        opt.step(grads)
        losses.append(loss.detach())
        if log_every and step % log_every == 0:
            print(f"{label} step {step}: loss {float(loss.detach()):.4f}", flush=True)
    step_ms = None
    if on_card and steps > 1:
        events[1].record()
        events[1].synchronize()
        step_ms = events[0].elapsed_time(events[1]) / (steps - 1)
    return {"losses": torch.stack(losses).tolist() if losses else [],
            "step_ms": step_ms}


def train_corrector(smiles_list, *, steps: int = 500, batch: int = 32,
                    lr: float = 3e-4, hid: int = 256, heads: int = 8,
                    pf: int = 512, n_layers: int = 3, max_len: int = 202,
                    seed: int = 0, log_every: int = 100,
                    extra_pairs: list[tuple[str, str]] | None = None,
                    device: str | torch.device = "cuda",
                    init: dict | None = None) -> Seq2SeqCorrector:
    """Train on corruption pairs: synthetic token edits over
    ``smiles_list`` plus optional ``extra_pairs`` (e.g. real
    generator-failure pairs from :func:`generator_failure_pairs`).

    ``init``: a state_dict of :class:`Seq2Seq` to start from (e.g. the JAX
    package's initial weights through :mod:`..interop.corrector_weights`);
    by default the weights are drawn from ``seed``.  The loss of every step
    and the step's device ms are in the result's ``train_log``."""
    from druggen_tpu_torch.infer.engine import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pair_sources = list(extra_pairs or [])
    tokenizer = Tokenizer.build(
        smiles_list + [s for p in pair_sources for s in p])
    pairs = corruption_pairs(smiles_list, rng) + pair_sources
    src = np.stack([tokenizer.encode(c, max_len) for c, _ in pairs])
    tgt = np.stack([tokenizer.encode(g, max_len) for _, g in pairs])

    model = Seq2Seq(vocab_size=tokenizer.size, hid=hid, heads=heads, pf=pf,
                    n_layers=n_layers, max_len=max_len,
                    generator=torch.Generator().manual_seed(seed))
    if init is not None:
        model.load_state_dict(init)
    model.to(device)
    log = fit(model, lambda m, s, t: masked_token_loss(m(s, t), t), src, tgt,
              rng, steps=steps, batch=batch, lr=lr, log_every=log_every,
              label="corrector")
    corrector = Seq2SeqCorrector(model, tokenizer)
    corrector.train_log = log
    return corrector

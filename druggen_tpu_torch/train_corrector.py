"""Train the neural SMILES corrector on the card:
``python -m druggen_tpu_torch.train_corrector``.

Port of the JAX package's ``scripts/train_corrector.py``, with the same
flags (``--device``, default ``cuda``, in place of ``--platform``) and the
same files.  The reference ships pretrained corrector weights (PAPYRUS_200,
downloaded by setup.sh) and applies them to the raw SMILES the generator
writes at inference (reference inference.py:233, smiles_cor.py:1180-1215).
This tool trains the port's correctors on two pair sources:

- synthetic token-edit corruption pairs over a SMILES corpus, and
- **real generator-failure pairs** (``--gen-ckpt``): argmax outputs of an
  actual (e.g. early-epoch) generator, run in f32 on ``--device``, whose
  strict decode fails, written as invalid SMILES, with the valence-repaired
  decode as the target — the same failure distribution the corrector sees
  in production (``--pairs-file`` adds pairs mined beforehand by
  ``python -m druggen_tpu_torch.mine_corrector_pairs``).

A held-out slice of the failure pairs (``random.Random(13)``'s shuffle, as
in JAX) is used to report the corrected-fraction and exact-repair metrics
(written to ``<out>/eval.json``).  ``--arch native`` writes the JAX
``Seq2SeqCorrector`` layout in ``<out>``, ``--arch reference`` the
reference topology's ``params.msgpack`` + ``vocab.json`` in
``<out>/ref_arch``; either package loads both.  :func:`main` returns what
it trained, with each corrector's losses and step time (``train_log``).

Usage:
    python -m druggen_tpu_torch.train_corrector --smiles data/chembl_like_150k.smi \\
        --drug-smiles data/akt1_drugs_2607.smi \\
        --gen-ckpt experiments/r2_scale/models/1-500-G.ckpt \\
        --gen-samples 8192 --steps 4000 --arch both --out experiments/corrector
    # then: export DRUGGEN_CORRECTOR_CKPT=experiments/corrector
    #   or: export DRUGGEN_REFERENCE_CORRECTOR=experiments/corrector/ref_arch
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch
import torch.nn.functional as F


def generator_labels(G, a_labels, x_labels, vocab, device, bs: int = 256):
    """Argmax node and edge labels of ``G`` (f32, on ``device``) over real
    graphs (edge and node label arrays) in batches of ``bs``, the last
    partial batch dropped, as in JAX: ``(nodes, edges)``, one array each a
    batch."""
    nodes, edges = [], []
    with torch.inference_mode():
        for i in range(0, x_labels.shape[0] - bs + 1, bs):
            a = F.one_hot(torch.as_tensor(a_labels[i:i + bs]).long().to(device),
                          vocab.b_dim).float()
            x = F.one_hot(torch.as_tensor(x_labels[i:i + bs]).long().to(device),
                          vocab.m_dim).float()
            _, _, nl, el = G(a, x)
            nodes.append(nl.argmax(-1).int().cpu().numpy())
            edges.append(el.argmax(-1).int().cpu().numpy())
    return nodes, edges


def load_generator(path: str, vertexes: int, vocab, device, dim: int,
                   depth: int, heads: int, mlp_ratio: int):
    """The port's plain f32 Generator with the weights of ``path`` (a JAX-
    or port-written export, or a reference torch ``.ckpt``), on ``device``."""
    from druggen_tpu_torch.models import Generator
    from druggen_tpu_torch.train import checkpoint as ckpt

    G = Generator(act="relu", vertexes=vertexes, edges=vocab.b_dim,
                  nodes=vocab.m_dim, dropout=0.0, dim=dim, depth=depth,
                  heads=heads, mlp_ratio=mlp_ratio)
    G.load_state_dict(ckpt.load_params_auto(path))
    return G.to(device).eval()


def mine_failure_pairs(args, corpus):
    """Run the generator over real graphs, collect strict-decode failures."""
    from druggen_tpu_torch.chem.vocab import get_vocab
    from druggen_tpu_torch.data.dataset import featurize_smiles
    from druggen_tpu_torch.infer.engine import resolve_device
    from druggen_tpu_torch.infer.seq2seq import generator_failure_pairs

    device = resolve_device(args.device)
    # the vocab must match the generator checkpoint's training vocab —
    # build it from the same (raw, drug) file pair
    vocab = get_vocab(args.smiles, args.drug_smiles or args.smiles,
                      args.max_atom,
                      cache_dir=os.path.join(os.path.dirname(args.smiles)
                                             or ".", "vocab"))
    n_in = min(args.gen_samples, len(corpus))
    data = featurize_smiles(corpus[:n_in], vocab, args.max_atom)
    G = load_generator(args.gen_ckpt, data.x.shape[1], vocab, device,
                       args.gen_dim, args.gen_depth, args.gen_heads,
                       args.gen_mlp_ratio)
    nodes, edges = generator_labels(G, data.a, data.x, vocab, device)
    nodes = np.concatenate(nodes) if nodes else np.zeros((0, 1))
    edges = np.concatenate(edges) if edges else np.zeros((0, 1, 1))
    pairs = generator_failure_pairs(nodes, edges, vocab)
    print(f"mined {len(pairs)} failure pairs from {len(nodes)} generator "
          f"samples ({len(pairs) / max(len(nodes), 1):.1%} failed strict "
          f"decode with a repairable target)")
    return pairs


def evaluate_corrector(corrector, holdout_pairs):
    """Corrected-fraction, exact-repair rate, and repair FIDELITY — mean
    Tanimoto between each valid corrected molecule and its graph-repair
    target (the corrector's actual job in the reference pipeline,
    smiles_cor.py:1219-1283, is to recover the intended molecule, not just
    *a* valid one)."""
    import numpy as np

    from druggen_tpu_torch.chem.canon import canonical_smiles
    from druggen_tpu_torch.chem.fingerprints import morgan_fingerprint
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    srcs = [s for s, _ in holdout_pairs]
    tgts = [t for _, t in holdout_pairs]
    outs = corrector.translate_batch(srcs)
    n = len(srcs)
    src_valid = sum(1 for s in srcs if canonical_smiles(s) is not None)
    corrected = sum(1 for o in outs if o and canonical_smiles(o) is not None)
    exact = sum(1 for o, t in zip(outs, tgts)
                if o and canonical_smiles(o) == canonical_smiles(t))
    sims = []
    for o, t in zip(outs, tgts):
        mo = mol_from_smiles(o) if o else None
        mt = mol_from_smiles(t)
        if mo is None or mt is None:
            continue
        fo = morgan_fingerprint(mo).astype(np.float32)
        ft = morgan_fingerprint(mt).astype(np.float32)
        inter = float(fo @ ft)
        union = float(fo.sum() + ft.sum()) - inter
        sims.append(inter / union if union else 0.0)
    return {
        "n_holdout": n,
        "validity_before": src_valid / n if n else 0.0,
        "validity_after": corrected / n if n else 0.0,
        "exact_repair_rate": exact / n if n else 0.0,
        "mean_tanimoto_to_target": (sum(sims) / len(sims)) if sims else 0.0,
        "n_similarity_pairs": len(sims),
    }


def train_reference_corrector(corpus, pairs, *, steps, batch, lr, hid,
                              n_layers, max_len, out_dir, seed=0,
                              device="cuda"):
    """Train the reference-exact topology (infer/seq2seq_ref.py) from
    scratch on the same pair data — so the weight-compatible interop model
    is also a performing model.

    Follows the reference training conventions: torchtext specials order
    (UNK,PAD,SOS,EOS), REVERSED target token sequences
    (smiles_cor.py:959-965), separate src/trg embeddings.  The weights start
    from ``init_params(seed)``, the JAX package's bit for bit, and the files
    are the JAX tool's: ``params.msgpack`` (flax's layout of the params
    pytree) and ``vocab.json``."""
    from druggen_tpu_torch.infer.seq2seq import corruption_pairs, fit, masked_token_loss, tokenize
    from druggen_tpu_torch.infer.seq2seq_ref import EOS, PAD, SOS, UNK, init_params
    from druggen_tpu_torch.interop.corrector_ckpt import (
        ReferenceCorrector,
        convert_corrector_state_dict,
        params_to_state_dict_file_layout,
    )
    from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_serialize

    rng = np.random.default_rng(seed)
    all_pairs = corruption_pairs(corpus, rng) + list(pairs)
    # torchtext-order vocab over both sides
    toks = sorted({t for s, g in all_pairs
                   for t in tokenize(s) + tokenize(g)})
    itos = ["<unk>", "<pad>", "<sos>", "<eos>"] + toks
    stoi = {t: i for i, t in enumerate(itos)}
    L = max_len + 2

    def enc(smi, reverse):
        ts = tokenize(smi)[:max_len]
        if reverse:
            ts = ts[::-1]
        ids = [SOS] + [stoi.get(t, UNK) for t in ts] + [EOS]
        row = np.full(L, PAD, np.int32)
        row[:len(ids)] = ids
        return row

    src = np.stack([enc(s, False) for s, _ in all_pairs])
    trg = np.stack([enc(g, True) for _, g in all_pairs])

    params = init_params(seed, len(itos), len(itos), hid=hid,
                         n_layers=n_layers, max_len=max_len)
    ref = ReferenceCorrector(params, stoi, itos, max_len=max_len, device=device)
    log = fit(ref.model, lambda m, s, t: masked_token_loss(m(s, t), t, PAD),
              src, trg, rng, steps=steps, batch=batch, lr=lr, log_every=100,
              label="ref-corrector")
    ref.train_log = log

    os.makedirs(out_dir, exist_ok=True)
    params = convert_corrector_state_dict(ref.model.state_dict())
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(params_to_state_dict_file_layout(params)))
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump({"itos": itos, "hid": hid, "n_layers": n_layers,
                   "max_len": max_len}, f)
    print(f"reference-topology corrector saved to {out_dir}")
    return ref


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smiles", help=".smi corpus (default: built-in)")
    p.add_argument("--out", default="experiments/corrector")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--max-len", type=int, default=202)
    p.add_argument("--hid", type=int, default=256)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the generator and the correctors "
                        "(cuda unless cpu is asked for)")
    p.add_argument("--corpus-limit", type=int, default=20000,
                   help="cap on synthetic-pair corpus size")
    # real generator-failure mining
    p.add_argument("--gen-ckpt", default=None,
                   help="path to a generator .ckpt; mines real failure "
                        "pairs from its argmax outputs")
    p.add_argument("--pairs-file", default=None,
                   help="JSON of pre-mined failure pairs "
                        "(mine_corrector_pairs output) — the "
                        "multi-checkpoint, >=10k-pair path; combinable "
                        "with --gen-ckpt")
    p.add_argument("--drug-smiles", default=None,
                   help="drug .smi used when training the generator (the "
                        "vocab is the union of both files)")
    p.add_argument("--gen-samples", type=int, default=8192)
    p.add_argument("--gen-dim", type=int, default=128)
    p.add_argument("--gen-depth", type=int, default=1)
    p.add_argument("--gen-heads", type=int, default=8)
    p.add_argument("--gen-mlp-ratio", type=int, default=3)
    p.add_argument("--max-atom", type=int, default=45)
    p.add_argument("--holdout-frac", type=float, default=0.1)
    p.add_argument("--arch", choices=("native", "reference", "both"),
                   default="native",
                   help="corrector topology to train: the pre-LN native "
                        "redesign, the reference-exact (PAPYRUS_200 weight-"
                        "compatible) topology, or both")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"pairs": n mined or loaded, "holdout": [...], "native":
    Seq2SeqCorrector or None, "reference": ReferenceCorrector or None,
    "metrics": {"native": ..., "reference": ...}}``."""
    args = parse_args(argv)

    if args.smiles:
        from druggen_tpu_torch.chem.vocab import read_smiles_file

        corpus = read_smiles_file(args.smiles)[:args.corpus_limit]
    else:
        from druggen_tpu_torch.data.corpus import (
            DRUGLIKE_SMILES,
            TARGET_SMILES,
            generate_corpus,
        )

        corpus = DRUGLIKE_SMILES + TARGET_SMILES + generate_corpus(400)

    extra_pairs, holdout = [], []
    pairs = []
    if args.pairs_file:
        with open(args.pairs_file) as f:
            d = json.load(f)
        pairs += [tuple(x) for x in (d["pairs"] if isinstance(d, dict)
                                     else d)]
        print(f"loaded {len(pairs)} pre-mined pairs from "
              f"{args.pairs_file}")
    if args.gen_ckpt:
        pairs += mine_failure_pairs(args, corpus)
    if pairs:
        # deterministic shuffle so the holdout spans all source
        # checkpoints, not just the first-mined ones
        random.Random(13).shuffle(pairs)
        n_hold = max(1, int(len(pairs) * args.holdout_frac))
        holdout, extra_pairs = pairs[:n_hold], pairs[n_hold:]

    result = {"pairs": len(pairs), "holdout": holdout, "native": None,
              "reference": None, "metrics": {}}
    if args.arch in ("native", "both"):
        from druggen_tpu_torch.infer.seq2seq import train_corrector

        corrector = train_corrector(corpus, steps=args.steps,
                                    batch=args.batch,
                                    lr=args.lr, hid=args.hid,
                                    n_layers=args.layers,
                                    max_len=args.max_len,
                                    extra_pairs=extra_pairs,
                                    device=args.device)
        corrector.save(args.out)
        print(f"corrector saved to {args.out}")
        result["native"] = corrector
        if holdout:
            metrics = evaluate_corrector(corrector, holdout)
            print("held-out garbage-set evaluation:", metrics)
            with open(os.path.join(args.out, "eval.json"), "w") as f:
                json.dump(metrics, f, indent=1)
            result["metrics"]["native"] = metrics

    if args.arch in ("reference", "both"):
        ref_out = os.path.join(args.out, "ref_arch")
        ref = train_reference_corrector(
            corpus, extra_pairs, steps=args.steps, batch=args.batch,
            lr=args.lr, hid=args.hid, n_layers=args.layers,
            max_len=args.max_len, out_dir=ref_out, device=args.device)
        result["reference"] = ref
        if holdout:
            metrics = evaluate_corrector(ref, holdout)
            print("reference-topology held-out evaluation:", metrics)
            with open(os.path.join(ref_out, "eval.json"), "w") as f:
                json.dump(metrics, f, indent=1)
            result["metrics"]["reference"] = metrics

    if holdout:
        with open(os.path.join(args.out, "holdout_pairs.json"), "w") as f:
            json.dump(holdout, f)
    print("enable with: export DRUGGEN_CORRECTOR_CKPT=" + args.out)
    return result


if __name__ == "__main__":
    main()

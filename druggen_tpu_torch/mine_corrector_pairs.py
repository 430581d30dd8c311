"""Mine real generator-failure pairs from MANY checkpoints of a run:
``python -m druggen_tpu_torch.mine_corrector_pairs``.

Port of the JAX package's ``scripts/mine_corrector_pairs.py``, with the
same flags (``--device``, default ``cuda``, in place of ``--platform``) and
the same JSON file.  It walks every ``{epoch}-{iter}-G.ckpt`` in a model
dir, runs each generator (the port's plain f32 Generator, one model on the
device whose weights are swapped per checkpoint) over a fresh slice of real
graphs, collects argmax outputs that FAIL strict decode but have a valid
bond-removal repair target (the pair definition of
:func:`..infer.seq2seq.generator_failure_pairs` — the reference corrector's
training signal, smiles_cor.py:1180-1283), dedupes by source string, and
writes one JSON file for ``python -m druggen_tpu_torch.train_corrector
--pairs-file``.  Different checkpoints fail differently (early epochs:
systematic valence errors; late epochs: the hard residual tail), so the
union is both bigger and more diverse than any single-checkpoint mine.

    python -m druggen_tpu_torch.mine_corrector_pairs \\
        --model_dir experiments/r4_scale/models/... \\
        --smiles data/chembl_frag_1m6.smi --drug_smiles data/akt1_drugs_2607.smi \\
        --samples_per_ckpt 4096 --out experiments/corrector_r5/pairs.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--smiles", required=True, help="real-graph corpus")
    p.add_argument("--drug_smiles", default=None)
    p.add_argument("--samples_per_ckpt", type=int, default=4096)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--max_atom", type=int, default=45)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--mlp_ratio", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the generator (cuda unless cpu is "
                        "asked for)")
    p.add_argument("--every", type=int, default=1,
                   help="use every Nth checkpoint")
    p.add_argument("--max_ckpts", type=int, default=0, help="0 = all")
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the written JSON object."""
    args = parse_args(argv)

    from druggen_tpu_torch.chem.vocab import get_vocab, read_smiles_file
    from druggen_tpu_torch.data.dataset import featurize_smiles
    from druggen_tpu_torch.infer.engine import resolve_device
    from druggen_tpu_torch.infer.seq2seq import generator_failure_pairs
    from druggen_tpu_torch.models import Generator
    from druggen_tpu_torch.train import checkpoint as ckpt
    from druggen_tpu_torch.train_corrector import generator_labels

    device = resolve_device(args.device)
    ckpts = sorted(
        glob.glob(os.path.join(args.model_dir, "*-G.ckpt")),
        key=lambda s: [int(x) for x in
                       re.findall(r"(\d+)-(\d+)-G\.ckpt$", s)[0]]
        if re.search(r"\d+-\d+-G\.ckpt$", s) else [10 ** 9, 0])
    ckpts = [c for c in ckpts if re.search(r"\d+-\d+-G\.ckpt$", c)]
    ckpts = ckpts[::max(args.every, 1)]
    if args.max_ckpts:
        ckpts = ckpts[:args.max_ckpts]
    if not ckpts:
        sys.exit(f"no cadence checkpoints in {args.model_dir}")
    print(f"mining {len(ckpts)} checkpoints from {args.model_dir}",
          flush=True)

    vocab = get_vocab(args.smiles, args.drug_smiles or args.smiles,
                      args.max_atom,
                      cache_dir=os.path.join(
                          os.path.dirname(args.smiles) or ".", "vocab"))
    corpus = read_smiles_file(args.smiles)
    # a fresh slice of real graphs per checkpoint: more input diversity
    need = args.samples_per_ckpt * len(ckpts)
    data = featurize_smiles(corpus[:min(need, len(corpus))], vocab,
                            args.max_atom)
    n_graphs = data.x.shape[0]
    vertexes = int(data.x.shape[1])
    print(f"{n_graphs} real graphs featurized", flush=True)

    G = Generator(act="relu", vertexes=vertexes, edges=vocab.b_dim,
                  nodes=vocab.m_dim, dropout=0.0, dim=args.dim,
                  depth=args.depth, heads=args.heads,
                  mlp_ratio=args.mlp_ratio).to(device).eval()

    seen: set[str] = set()
    pairs: list[tuple[str, str]] = []
    per_ckpt = []
    t0 = time.time()
    off = 0
    for idx, path in enumerate(ckpts):
        G.load_state_dict(ckpt.load_params_auto(path))
        take = min(args.samples_per_ckpt, n_graphs)
        # each batch a contiguous slice from a rolling offset, as in JAX
        rows = np.concatenate(
            [np.arange(args.batch) + (off + i) % max(n_graphs - args.batch, 1)
             for i in range(0, take - args.batch + 1, args.batch)])
        nodes, edges = generator_labels(G, data.a[rows], data.x[rows], vocab, device,
                                        args.batch)
        off = (off + take) % max(n_graphs - args.batch, 1)
        nodes = np.concatenate(nodes)
        edges = np.concatenate(edges)
        found = generator_failure_pairs(nodes, edges, vocab)
        fresh = 0
        for s, t in found:
            if s not in seen:
                seen.add(s)
                pairs.append((s, t))
                fresh += 1
        name = os.path.basename(path)
        per_ckpt.append({"ckpt": name, "samples": int(len(nodes)),
                         "failures": len(found), "fresh": fresh})
        print(f"[{idx + 1}/{len(ckpts)}] {name}: {len(found)} failures, "
              f"{fresh} new (total {len(pairs)}) "
              f"[{time.time() - t0:.0f}s]", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = {"pairs": pairs, "per_ckpt": per_ckpt, "model_dir": args.model_dir,
           "samples_per_ckpt": args.samples_per_ckpt}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}: {len(pairs)} unique pairs from "
          f"{len(ckpts)} checkpoints in {time.time() - t0:.0f}s")
    return out


if __name__ == "__main__":
    main()

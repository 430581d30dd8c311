"""Metric-gated checkpoint selection for a finished training run:
``python -m druggen_tpu_torch.select_checkpoint``.

Port of the JAX package's ``scripts/select_checkpoint.py``, with the same
flags (``--device``, default ``cuda``, in place of ``--platform``), the same
screen and finalist phase and the same ``selection.json``.

The reference ships *selected* checkpoints rather than the last one (its
released ``{submodel}-G.ckpt`` artifacts are chosen from training-time
sampling quality, not final step — cf. reference train.py:259-263 cadence
exports).  This tool scores every ``{epoch}-{iter}-G.ckpt`` in a run's model
dir by sampling a FIXED number of generator batches (no loop-until-valid, so
low-validity checkpoints cost the same as good ones) and reports validity,
uniqueness, novelty-vs-corpus, IntDiv/QED/SA, and a combined score.

The screen is quality-aware: every checkpoint gets the quality-extended
score (validity x uniqueness x novelty x IntDiv/QED/SA terms anchored to
the ``--target_*`` released-set statistics); ``--no_quality_screen``
screens on validity x uniqueness x novelty alone.  ``--finalists K``
rescores the top K at ``--finalist_samples``.

One :class:`..infer.engine.InferenceEngine` is built, from the first
checkpoint (no ``{submodel}-G.ckpt`` is needed in the directory), and
serves every other checkpoint through :meth:`load_generator`; with the
shuffle seed 42 and ``max_batches`` it draws the JAX tool's batches.  The
IntDiv products run on ``--device``.  :func:`main` returns the selection
and, per checkpoint and phase, the host seconds of the forwards (device
windows), the decode, and the quality terms, and the forwards' count.

Usage:
    python -m druggen_tpu_torch.select_checkpoint \\
        --model_dir experiments/.../models/DrugGEN \\
        --inf_smiles data/chembl_frag_300k.smi \\
        --train_smiles data/chembl_frag_300k.smi \\
        --train_drug_smiles data/akt1_drugs_2607.smi \\
        --sample_num 2048 --output selection.json
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys
import time

import numpy as np

from druggen_tpu_torch.chem.descriptors import qed as qed_fn
from druggen_tpu_torch.chem.descriptors import sa_score
from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.chem.vocab import read_smiles_file
from druggen_tpu_torch.config import InferenceConfig
from druggen_tpu_torch.infer.engine import InferenceEngine
from druggen_tpu_torch.metrics.molecular import internal_diversity
from druggen_tpu_torch.train import checkpoint as ckpt


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--inf_smiles", required=True)
    p.add_argument("--train_smiles", required=True)
    p.add_argument("--train_drug_smiles", required=True)
    p.add_argument("--sample_num", type=int, default=2048)
    p.add_argument("--inf_batch_size", type=int, default=256)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--mlp_ratio", type=int, default=3)
    p.add_argument("--max_atom", type=int, default=45)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--fused_mlp", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the Generator and the IntDiv "
                        "products")
    p.add_argument("--output", default="selection.json")
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--finalists", type=int, default=0,
                   help="rescore the top-K screen checkpoints with the "
                        "quality terms (0 disables)")
    p.add_argument("--finalist_samples", type=int, default=8192)
    p.add_argument("--prop_samples", type=int, default=2048,
                   help="QED/SA are averaged over this many of the "
                        "finalist's unique valid molecules (descriptor "
                        "cost cap)")
    p.add_argument("--target_intdiv", type=float, default=0.876,
                   help="released AKT1 set IntDiv under this evaluator")
    p.add_argument("--target_qed", type=float, default=0.518)
    p.add_argument("--target_sa", type=float, default=1.94)
    p.add_argument("--no_quality_screen", dest="quality_screen",
                   action="store_false", default=True,
                   help="screen on validity*uniqueness*novelty only")
    p.add_argument("--screen_prop_samples", type=int, default=256,
                   help="QED/SA sample size per checkpoint during the "
                        "quality-aware screen (IntDiv uses up to 4096 fps)")
    return p.parse_args(argv)


def cadence_checkpoints(model_dir: str) -> list[str]:
    """The ``{epoch}-{iter}-G.ckpt`` files of ``model_dir`` by (epoch, iter)."""
    ckpts = [c for c in glob.glob(os.path.join(model_dir, "*-G.ckpt"))
             if re.search(r"\d+-\d+-G\.ckpt$", c)]
    return sorted(ckpts, key=lambda s: [
        int(x) for x in re.findall(r"(\d+)-(\d+)-G\.ckpt$", s)[0]])


def main(argv=None):
    """Returns ``(selection, seconds)``: the dict written to ``--output`` and
    a list of ``{ckpt, phase, forwards, forward_s, decode_s, quality_s}``."""
    args = parse_args(argv)
    ckpts = cadence_checkpoints(args.model_dir)
    if not ckpts:
        sys.exit(f"no cadence checkpoints ({{epoch}}-{{iter}}-G.ckpt) "
                 f"in {args.model_dir}")
    print(f"{len(ckpts)} cadence checkpoints in {args.model_dir}",
          flush=True)

    cfg = InferenceConfig(
        inference_model=args.model_dir, sample_num=args.sample_num,
        inf_smiles=args.inf_smiles, train_smiles=args.train_smiles,
        train_drug_smiles=args.train_drug_smiles,
        inf_batch_size=args.inf_batch_size, dim=args.dim, depth=args.depth,
        heads=args.heads, mlp_ratio=args.mlp_ratio, max_atom=args.max_atom,
        compute_dtype=args.compute_dtype, fused_mlp=args.fused_mlp,
        set_seed=True, seed=42, device=args.device)
    eng = InferenceEngine(cfg, g_state_dict=ckpt.load_params_auto(ckpts[0]))
    train_set = set(read_smiles_file(args.train_smiles))

    def quality_terms(uniq: list, prop_samples: int) -> dict:
        """IntDiv/QED/SA + score terms anchored to the released-set
        statistics: IntDiv ramps linearly to the target, QED is a
        Gaussian around it, SA penalizes only the harder-than-target
        side."""
        fps = fingerprints_for_smiles(uniq[:4096]).astype(np.float32)
        intdiv = (internal_diversity(fps, device=eng.device)[0]
                  if len(fps) > 1 else 0.0)
        qeds, sas = [], []
        for s in uniq[:prop_samples]:
            m = mol_from_smiles(s)
            if m is None:
                continue
            qeds.append(qed_fn(m))
            sas.append(sa_score(m))
        qed_m = float(np.mean(qeds)) if qeds else 0.0
        sa_m = float(np.mean(sas)) if sas else 10.0
        intdiv_term = min(intdiv / args.target_intdiv, 1.0)
        qed_term = math.exp(-((qed_m - args.target_qed) / 0.08) ** 2)
        sa_term = math.exp(-max(0.0, sa_m - args.target_sa) / 1.0)
        return {"intdiv": intdiv, "qed": qed_m, "sa": sa_m,
                "n_prop_samples": len(qeds),
                "term": intdiv_term * qed_term * sa_term}

    seconds: list[dict] = []

    def sample(path: str, phase: str, sample_num: int):
        """Serve ``path``'s weights for ``ceil(sample_num / batch)`` batches;
        opens this checkpoint's entry of ``seconds``."""
        eng.load_generator(ckpt.load_params_auto(path))
        eng.timings = []
        kept, decoded, _, _ = eng.sample(
            sample_num=sample_num,
            max_batches=max(1, -(-sample_num // args.inf_batch_size)))
        seconds.append({
            "ckpt": os.path.basename(path), "phase": phase,
            "forwards": len(eng.timings),
            "forward_s": sum(t["forward_s"] for t in eng.timings),
            "decode_s": sum(t["decode_s"] for t in eng.timings),
            "quality_s": 0.0})
        return kept, decoded

    def timed_quality(uniq: list, prop_samples: int) -> dict:
        t0 = time.perf_counter()
        qt = quality_terms(uniq, prop_samples)
        seconds[-1]["quality_s"] = time.perf_counter() - t0
        return qt

    rows = []
    for path in ckpts:
        kept, decoded = sample(path, "screen", args.sample_num)
        attempts = len(decoded)
        validity = len(kept) / max(attempts, 1)
        uniq_set = set(kept)
        uniqueness = len(uniq_set) / max(len(kept), 1)
        novel = sum(1 for s in uniq_set if s not in train_set)
        novelty = novel / max(len(uniq_set), 1)
        score = validity * uniqueness * novelty
        name = os.path.basename(path)
        row = {"ckpt": name, "validity": round(validity, 4),
               "uniqueness": round(uniqueness, 4),
               "novelty": round(novelty, 4),
               "n_valid": len(kept), "n_unique": len(uniq_set),
               "vun_score": round(score, 4)}
        if args.quality_screen and uniq_set:
            qt = timed_quality(list(dict.fromkeys(kept)),
                               args.screen_prop_samples)
            score *= qt["term"]
            row.update({"intdiv": round(qt["intdiv"], 4),
                        "qed": round(qt["qed"], 4),
                        "sa": round(qt["sa"], 4)})
        row["score"] = round(score, 4)
        rows.append(row)
        extra = (f" IntDiv {row.get('intdiv', '-')} QED "
                 f"{row.get('qed', '-')} SA {row.get('sa', '-')}"
                 if args.quality_screen else "")
        print(f"{name}: validity {validity:.3f} uniqueness "
              f"{uniqueness:.3f} novelty {novelty:.3f}{extra} "
              f"score {score:.4f}", flush=True)

    ranked = sorted(rows, key=lambda r: -r["score"])
    out = {"model_dir": args.model_dir, "sample_num": args.sample_num,
           "rows": rows, "ranked": ranked[:args.top]}

    if args.finalists > 0:
        by_name = {os.path.basename(p): p for p in ckpts}
        fin_rows = []
        for r in ranked[:args.finalists]:
            kept, decoded = sample(by_name[r["ckpt"]], "finalist",
                                   args.finalist_samples)
            validity = len(kept) / max(len(decoded), 1)
            uniq = list(dict.fromkeys(kept))
            uniqueness = len(uniq) / max(len(kept), 1)
            novelty = (sum(1 for s in uniq if s not in train_set)
                       / max(len(uniq), 1))
            qt = timed_quality(uniq, args.prop_samples)
            fscore = validity * uniqueness * novelty * qt["term"]
            row = {"ckpt": r["ckpt"], "validity": round(validity, 4),
                   "uniqueness": round(uniqueness, 4),
                   "novelty": round(novelty, 4),
                   "intdiv": round(qt["intdiv"], 4),
                   "qed": round(qt["qed"], 4),
                   "sa": round(qt["sa"], 4),
                   "n_prop_samples": qt["n_prop_samples"],
                   "final_score": round(fscore, 4)}
            fin_rows.append(row)
            print(f"finalist {r['ckpt']}: v {validity:.3f} u "
                  f"{uniqueness:.3f} n {novelty:.3f} "
                  f"IntDiv {qt['intdiv']:.3f} QED {qt['qed']:.3f} "
                  f"SA {qt['sa']:.2f} -> {fscore:.4f}", flush=True)
        fin_rows.sort(key=lambda r: -r["final_score"])
        out["finalist_samples"] = args.finalist_samples
        out["quality_targets"] = {"intdiv": args.target_intdiv,
                                  "qed": args.target_qed,
                                  "sa": args.target_sa}
        out["finalists"] = fin_rows

    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    print("\ntop checkpoints:")
    for r in ranked[:args.top]:
        print(f"  {r['ckpt']}: score {r['score']} "
              f"(v {r['validity']} u {r['uniqueness']} n {r['novelty']})")
    if args.finalists > 0 and out.get("finalists"):
        print("finalist ranking (quality-extended score):")
        for r in out["finalists"]:
            print(f"  {r['ckpt']}: {r['final_score']} (IntDiv {r['intdiv']} "
                  f"QED {r['qed']} SA {r['sa']})")
    print(f"written {args.output}")
    return out, seconds


if __name__ == "__main__":
    main()

"""Offline molecule-set evaluator CLI of the port:
``python -m druggen_tpu_torch.evaluate``.

Port of the JAX package's ``evaluate.py``, the analogue of the reference
``results/evaluate.py`` (CLI at evaluate.py:236-261): validity/uniqueness/
novelty/IntDiv, QED/SA, Fréchet distance, Frag/Scaf similarity,
Lipinski/Veber/PAINS pass-rates — the same JSON and CSV (the same keys in
the same order, rounded to 3 places).  The same flags, with ``--device``
(default ``cuda``) in place of ``--platform``: ChemNet (with
``--chemnet-weights`` or ``$DRUGGEN_CHEMNET_WEIGHTS``) and the IntDiv
products run there.  The per-molecule loops fork ``--n-jobs`` pure-Python
workers, which never touch the card.  ``MoleculeEvaluator.seconds`` holds
the host seconds of each part of the last ``evaluate_all()``.

Example:
    python -m druggen_tpu_torch.evaluate --gen generated.csv \\
        --ref1 chembl_train.smi --ref2 akt_train.smi --output results
"""

from __future__ import annotations

import argparse
import csv
import json
import re
import time

import numpy as np
import torch

from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.chem.vocab import read_smiles_file
from druggen_tpu_torch.infer.engine import resolve_device
from druggen_tpu_torch.metrics import (
    fraction_unique,
    fraction_valid,
    internal_diversity,
    novelty,
)
from druggen_tpu_torch.metrics.fcd import FCD
from druggen_tpu_torch.metrics.frag_scaf import frag_similarity, scaf_similarity


class MoleculeEvaluator:
    """Reference MoleculeEvaluator (results/evaluate.py:19-142); n_jobs
    parallelizes the per-molecule descriptor loops with a process pool
    (reference mapper(n_jobs), utils.py:423-449)."""

    def __init__(self, gen_smiles, ref_smiles_1, ref_smiles_2=None,
                 n_jobs: int = 1, chemnet_weights: str | None = None,
                 device: str | torch.device = "cuda"):
        from druggen_tpu_torch.metrics import parallel_map as pm

        self.pm = pm
        self.n_jobs = n_jobs
        self.device = resolve_device(device)
        self.seconds: dict[str, float] = {}
        self.gen_smiles = gen_smiles
        self.ref_smiles_1 = ref_smiles_1
        self.ref_smiles_2 = ref_smiles_2
        canon = pm.mapper(n_jobs)(pm.canonical_of, gen_smiles)
        self.gen_valid = [s for s, c in zip(gen_smiles, canon)
                          if c is not None]
        self.gen_mols = [mol_from_smiles(s) for s in self.gen_valid]
        # literal FCD when ChemNet weights are supplied (flag or
        # $DRUGGEN_CHEMNET_WEIGHTS); documented surrogate otherwise
        featurizer = None
        if chemnet_weights:
            from druggen_tpu_torch.metrics.chemnet import ChemNet
            featurizer = ChemNet.load(chemnet_weights, device)
        else:
            from druggen_tpu_torch.metrics.chemnet import chemnet_from_env
            featurizer = chemnet_from_env(device)
        self.fcd = FCD(featurizer=featurizer)
        self.fcd_is_literal = featurizer is not None

    def basic(self):
        fps = fingerprints_for_smiles(self.gen_valid)
        idiv, idiv_std = (internal_diversity(fps, device=self.device)
                          if len(fps) else (0.0, 0.0))
        out = {
            "validity": fraction_valid(self.gen_smiles),
            "uniqueness": fraction_unique(self.gen_smiles),
            "novelty_ref1": novelty(self.gen_smiles, self.ref_smiles_1),
            "internal_diversity": idiv,
            "internal_diversity_std": idiv_std,
        }
        if self.ref_smiles_2:
            out["novelty_ref2"] = novelty(self.gen_smiles, self.ref_smiles_2)
        return out

    def properties(self):
        mp = self.pm.mapper(self.n_jobs)
        qeds = [v for v in mp(self.pm.qed_of, self.gen_valid)
                if v is not None]
        sas = [v for v in mp(self.pm.sa_of, self.gen_valid) if v is not None]
        return {
            "qed_mean": float(np.mean(qeds)) if qeds else 0.0,
            "qed_std": float(np.std(qeds)) if qeds else 0.0,
            "sa_mean": float(np.mean(sas)) if sas else 0.0,
            "sa_std": float(np.std(sas)) if sas else 0.0,
        }

    def frechet(self):
        out = {"fcd_ref1": self.fcd(self.gen_valid, self.ref_smiles_1)}
        if self.ref_smiles_2:
            out["fcd_ref2"] = self.fcd(self.gen_valid, self.ref_smiles_2)
        return out

    def similarity(self):
        out = {
            "frag_sim_ref1": frag_similarity(self.gen_valid, self.ref_smiles_1),
            "scaf_sim_ref1": scaf_similarity(self.gen_valid, self.ref_smiles_1),
        }
        if self.ref_smiles_2:
            out["frag_sim_ref2"] = frag_similarity(self.gen_valid,
                                                   self.ref_smiles_2)
            out["scaf_sim_ref2"] = scaf_similarity(self.gen_valid,
                                                   self.ref_smiles_2)
        return out

    def drug_likeness(self):
        mp = self.pm.mapper(self.n_jobs)
        lip = [v for v in mp(self.pm.lipinski_of, self.gen_valid)
               if v is not None]
        veb = [v for v in mp(self.pm.veber_of, self.gen_valid)
               if v is not None]
        pains = [v for v in mp(self.pm.pains_pass_of, self.gen_valid)
                 if v is not None]
        return {
            "lipinski_mean": float(np.mean(lip)) if lip else 0.0,
            "lipinski_std": float(np.std(lip)) if lip else 0.0,
            "veber_mean": float(np.mean(veb)) if veb else 0.0,
            "veber_std": float(np.std(veb)) if veb else 0.0,
            "pains_pass_rate": float(np.mean(pains)) if pains else 0.0,
        }

    def evaluate_all(self):
        results = {}
        self.seconds = {}
        for name, fn in (("basic", self.basic),
                         ("property", self.properties),
                         ("frechet", self.frechet),
                         ("similarity", self.similarity),
                         ("drug-likeness", self.drug_likeness)):
            print(f"Calculating {name} metrics...")
            t0 = time.perf_counter()
            part = fn()
            self.seconds[name] = time.perf_counter() - t0
            print({k: round(v, 3) if isinstance(v, float) else v
                   for k, v in part.items()})
            results.update(part)
        return results


def read_gen_csv(path: str, smiles_col: str = "SMILES") -> list[str]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames and smiles_col in reader.fieldnames:
            return [row[smiles_col] for row in reader if row.get(smiles_col)]
    # fall back to raw .smi-style content
    return read_smiles_file(path)


def evaluate_molecules_from_files(gen_path, ref_path_1, ref_path_2=None,
                                  smiles_col="SMILES",
                                  output_prefix="results", n_jobs: int = 8,
                                  chemnet_weights: str | None = None,
                                  ref1_sample: int = 0,
                                  ref1_sample_seed: int = 0,
                                  device: str | torch.device = "cuda"):
    gen = read_gen_csv(gen_path, smiles_col)
    ref1 = read_smiles_file(ref_path_1)
    ref2 = read_smiles_file(ref_path_2) if ref_path_2 else None
    if not gen:
        raise ValueError("No SMILES found in generated set")
    if not ref1:
        raise ValueError("No SMILES found in reference set 1")
    ref1_file_size = len(ref1)
    if ref1_sample and ref1_sample < len(ref1):
        # documented subsample for very large training-corpus references
        # (the novelty term still uses the FULL ref1 set — set membership
        # is cheap; only the kernel metrics use the sample)
        rng = np.random.default_rng(ref1_sample_seed)
        idx = rng.choice(len(ref1), size=ref1_sample, replace=False)
        ref1_sampled = [ref1[i] for i in idx]
        print(f"Ref1 sampled {ref1_sample} of {ref1_file_size} "
              f"(seed {ref1_sample_seed}) for kernel metrics")
    else:
        ref1_sampled = ref1
    print(f"Generated: {len(gen)}  Ref1: {len(ref1_sampled)}"
          + (f"  Ref2: {len(ref2)}" if ref2 else ""))
    ev = MoleculeEvaluator(gen, ref1_sampled, ref2, n_jobs=n_jobs,
                           chemnet_weights=chemnet_weights, device=device)
    results = ev.evaluate_all()
    if ref1_sample and ref1_sample < ref1_file_size:
        # recompute novelty against the FULL reference file; the ref-side
        # canonical set is parallelized + disk-cached (corpus-scale ref
        # canonicalization dominated wall time otherwise)
        from druggen_tpu_torch.metrics.molecular import canonical_set

        results["novelty_ref1"] = novelty(
            gen, ref1, train_canon=canonical_set(ref1, n_jobs=n_jobs,
                                                 cache_for=ref_path_1))
    results["fcd_is_literal"] = ev.fcd_is_literal
    results.update({
        "n_generated": len(gen),
        "n_reference_1": ref1_file_size,
        "n_reference_1_kernel_sample": len(ref1_sampled),
        "ref1_sample_seed": ref1_sample_seed if ref1_sample else None,
        "n_reference_2": len(ref2) if ref2 else 0,
    })
    formatted = {k: round(v, 3) if isinstance(v, float) else v
                 for k, v in results.items()}
    with open(f"{output_prefix}.json", "w") as f:
        json.dump(formatted, f, indent=4)
    with open(f"{output_prefix}.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(formatted.keys()))
        w.writeheader()
        w.writerow(formatted)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate generated molecules against reference sets")
    parser.add_argument("--gen", required=True)
    parser.add_argument("--ref1", required=True)
    parser.add_argument("--ref2")
    parser.add_argument("--smiles-col", default="SMILES")
    parser.add_argument("--output", default="results",
                        help="output prefix; a trailing .json/.csv is "
                             "stripped")
    parser.add_argument("--n-jobs", type=int, default=8)
    parser.add_argument("--ref1-sample", type=int, default=0,
                        help="subsample ref1 to N molecules for the kernel "
                             "metrics (FCD/Frag/Scaf/SNN) when the full "
                             "training corpus is too large; novelty always "
                             "uses the full file.  Recorded in the JSON as "
                             "n_reference_1_kernel_sample")
    parser.add_argument("--ref1-sample-seed", type=int, default=0)
    parser.add_argument("--chemnet-weights", default=None,
                        help="path to ChemNet weights (.npz or fcd_torch "
                             ".pt); when given, FCD is literal ChemNet FCD "
                             "instead of the surrogate embedder. Also "
                             "honors $DRUGGEN_CHEMNET_WEIGHTS.")
    parser.add_argument("--device", default="cuda",
                        help="torch device of ChemNet and the IntDiv "
                             "products (e.g. 'cpu' to keep the evaluator off "
                             "the card while a training run holds it)")
    args = parser.parse_args(argv)
    prefix = re.sub(r"\.(json|csv)$", "", args.output)
    results = evaluate_molecules_from_files(
        args.gen, args.ref1, args.ref2, smiles_col=args.smiles_col,
        output_prefix=prefix, n_jobs=args.n_jobs,
        chemnet_weights=args.chemnet_weights, ref1_sample=args.ref1_sample,
        ref1_sample_seed=args.ref1_sample_seed, device=args.device)
    print(f"Evaluation complete. Results in {prefix}.json/.csv")
    return results


if __name__ == "__main__":
    main()

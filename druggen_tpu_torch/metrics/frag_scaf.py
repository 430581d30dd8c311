"""Fragment / scaffold cosine-similarity metrics (reference FragMetric /
ScafMetric, ``src/util/utils.py:892-930``).

Copied from ``druggen_tpu/metrics/frag_scaf.py``; imports point at this package."""

from __future__ import annotations

from collections import Counter

import numpy as np

from druggen_tpu_torch.chem.scaffolds import fragment_molecule, scaffold_smiles


def compute_fragments(smiles_list) -> Counter:
    """Fragment occurrence counts (reference compute_fragments,
    utils.py:766-780)."""
    counts: Counter[str] = Counter()
    for s in smiles_list:
        if s is None:
            continue
        counts.update(fragment_molecule(s))
    return counts


def compute_scaffolds(smiles_list, min_rings: int = 2) -> Counter:
    """Scaffold occurrence counts (reference compute_scaffolds,
    utils.py:783-802)."""
    counts: Counter[str] = Counter()
    for s in smiles_list:
        if s is None:
            continue
        scaf = scaffold_smiles(s, min_rings=min_rings)
        if scaf is not None:
            counts[scaf] += 1
    return counts


def cos_similarity(ref_counts: Counter, gen_counts: Counter) -> float:
    """Cosine similarity of count vectors (reference cos_similarity,
    utils.py:914-930)."""
    if not ref_counts or not gen_counts:
        return float("nan")
    keys = sorted(set(ref_counts) | set(gen_counts))
    ref = np.array([ref_counts.get(k, 0) for k in keys], dtype=np.float64)
    gen = np.array([gen_counts.get(k, 0) for k in keys], dtype=np.float64)
    denom = np.linalg.norm(ref) * np.linalg.norm(gen)
    if denom == 0:
        return float("nan")
    return float(ref @ gen / denom)


def frag_similarity(gen_smiles, ref_smiles) -> float:
    return cos_similarity(compute_fragments(ref_smiles),
                          compute_fragments(gen_smiles))


def scaf_similarity(gen_smiles, ref_smiles) -> float:
    return cos_similarity(compute_scaffolds(ref_smiles),
                          compute_scaffolds(gen_smiles))

"""Molecular quality metrics of training and serving.

Copied from ``druggen_tpu/metrics/molecular.py`` (``fraction_valid``,
``fraction_unique``, ``novelty``, ``average_agg_tanimoto``, ``mol_length``,
``max_component``, ``mean_atom_type``); ``average_agg_tanimoto`` multiplies
the fingerprints with a torch matmul on the CPU instead of ``jnp``.
"""

from __future__ import annotations

import numpy as np
import torch

from druggen_tpu_torch.chem.canon import canonical_smiles
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def fraction_valid(gen: list[str | None]) -> float:
    """Fraction of parseable molecules (reference utils.py:472-484)."""
    if not gen:
        return 0.0
    n_valid = sum(1 for s in gen
                  if s is not None and mol_from_smiles(s) is not None)
    return n_valid / len(gen)


def fraction_unique(gen: list[str | None], k: int | None = None,
                    check_validity: bool = True) -> float:
    """unique@k over canonical forms (reference utils.py:503-527)."""
    if k is not None:
        gen = gen[:k]
    if check_validity:
        canonic = [canonical_smiles(s) for s in gen if s is not None]
        canonic = [c for c in canonic if c is not None]
    else:
        canonic = [s for s in gen if s is not None]
    if not canonic:
        return 0.0
    return len(set(canonic)) / len(canonic)


def novelty(gen: list[str | None], train: list[str],
            train_canon: set[str] | None = None) -> float:
    """Fraction of canonical gen molecules absent from the train set
    (reference utils.py:530-547).  NOTE reference compares canonical gen
    strings against the *raw* train strings; we canonicalize both sides,
    which is strictly more correct (and matches on canonical corpora).
    ``train_canon`` short-circuits the train-side canonicalization with a
    precomputed :func:`canonical_set`."""
    gen_set = {canonical_smiles(s) for s in gen if s is not None}
    gen_set.discard(None)
    if not gen_set:
        return 0.0
    train_set = set(train)
    if train_canon is None:
        train_canon = {canonical_smiles(s) for s in train}
        train_canon = {c for c in train_canon if c is not None}
    known = train_set | train_canon
    return len({g for g in gen_set if g not in known}) / len(gen_set)


def average_agg_tanimoto(stock_vecs: np.ndarray, gen_vecs: np.ndarray,
                         batch_size: int = 5000, agg: str = "max",
                         p: float = 1.0, intdiv: bool = False):
    """Aggregated Tanimoto similarity between two fingerprint stacks
    (reference utils.py:566-611).  The [S,1024]x[1024,G] inner product runs
    as one f32 torch matmul per batch pair, on the CPU."""
    assert agg in ("max", "mean")
    if len(gen_vecs) == 0 or len(stock_vecs) == 0:
        return np.zeros(len(gen_vecs)) if intdiv else 0.0
    agg_tan = np.zeros(len(gen_vecs))
    total = np.zeros(len(gen_vecs))
    for j in range(0, stock_vecs.shape[0], batch_size):
        x = torch.as_tensor(stock_vecs[j:j + batch_size], dtype=torch.float32)
        for i in range(0, gen_vecs.shape[0], batch_size):
            y = torch.as_tensor(gen_vecs[i:i + batch_size], dtype=torch.float32).T
            tp = x @ y
            jac = tp / (x.sum(1, keepdim=True) + y.sum(0, keepdim=True) - tp)
            jac = torch.nan_to_num(jac, nan=1.0).numpy()
            if p != 1:
                jac = jac ** p
            g = jac.shape[1]
            if agg == "max":
                agg_tan[i:i + g] = np.maximum(agg_tan[i:i + g], jac.max(0))
            else:
                agg_tan[i:i + g] += jac.sum(0)
                total[i:i + g] += jac.shape[0]
    if agg == "mean":
        agg_tan /= np.maximum(total, 1)
    if p != 1:
        agg_tan = agg_tan ** (1 / p)
    return agg_tan if intdiv else float(np.mean(agg_tan))


# --- reference Metrics statics (utils.py:37-127) -------------------------

def mol_length(smiles: str | None) -> int:
    """Alphabetic character count of the longest '.'-fragment
    (reference utils.py:78-92)."""
    if smiles is None:
        return 0
    frag = max(smiles.split("."), key=len)
    return sum(1 for ch in frag.upper() if ch.isalpha())


def max_component(smiles_list, max_len: int) -> float:
    """Average normalized fragment length (reference utils.py:95-109)."""
    if len(smiles_list) == 0:
        return 0.0
    lengths = np.array([mol_length(s) for s in smiles_list], np.float32)
    return float((lengths / max_len).mean())


def mean_atom_type(node_label_rows) -> float:
    """Average count of distinct atom labels per sample minus one (the PAD
    label), reference utils.py:112-127."""
    counts = [len(np.unique(np.asarray(row))) for row in node_label_rows]
    if not counts:
        return 0.0
    return float(np.mean(counts) - 1.0)

"""Mean descriptor metrics over SMILES lists (the QED/SA aggregation of
reference ``inference.py:264-265``).

Copied from ``druggen_tpu/metrics/descriptor_metrics.py``; imports point at this package."""

from __future__ import annotations

import numpy as np

from druggen_tpu_torch.chem.descriptors import qed, sa_score
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def mean_qed(smiles_list) -> float:
    vals = [qed(m) for s in smiles_list
            if s is not None and (m := mol_from_smiles(s)) is not None]
    return float(np.mean(vals)) if vals else 0.0


def mean_sa(smiles_list) -> float:
    vals = [sa_score(m) for s in smiles_list
            if s is not None and (m := mol_from_smiles(s)) is not None]
    return float(np.mean(vals)) if vals else 0.0

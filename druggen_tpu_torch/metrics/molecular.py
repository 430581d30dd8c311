"""Validity and uniqueness of generated SMILES.

Copied from ``druggen_tpu/metrics/molecular.py`` (``fraction_valid``,
``fraction_unique``); the report's other metrics are not ported yet.
"""

from __future__ import annotations

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

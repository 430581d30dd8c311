"""Self-contained chemistry runtime (copied subset of ``druggen_tpu.chem``).

- :mod:`periodic` — element tables.
- :mod:`mol`      — the molecular graph object + sanitization.
- :mod:`smiles`   — SMILES parser (``mol_from_smiles``).
- :mod:`canon`    — canonical ranking + SMILES writer (``mol_to_smiles``).
- :mod:`vocab`    — atom/bond encoders-decoders.
- :mod:`codec`    — graph <-> dense matrices codec.
"""

from druggen_tpu_torch.chem.mol import Atom, Bond, Mol, SanitizeError, BondType
from druggen_tpu_torch.chem.smiles import mol_from_smiles, SmilesParseError
from druggen_tpu_torch.chem.canon import mol_to_smiles, canonical_smiles

__all__ = [
    "Atom",
    "Bond",
    "Mol",
    "BondType",
    "SanitizeError",
    "SmilesParseError",
    "mol_from_smiles",
    "mol_to_smiles",
    "canonical_smiles",
]

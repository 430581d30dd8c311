"""Atom/bond vocabulary (encoders/decoders).

Copied from ``druggen_tpu/chem/vocab.py``; imports point at this package,
and the native scan raises where the JAX one falls back to Python.

Reproduces the semantics of the reference's ``get_encoders_decoders``
(``src/data/utils.py:26-126``): scan the union of two SMILES corpora, keep
molecules that parse and have <= max_atom atoms, collect atomic numbers and
bond types, then build

- atom vocab: sorted(atomic numbers U {0}), PAD = atomic number 0 at index 0,
- bond vocab: [ZERO] + sorted(bond types observed)  (SINGLE<DOUBLE<TRIPLE<
  AROMATIC, matching RDKit enum ordering — see BondType docstring).

Vocabs are cached to JSON (the reference pickles; JSON is stabler across
versions) under ``<cache_dir>/vocab_{name1}_{name2}_{max_atom}.json`` with
the two corpus names sorted for a canonical cache key (reference
``utils.py:42-46``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from druggen_tpu_torch.chem.mol import BondType
from druggen_tpu_torch.chem.smiles import mol_from_smiles


@dataclass(frozen=True)
class Vocab:
    atom_labels: tuple[int, ...]   # index -> atomic number (index 0 == PAD 0)
    bond_labels: tuple[int, ...]   # index -> BondType int value

    @property
    def atom_encoder(self) -> dict[int, int]:
        return {l: i for i, l in enumerate(self.atom_labels)}

    @property
    def atom_decoder(self) -> dict[int, int]:
        return {i: l for i, l in enumerate(self.atom_labels)}

    @property
    def bond_encoder(self) -> dict[int, int]:
        return {l: i for i, l in enumerate(self.bond_labels)}

    @property
    def bond_decoder(self) -> dict[int, int]:
        return {i: l for i, l in enumerate(self.bond_labels)}

    @property
    def m_dim(self) -> int:
        """Atom-type dimension (reference train.py:117)."""
        return len(self.atom_labels)

    @property
    def b_dim(self) -> int:
        """Bond-type dimension (reference train.py:118)."""
        return len(self.bond_labels)

    def to_json(self) -> str:
        return json.dumps({"atom_labels": list(self.atom_labels),
                           "bond_labels": list(self.bond_labels)})

    @staticmethod
    def from_json(s: str) -> "Vocab":
        d = json.loads(s)
        return Vocab(tuple(d["atom_labels"]), tuple(d["bond_labels"]))


def read_smiles_file(path: str) -> list[str]:
    """One SMILES per line; tolerate 'SMILES<ws>name' records and headers."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok = line.split()[0]
            if tok.upper() == "SMILES":  # header
                continue
            out.append(tok)
    return out


def build_vocab(smiles_iter, max_atom: int, use_native: bool = True) -> Vocab:
    """Scan SMILES, build the vocabulary (reference utils.py:83-109).

    Uses the multithreaded C++ scanner (:mod:`druggen_tpu_torch.native`
    ``dg_vocab_scan``), built at first use, with the Python loop's
    parse/sanitize/size semantics.  A failed build raises;
    ``use_native=False`` takes the Python loop."""
    if use_native:
        from druggen_tpu_torch import native

        smiles_list = (smiles_iter if isinstance(smiles_iter, list)
                       else list(smiles_iter))
        atoms, bonds = native.vocab_scan_native(smiles_list, max_atom)
        atoms = sorted(set(atoms) | {0})
        return Vocab(tuple(atoms), tuple([0] + sorted(set(bonds) - {0})))
    atom_labels: set[int] = set()
    bond_labels: set[int] = set()
    for smi in smiles_iter:
        mol = mol_from_smiles(smi)
        if mol is None or mol.num_atoms() > max_atom:
            continue
        atom_labels.update(a.atomic_num for a in mol.atoms)
        bond_labels.update(int(b.type) for b in mol.bonds)
    atom_labels.add(0)  # PAD
    bonds = sorted(bond_labels - {0})
    return Vocab(tuple(sorted(atom_labels)), tuple([0] + bonds))


def widen_vocab(vocab: "Vocab", other: "Vocab") -> "Vocab":
    """Union of two vocabularies, re-sorted to the reference's canonical
    order (sorted atomic numbers with PAD 0 first; bonds ZERO first —
    src/data/utils.py:97-109).  Used to pin a scanned corpus vocab to the
    published ChEMBL-v29 label space so (a) the generator's output space
    matches the reference's 12 atom types and (b) released checkpoints
    (m_dim 13 incl. PAD) import without index surgery."""
    atoms = tuple(sorted(set(vocab.atom_labels) | set(other.atom_labels)))
    bonds = tuple([0] + sorted((set(vocab.bond_labels)
                                | set(other.bond_labels)) - {0}))
    return Vocab(atoms, bonds)


def get_vocab(raw_file1: str, raw_file2: str, max_atom: int,
              cache_dir: str = "data/vocab",
              union_ref12: bool = False) -> Vocab:
    """Load-or-build the vocab for a pair of corpora (reference
    ``get_encoders_decoders``, src/data/utils.py:26-126).

    ``union_ref12``: widen the scanned vocab with the published ChEMBL-v29
    atom set (:data:`CHEMBL_VOCAB` — reference README.md:141-145), closing
    the gap when the training corpus lacks the rare-element tail
    (Ca/K/As).  Cached under a distinct key."""
    name1 = os.path.splitext(os.path.basename(raw_file1))[0]
    name2 = os.path.splitext(os.path.basename(raw_file2))[0]
    a, b = sorted([name1, name2])
    suffix = "_ref12" if union_ref12 else ""
    path = os.path.join(cache_dir, f"vocab_{a}_{b}_{max_atom}{suffix}.json")
    if os.path.exists(path):
        with open(path) as f:
            return Vocab.from_json(f.read())
    smiles = read_smiles_file(raw_file1) + read_smiles_file(raw_file2)
    vocab = build_vocab(smiles, max_atom)
    if union_ref12:
        vocab = widen_vocab(vocab, CHEMBL_VOCAB)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(vocab.to_json())
    os.replace(tmp, path)
    return vocab


# The published DrugGEN ChEMBL-v29 vocabulary (reference README.md:141-145:
# C,O,N,F,Ca,K,Br,B,S,P,Cl,As + PAD; bonds single/double/triple/aromatic).
CHEMBL_VOCAB = Vocab(
    atom_labels=(0, 5, 6, 7, 8, 9, 15, 16, 17, 19, 20, 33, 35),
    bond_labels=(0, 1, 2, 3, 4),
)

"""Morgan/ECFP-style circular fingerprints.

Replacement for RDKit's ``GetMorganFingerprintAsBitVect(mol, 2, nBits=1024)``
used throughout the reference for SNN/IntDiv metrics (``train.py:294``,
``inference.py:150,242-243``, ``utils.py:308-309``).

Algorithm (standard ECFP): each atom starts from a hashed invariant tuple;
for ``radius`` iterations, an atom's identifier is re-hashed from its own
identifier plus the sorted (bond-type, neighbor-identifier) pairs; every
identifier from every iteration sets ``hash % n_bits``.  Deterministic
(pure-Python hash via blake2b of the tuple bytes) and self-consistent —
bit-for-bit RDKit compatibility is neither possible offline nor needed,
since all fingerprint consumers compare our fingerprints with each other.

Copied from ``druggen_tpu/chem/fingerprints.py``; imports point at this package.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from druggen_tpu_torch.chem.mol import Mol


def _hash64(*vals: int) -> int:
    # mask to unsigned 64-bit: identifiers from previous rounds are already
    # uint64, invariant fields are small non-negatives (charge offset below)
    data = struct.pack(f"<{len(vals)}Q",
                       *((v + (1 << 16)) & 0xFFFFFFFFFFFFFFFF for v in vals))
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


def morgan_fingerprint(mol: Mol, radius: int = 2, n_bits: int = 1024
                       ) -> np.ndarray:
    """uint8 bit vector [n_bits] (1024 bits default, like the reference)."""
    fp = np.zeros(n_bits, dtype=np.uint8)
    n = mol.num_atoms()
    if n == 0:
        return fp
    # initial invariants: (atomic_num, degree, charge, total_hs, in_ring,
    # aromatic) — the standard ECFP atom invariant set
    ids = []
    for i, a in enumerate(mol.atoms):
        ids.append(_hash64(a.atomic_num, mol.degree(i), a.charge,
                           a.total_hs(), int(a.in_ring), int(a.aromatic)))
    for ident in ids:
        fp[ident % n_bits] = 1
    for _ in range(radius):
        new_ids = []
        for i in range(n):
            nbrs = sorted(
                (int(mol.get_bond(i, j).type), ids[j])
                for j in mol.neighbors(i))
            flat = [ids[i]]
            for bt, nid in nbrs:
                flat.extend((bt, nid))
            new_ids.append(_hash64(*flat))
        ids = new_ids
        for ident in ids:
            fp[ident % n_bits] = 1
    return fp


def fingerprints_for_smiles(smiles_list, radius: int = 2, n_bits: int = 1024
                            ) -> np.ndarray:
    """Stack of fingerprints for the parseable molecules in the list
    (invalid SMILES are skipped, like the reference's None-filtered
    comprehensions)."""
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    fps = []
    for s in smiles_list:
        mol = mol_from_smiles(s)
        if mol is not None:
            fps.append(morgan_fingerprint(mol, radius, n_bits))
    if not fps:
        return np.zeros((0, n_bits), dtype=np.uint8)
    return np.stack(fps)

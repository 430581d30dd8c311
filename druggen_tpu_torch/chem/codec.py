"""Graph <-> dense-matrix codec.

Copied from ``druggen_tpu/chem/codec.py``; imports point at this package.

The featurization half reproduces the reference's ``_genA``/``_genX``/
``_genF`` (``src/data/dataset.py:119-185``): a molecule becomes

- ``X``: int label vector [max_atom] of atom-vocab indices (0 = PAD), and
- ``A``: int label matrix [max_atom, max_atom] of bond-vocab indices,

with the same connectivity filter (every real atom must have degree > 0,
``dataset.py:138-139``).

The decoding half reproduces ``matrices2mol`` + ``check_valency`` +
``correct_mol`` (``dataset.py:205-277``): argmax label matrices are turned
back into a molecule by adding one bond per strict-lower-triangle nonzero,
optionally sanitized (strict) or valence-repaired by removing the
highest-order bond at each offending atom until the molecule sanitizes.
"""

from __future__ import annotations

import numpy as np

from druggen_tpu_torch.chem.mol import Atom, BondType, Mol, SanitizeError
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.chem.vocab import Vocab


def mol_to_matrices(mol: Mol, vocab: Vocab, max_atom: int,
                    connected: bool = True) -> tuple[np.ndarray, np.ndarray] | None:
    """Featurize a sanitized Mol into (X [N], A [N,N]) int8 label arrays.

    Returns None if the molecule uses out-of-vocab atoms/bonds, exceeds
    ``max_atom``, or (when ``connected``) has an isolated atom — the same
    rejections as reference ``_filter_smiles`` + ``_genA``
    (``dataset.py:80-139``)."""
    n = mol.num_atoms()
    if n == 0 or n > max_atom:
        return None
    aenc = vocab.atom_encoder
    benc = vocab.bond_encoder
    X = np.zeros(max_atom, dtype=np.int8)
    for i, a in enumerate(mol.atoms):
        idx = aenc.get(a.atomic_num)
        if idx is None:
            return None
        X[i] = idx
    A = np.zeros((max_atom, max_atom), dtype=np.int8)
    for b in mol.bonds:
        idx = benc.get(int(b.type))
        if idx is None:
            return None
        A[b.a1, b.a2] = idx
        A[b.a2, b.a1] = idx
    if connected and n > 1:
        deg = (A[:n, :n] != 0).sum(axis=-1)
        if not (deg > 0).all():
            return None
    if connected and n == 1:
        return None  # single atom has degree 0 => reference drops it
    return X, A


def smiles_to_matrices(smiles: str, vocab: Vocab, max_atom: int
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    return mol_to_matrices(mol, vocab, max_atom)


def atom_features(mol: Mol, max_atom: int) -> np.ndarray:
    """Extra per-atom feature block (reference ``_genF``,
    ``dataset.py:161-185``, gated by the ``--features`` flag): one-hot-ish
    indicator features over degree, explicit/implicit valence,
    hybridization, aromaticity, H counts, ring membership and ring sizes.
    53 columns, zero-padded to ``max_atom`` rows.

    Hybridization here is derived (sp=2 neighbors+triple/cumulated, sp2=
    has double bond or aromatic, sp3 otherwise) since our Mol doesn't carry
    RDKit's enum; the indicator layout keeps the same 6-slot structure."""
    n = mol.num_atoms()
    rings = mol.ring_info()
    ring_sizes = [set() for _ in range(n)]
    for r in rings:
        for i in r:
            ring_sizes[i].add(len(r))
    feats = []
    for i, a in enumerate(mol.atoms):
        deg = mol.degree(i)
        ev = int(round(mol.explicit_valence(i)
                       - (a.explicit_hs if a.explicit_hs is not None else 0)))
        iv = a.implicit_hs  # GetImplicitValence == implicit H count
        n_triple = sum(1 for bi in mol.adj()[i]
                       if mol.bonds[bi].type == BondType.TRIPLE)
        n_double = sum(1 for bi in mol.adj()[i]
                       if mol.bonds[bi].type == BondType.DOUBLE)
        if a.aromatic or (n_double == 1 and n_triple == 0):
            hyb = 3        # sp2  (RDKit HybridizationType.SP2 == 3)
        elif n_triple >= 1 or n_double >= 2:
            hyb = 2        # sp
        else:
            hyb = 4        # sp3
        row = (
            [deg == k for k in range(5)]              # 5
            + [ev == k for k in range(9)]             # 9
            + [hyb == k for k in range(1, 7)]         # 6
            + [iv == k for k in range(9)]             # 9
            + [a.aromatic]                            # 1
            + [a.explicit_hs is not None]             # 1 (NoImplicit analogue)
            + [(a.explicit_hs or 0) == k for k in range(5)]   # 5
            + [a.implicit_hs == k for k in range(5)]  # 5
            + [0, 0, 0, 0, 0]                         # radical electrons: 5
            + [a.in_ring]                             # 1
            + [k in ring_sizes[i] for k in range(2, 9)]  # 7
        )
        # radical-electron one-hot: we model no radicals => slot "0" true
        # (layout: 5+9+6+9+1+1+5+5 = 41 is the radicals==0 indicator)
        row[41] = True
        feats.append([int(x) for x in row])
    arr = np.array(feats, dtype=np.int8)
    out = np.zeros((max_atom, arr.shape[1]), dtype=np.int8)
    out[:n] = arr
    return out


def matrices_to_mol(node_labels: np.ndarray, edge_labels: np.ndarray,
                    vocab: Vocab, strict: bool = True) -> Mol | None:
    """Decode argmax label matrices back into a molecule.

    Mirrors reference ``matrices2mol`` (``dataset.py:205-229``): one atom per
    node label (PAD label 0 decodes to atomic number 0 — a ``*`` wildcard —
    exactly as RDKit's ``Chem.Atom(0)`` does there), one bond per
    strict-lower-triangle nonzero edge label.  With ``strict``, sanitize and
    return None on failure."""
    adec = vocab.atom_decoder
    bdec = vocab.bond_decoder
    mol = Mol()
    for lbl in np.asarray(node_labels).tolist():
        num = adec.get(int(lbl))
        if num is None:
            return None
        mol.add_atom(Atom(atomic_num=int(num)))
    E = np.asarray(edge_labels)
    starts, ends = np.nonzero(E)
    for s, e in zip(starts.tolist(), ends.tolist()):
        if s > e:
            bt = bdec.get(int(E[s, e]))
            if bt is None or bt == 0:
                continue
            try:
                mol.add_bond(int(s), int(e), BondType(bt))
            except ValueError:
                return None
    if strict:
        try:
            mol.sanitize()
        except (SanitizeError, ValueError):
            return None
    else:
        mol.assign_implicit_hs_best_effort()
    return mol


def check_valency(mol: Mol) -> tuple[bool, tuple[int, float] | None]:
    """Reference ``check_valency`` (``dataset.py:231-249``): True if all
    valences legal, else (False, (atom_idx, valence))."""
    try:
        mol.sanitize()
        return True, None
    except SanitizeError as e:
        if e.atom_idx is not None:
            return False, (e.atom_idx, e.valence or 0.0)
        return False, (0, 0.0)
    except ValueError:
        return False, (0, 0.0)


def correct_mol(mol: Mol, max_steps: int = 200) -> Mol:
    """Valence repair (reference ``correct_mol``, ``dataset.py:251-277``):
    while some atom exceeds its valence, remove that atom's highest-order
    bond; also drop un-kekulizable aromatic bonds the same way."""
    for _ in range(max_steps):
        ok, info = check_valency(mol)
        if ok:
            break
        idx = info[0] if info else 0
        bonds = [(bi, int(mol.bonds[bi].type), mol.bonds[bi].a1, mol.bonds[bi].a2)
                 for bi in mol.adj()[idx]] if idx < mol.num_atoms() else []
        if not bonds:
            break
        bonds.sort(key=lambda t: t[1], reverse=True)
        _, _, a1, a2 = bonds[0]
        mol.remove_bond(a1, a2)
    return mol


def strip_to_largest_fragment(smiles: str) -> str:
    """Largest '.'-fragment by string length + '*'->'C' substitution, the
    post-processing of reference ``inference.py:209-217``."""
    frag = max(smiles.split("."), key=len) if smiles else smiles
    return frag.replace("*", "C")

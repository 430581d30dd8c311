"""Murcko scaffolds and fragment decomposition.

Copied from ``druggen_tpu/chem/scaffolds.py``; imports point at this package.

Replaces the RDKit Murcko/BRICS machinery used by the reference's
Frag/Scaf metrics (``src/util/utils.py:727-838``).

- :func:`murcko_scaffold` — iteratively prunes terminal atoms that hang off
  the ring system by single bonds (keeping exocyclic double bonds, like
  RDKit's MurckoScaffold).
- :func:`fragment_molecule` — simplified BRICS-style fragmentation: breaks
  acyclic single bonds at ring attachment points and heteroatom-carbon
  junctions (the two dominant BRICS environments); fragments are returned
  as canonical SMILES.  Documented approximation of RDKit's
  ``FragmentOnBRICSBonds`` (reference utils.py:727-739).
"""

from __future__ import annotations

import copy

from druggen_tpu_torch.chem.canon import mol_to_smiles
from druggen_tpu_torch.chem.mol import BondType, Mol
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def murcko_scaffold(mol: Mol) -> Mol | None:
    """Ring systems + linkers; None if the molecule is acyclic."""
    work = copy.deepcopy(mol)
    try:
        work.sanitize()
    except Exception:
        return None
    ring_atoms: set[int] = set()
    for r in work.ring_info():
        ring_atoms.update(r)
    if not ring_atoms:
        return None
    # keep atoms on any path between rings: prune degree-1 single-bonded
    # non-ring atoms to a fixed point
    keep = set(range(work.num_atoms()))
    changed = True
    while changed:
        changed = False
        for i in sorted(keep):
            if i in ring_atoms:
                continue
            nbrs = [j for j in work.neighbors(i) if j in keep]
            if len(nbrs) <= 1:
                bond = work.get_bond(i, nbrs[0]) if nbrs else None
                if bond is None or bond.type == BondType.SINGLE:
                    keep.discard(i)
                    changed = True
    sub = work.submol(sorted(keep))
    try:
        sub.sanitize()
    except Exception:
        # e.g. pruning split an aromatic flag inconsistency; treat as none
        return None
    return sub


def scaffold_smiles(smiles: str, min_rings: int = 2) -> str | None:
    """Canonical scaffold SMILES if it has >= min_rings rings (reference
    compute_scaffold, utils.py:818-838)."""
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    scaf = murcko_scaffold(mol)
    if scaf is None or scaf.num_rings() < min_rings:
        return None
    return mol_to_smiles(scaf)


def fragment_molecule(smiles: str) -> list[str]:
    """Break BRICS-style bonds; canonical SMILES per fragment (including the
    unfragmented molecule itself when nothing breaks)."""
    mol = mol_from_smiles(smiles)
    if mol is None:
        return []
    ring_bonds: set[frozenset[int]] = set()
    for r in mol.ring_info():
        for i in range(len(r)):
            ring_bonds.add(frozenset((r[i], r[(i + 1) % len(r)])))
    cut: list[tuple[int, int]] = []
    for b in mol.bonds:
        if b.type != BondType.SINGLE:
            continue
        if frozenset((b.a1, b.a2)) in ring_bonds:
            continue
        z1 = mol.atoms[b.a1]
        z2 = mol.atoms[b.a2]
        ring_attach = z1.in_ring != z2.in_ring
        hetero_junction = ((z1.atomic_num != 6) != (z2.atomic_num != 6))
        # don't cut terminal bonds — single atoms aren't fragments
        terminal = mol.degree(b.a1) == 1 or mol.degree(b.a2) == 1
        if (ring_attach or hetero_junction) and not terminal:
            cut.append((b.a1, b.a2))
    work = copy.deepcopy(mol)
    for a1, a2 in cut:
        work.remove_bond(a1, a2)
    frags = []
    for comp in work.connected_components():
        sub = work.submol(comp)
        try:
            sub.sanitize()
        except Exception:
            continue
        frags.append(mol_to_smiles(sub))
    return frags

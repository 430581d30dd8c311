"""Structural-alert filters.

Copied from ``druggen_tpu/chem/filters.py``; imports point at this package.

The reference loads RDKit's full PAINS A/B/C SMARTS catalogue
(``src/util/utils.py:668-695``).  Since round 2 the default path runs the
from-scratch SMARTS engine (:mod:`druggen_tpu_torch.chem.smarts`) over the
family catalogue in :mod:`druggen_tpu_torch.chem.pains`; the round-1 procedural
graph checks below are kept as a dependency-free fast path
(``is_pains(mol, load_pains_filters())``) and for regression comparison.
Same call contract either way: ``is_pains(mol, catalog)``.
"""

from __future__ import annotations

from druggen_tpu_torch.chem.mol import BondType, Mol
from druggen_tpu_torch.chem.pains import PainsCatalog, load_pains_catalog


def _carbonyl_carbons(mol: Mol) -> set[int]:
    out = set()
    for b in mol.bonds:
        if b.type != BondType.DOUBLE:
            continue
        for c, o in ((b.a1, b.a2), (b.a2, b.a1)):
            if mol.atoms[c].atomic_num == 6 and mol.atoms[o].atomic_num == 8:
                out.add(c)
    return out


def has_quinone(mol: Mol) -> bool:
    """Six-ring with two ring-carbon carbonyls (para or ortho)."""
    carbonyls = _carbonyl_carbons(mol)
    for ring in mol.ring_info():
        if len(ring) != 6:
            continue
        ring_carbonyls = [i for i in ring if i in carbonyls]
        if len(ring_carbonyls) >= 2:
            # require the remaining ring bonds to carry double bonds
            # (quinoid, not cyclohexanedione)
            n_double = sum(
                1 for idx in range(6)
                if mol.get_bond(ring[idx], ring[(idx + 1) % 6]) is not None
                and mol.get_bond(ring[idx], ring[(idx + 1) % 6]).type
                in (BondType.DOUBLE, BondType.AROMATIC))
            if n_double >= 2:
                return True
    return False


def has_catechol(mol: Mol) -> bool:
    """Aromatic ring with two adjacent (ortho) or para OH groups."""
    oh_ring_atoms = set()
    for i, a in enumerate(mol.atoms):
        if not a.aromatic:
            continue
        for j in mol.neighbors(i):
            aj = mol.atoms[j]
            if (aj.atomic_num == 8 and aj.total_hs() >= 1
                    and mol.degree(j) == 1):
                oh_ring_atoms.add(i)
    for ring in mol.ring_info():
        members = [i for i in ring if i in oh_ring_atoms]
        if len(members) < 2:
            continue
        pos = {a: idx for idx, a in enumerate(ring)}
        n = len(ring)
        for x in range(len(members)):
            for y in range(x + 1, len(members)):
                dist = abs(pos[members[x]] - pos[members[y]])
                dist = min(dist, n - dist)
                if dist in (1, n // 2):
                    return True
    return False


def has_azo(mol: Mol) -> bool:
    """Acyclic N=N."""
    for b in mol.bonds:
        if (b.type == BondType.DOUBLE
                and mol.atoms[b.a1].atomic_num == 7
                and mol.atoms[b.a2].atomic_num == 7
                and not (mol.atoms[b.a1].in_ring and mol.atoms[b.a2].in_ring)):
            return True
    return False


def has_thiocarbonyl_heterocycle(mol: Mol) -> bool:
    """Rhodanine-type: ring atom C with exocyclic =S."""
    for b in mol.bonds:
        if b.type != BondType.DOUBLE:
            continue
        for c, s in ((b.a1, b.a2), (b.a2, b.a1)):
            if (mol.atoms[c].atomic_num == 6 and mol.atoms[c].in_ring
                    and mol.atoms[s].atomic_num == 16
                    and not mol.atoms[s].in_ring):
                return True
    return False


def has_ene_dione(mol: Mol) -> bool:
    """C=C flanked by two carbonyls (alkylidene barbiturate / maleimide
    electrophile core)."""
    carbonyls = _carbonyl_carbons(mol)
    for b in mol.bonds:
        if b.type != BondType.DOUBLE:
            continue
        if (mol.atoms[b.a1].atomic_num == 6
                and mol.atoms[b.a2].atomic_num == 6):
            for end in (b.a1, b.a2):
                flank = [j for j in mol.neighbors(end)
                         if j in carbonyls]
                if len(flank) >= 2:
                    return True
    return False


_PAINS_CHECKS = (has_quinone, has_catechol, has_azo,
                 has_thiocarbonyl_heterocycle, has_ene_dione)


def load_pains_filters():
    """Returns the procedural catalog (call-contract parity with the
    reference's load_pains_filters, utils.py:668-680)."""
    return _PAINS_CHECKS


def is_pains(mol: Mol, catalog=None) -> bool:
    """True if any alert fires (reference is_pains, utils.py:683-695).

    Default catalogue is the SMARTS-based PAINS family table
    (chem/pains.py); pass ``load_pains_filters()`` for the round-1
    procedural subset."""
    if not mol.sanitized:
        try:
            mol.sanitize()
        except Exception:
            return False
    if catalog is None:
        catalog = load_pains_catalog()
    if isinstance(catalog, PainsCatalog):
        return catalog.first_match(mol) is not None
    return any(check(mol) for check in catalog)

"""Exact Wildman-Crippen logP.

Copied from ``druggen_tpu/chem/crippen.py``; imports point at this package.

The reference computes logP through RDKit's ``Crippen.MolLogP``
(``reference/src/util/utils.py:641`` for Lipinski rule 4; QED's
ALOGP descriptor at ``inference.py:264`` via ``QED.qed``), which
implements Wildman & Crippen, *J. Chem. Inf. Comput. Sci.* 1999, 39,
868-873: every atom is assigned one of 68 published atom types by
first-match-wins SMARTS classification, and logP is the sum of the
published per-type contributions.

This module re-implements that scheme on the from-scratch SMARTS engine
(:mod:`druggen_tpu_torch.chem.smarts`).  Differences from RDKit's mechanics
(not from the published method):

- Hydrogens are implicit in :class:`druggen_tpu_torch.chem.mol.Mol`, so the H
  types (H1-H4, HS) are assigned procedurally per *parent* heavy atom by
  rules equivalent to the published H SMARTS evaluated in table order
  (each H pattern constrains only the H's bonded neighborhood, so the
  parent atom determines the type).
- The metal fallback classes (Me1/Me2) and ionic-halogen class (Hal) are
  assigned by atomic-number dispatch instead of SMARTS — they are plain
  element lists in the paper.

The heavy-atom SMARTS, their order, and all contribution values follow
the published table.  Pattern order matters and is part of the method
(e.g. the carboxylate special case O12 precedes the generic anionic O7).
"""

from __future__ import annotations

from druggen_tpu_torch.chem.mol import BondType, Mol
from druggen_tpu_torch.chem.smarts import MolFeatures, compile_smarts

# ---------------------------------------------------------------------
# Published per-type logP contributions (Wildman & Crippen 1999, Table 1)
# ---------------------------------------------------------------------

LOGP_CONTRIB = {
    "C1": 0.1441, "C2": 0.0, "C3": -0.2035, "C4": -0.2051, "C5": -0.2783,
    "C6": 0.1551, "C7": 0.0017, "C8": 0.08452, "C9": -0.1444,
    "C10": -0.0516, "C11": 0.1193, "C12": -0.0967, "C13": -0.5443,
    "C14": 0.0, "C15": 0.2450, "C16": 0.1980, "C17": 0.0, "C18": 0.1581,
    "C19": 0.2955, "C20": 0.2713, "C21": 0.1360, "C22": 0.4619,
    "C23": 0.5437, "C24": 0.1893, "C25": -0.8186, "C26": 0.2640,
    "C27": 0.2148, "CS": 0.08129,
    "H1": 0.1230, "H2": -0.2677, "H3": 0.2142, "H4": 0.2980, "HS": 0.1125,
    "N1": -1.0190, "N2": -0.7096, "N3": -1.0270, "N4": -0.5188,
    "N5": 0.08387, "N6": 0.1836, "N7": -0.3187, "N8": -0.4458,
    "N9": 0.01508, "N10": -1.950, "N11": -0.3239, "N12": -1.119,
    "N13": -0.3396, "N14": 0.2887, "NS": -0.4806,
    "O1": 0.1552, "O2": -0.2893, "O3": -0.0684, "O4": 0.4833,
    "O5": 0.0335, "O6": -0.3339, "O7": -1.189, "O8": 0.1788,
    "O9": -0.1526, "O10": 0.1129, "O11": 0.4833, "O12": -1.326,
    "OS": -0.1188,
    "F": 0.4202, "Cl": 0.6895, "Br": 0.8456, "I": 0.8857, "Hal": -2.996,
    "P": 0.8612, "S1": 0.6482, "S2": -0.0024, "S3": 0.6237,
    "Me1": -0.3808, "Me2": -0.0025,
}

# ---------------------------------------------------------------------
# Heavy-atom SMARTS classification (first match in table order wins).
# The typed atom is always the pattern's FIRST atom (matching_atoms
# anchors there).  Grouped per element for dispatch.
# ---------------------------------------------------------------------

_CARBON = [
    ("C1", "[CH4]"),
    ("C1", "[CH3]C"),
    ("C1", "[CH2](C)C"),
    ("C2", "[CH](C)(C)C"),
    ("C2", "[C](C)(C)(C)C"),
    ("C3", "[CH3][N,O,P,S,F,Cl,Br,I]"),
    ("C3", "[CH2X4][N,O,P,S,F,Cl,Br,I]"),
    ("C4", "[CH1X4][N,O,P,S,F,Cl,Br,I]"),
    ("C4", "[CH0X4][N,O,P,S,F,Cl,Br,I]"),
    ("C5", "[C]=[!C;A;!#1]"),
    ("C6", "[CH2]=C"),
    ("C6", "[CH1](=C)[A;!#1]"),
    ("C6", "[CH0](=C)([A;!#1])[A;!#1]"),
    ("C6", "[C](=C)=C"),
    ("C7", "[CX2]#[A;!#1]"),
    ("C8", "[CH3]c"),
    ("C9", "[CH3]a"),
    ("C10", "[CH2X4]a"),
    ("C11", "[CHX4]a"),
    ("C12", "[CH0X4]a"),
    ("C13", "[cH0]-[A;!C;!N;!O;!S;!F;!Cl;!Br;!I;!#1]"),
    ("C14", "[c][#9]"),
    ("C15", "[c][#17]"),
    ("C16", "[c][#35]"),
    ("C17", "[c][#53]"),
    ("C18", "[cH]"),
    ("C19", "[c](:a)(:a):a"),
    ("C20", "[c](:a)(:a)-a"),
    ("C21", "[c](:a)(:a)-C"),
    ("C22", "[c](:a)(:a)-N"),
    ("C23", "[c](:a)(:a)-O"),
    ("C24", "[c](:a)(:a)-S"),
    ("C25", "[c](:a)(:a)=[C,N,O]"),
    ("C26", "[C](=C)(a)[A;!#1]"),
    ("C26", "[C](=C)(c)a"),
    ("C26", "[CH1](=C)a"),
    ("C26", "[C]=c"),
    ("C27", "[CX4][A;!C;!N;!O;!P;!S;!F;!Cl;!Br;!I;!#1]"),
    ("CS", "[#6]"),
]

_NITROGEN = [
    ("N1", "[NH2+0][A;!#1]"),
    ("N2", "[NH+0]([A;!#1])[A;!#1]"),
    ("N3", "[NH2+0]a"),
    ("N4", "[NH1+0]([!#1;A,a])a"),
    ("N5", "[NH+0]=[!#1;A,a]"),
    ("N6", "[N+0](=[!#1;A,a])[!#1;A,a]"),
    ("N7", "[N+0]([A;!#1])([A;!#1])[A;!#1]"),
    ("N8", "[N+0](a)([!#1;A,a])[A;!#1]"),
    ("N8", "[N+0](a)(a)a"),
    ("N9", "[N+0]#[A;!#1]"),
    ("N10", "[NH3,NH2,NH;+,+2,+3]"),
    ("N11", "[n+0]"),
    ("N12", "[n;+,+2,+3]"),
    ("N13", "[NH0;+,+2,+3]([A;!#1])([A;!#1])([A;!#1])[A;!#1]"),
    ("N13", "[NH0;+,+2,+3](=[A;!#1])([A;!#1])[!#1;A,a]"),
    ("N13", "[NH0;+,+2,+3](=[#6])=[#7]"),
    ("N14", "[N;+,+2,+3]#[A;!#1]"),
    ("N14", "[N;-,-2,-3]"),
    ("N14", "[N;+,+2,+3](=[N;-,-2,-3])=N"),
    ("NS", "[#7]"),
]

_OXYGEN = [
    ("O1", "[o]"),
    ("O2", "[OH,OH2]"),
    ("O3", "[O]([A;!#1])[A;!#1]"),
    ("O4", "[O](a)[!#1;A,a]"),
    ("O5", "[O]=[#7,#8]"),
    ("O5", "[OX1;-,-2,-3][#7,#8]"),
    ("O6", "[OX1;-,-2,-3][#16]"),
    ("O6", "[O;-0]=[#16;-0]"),
    # the carboxylate special case precedes the generic anionic oxygen —
    # the published order, and load-bearing
    ("O12", "[O-1]C(=O)"),
    ("O7", "[OX1;-,-2,-3][!#1;!#7;!#16]"),
    ("O8", "[O]=c"),
    ("O9", "[O]=[CH]C"),
    ("O9", "[O]=C(C)([A;!#1])"),
    ("O9", "[O]=[CH][N,O]"),
    ("O9", "[O]=[CH2]"),
    ("O9", "[O]=[CX2]=O"),
    ("O10", "[O]=[CH]c"),
    ("O10", "[O]=C([C,c])[a;!#1]"),
    ("O10", "[O]=C(c)[A;!#1]"),
    ("O11", "[O]=C([!#1;!#6])[!#1;!#6]"),
    ("OS", "[#8]"),
]

_SULFUR = [
    ("S2", "[S;-,-2,-3,+,+2,+3,+4,+5]"),
    ("S2", "[S-0]=[N,O,P,S]"),
    ("S1", "[S;-0]"),
    ("S3", "[s]"),
]

_HALOGEN = {9: "F", 17: "Cl", 35: "Br", 53: "I"}

# Me1: alkali/alkaline-earth + the p-block semimetals the paper lists
_ME1 = {3, 11, 19, 37, 55,          # Li Na K Rb Cs
        4, 12, 20, 38, 56,          # Be Mg Ca Sr Ba
        5, 13, 31, 49, 81,          # B Al Ga In Tl
        14, 32, 50, 82,             # Si Ge Sn Pb
        33, 51, 83,                 # As Sb Bi
        34, 52, 84}                 # Se Te Po

_compiled_cache: dict[int, list] = {}


def _compiled(z: int):
    if z not in _compiled_cache:
        table = {6: _CARBON, 7: _NITROGEN, 8: _OXYGEN, 16: _SULFUR}[z]
        _compiled_cache[z] = [(t, compile_smarts(p)) for t, p in table]
    return _compiled_cache[z]


def _classify_heavy(feats: MolFeatures, i: int) -> str:
    mol = feats.mol
    a = mol.atoms[i]
    z = a.atomic_num
    if z in (6, 7, 8, 16):
        for typ, pat in _compiled(z):
            if pat._matches_rooted(feats, i):
                return typ
        return {6: "CS", 7: "NS", 8: "OS", 16: "S1"}[z]
    if z in _HALOGEN:
        return "Hal" if a.charge != 0 else _HALOGEN[z]
    if z == 15:
        return "P"
    if z in _ME1:
        return "Me1"
    if z == 1:
        return "HS"  # explicit-H graphs never occur here, but be total
    return "Me2"


def _classify_h(mol: Mol, parent: int) -> str:
    """Type of the implicit hydrogens on ``parent``, by the published H
    SMARTS evaluated in table order (H1; H2 a-c; H3 a-b; H4 a-b; HS).

    Every published H pattern constrains only the parent atom and the
    parent's other neighbors, so implicit hydrogens are typed exactly."""
    a = mol.atoms[parent]
    z = a.atomic_num
    if z == 6:
        return "H1"                             # [#1][#6,#1]
    if z == 8:
        nbrs = list(mol.neighbors(parent))
        nbr_atoms = [mol.atoms[j] for j in nbrs]
        # H2: [#1]O[CX4,c]
        for j, n in zip(nbrs, nbr_atoms):
            if n.atomic_num == 6 and (
                    n.aromatic
                    or mol.degree(j) + n.total_hs() == 4):
                return "H2"
        # H2: [#1]O[!C;!N;!O;!S]  (with implicit H a bare OH2 also lands
        # here, matching RDKit's explicit-H evaluation where the other H
        # satisfies the expression)
        if any(n.atomic_num not in (6, 7, 8, 16) for n in nbr_atoms) \
                or not nbrs:
            return "H2"
        # H3: [#1]O[#7]
        if any(n.atomic_num == 7 for n in nbr_atoms):
            return "H3"
        # H4: [#1]OC=[C,N,O,S]
        for j, n in zip(nbrs, nbr_atoms):
            if n.atomic_num == 6 and not n.aromatic:
                for k in mol.neighbors(j):
                    b = mol.get_bond(j, k)
                    if (b is not None and b.type == BondType.DOUBLE
                            and mol.atoms[k].atomic_num in (6, 7, 8, 16)
                            and not mol.atoms[k].aromatic):
                        return "H4"
        # H4: [#1]O[O,S]
        if any(n.atomic_num in (8, 16) and not n.aromatic
               for n in nbr_atoms):
            return "H4"
        return "HS"
    # H2: [#1][!C;!N;!O]  (H directly on S, P, B, Se, ...)
    if z not in (6, 7, 8):
        return "H2"
    if z == 7:
        return "H3"                             # [#1][#7]
    return "HS"


def crippen_atom_types(mol: Mol) -> list[str]:
    """Published atom type per heavy atom (H types via
    :func:`crippen_contributions`)."""
    feats = MolFeatures(mol)
    return [_classify_heavy(feats, i) for i in range(mol.num_atoms())]


def crippen_contributions(mol: Mol) -> list[tuple[str, float, str, int]]:
    """Per heavy atom: (type, logp incl. its implicit H, H type, n_H)."""
    feats = MolFeatures(mol)
    out = []
    for i, a in enumerate(mol.atoms):
        typ = _classify_heavy(feats, i)
        contrib = LOGP_CONTRIB[typ]
        n_h = a.total_hs()
        h_typ = ""
        if n_h:
            h_typ = _classify_h(mol, i)
            contrib += n_h * LOGP_CONTRIB[h_typ]
        out.append((typ, contrib, h_typ, n_h))
    return out


def crippen_logp(mol: Mol) -> float:
    """Wildman-Crippen logP: sum of published per-type contributions
    (RDKit ``Crippen.MolLogP`` equivalent)."""
    return float(sum(c for _, c, _, _ in crippen_contributions(mol)))

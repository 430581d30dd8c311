"""Periodic-table data for the chem runtime.

Copied from ``druggen_tpu/chem/periodic.py``; imports point at this package.

Only what the framework needs: symbols, atomic numbers, default valence
models, monoisotopic/average masses, aromatic-capable elements.  Covers the
full organic/medchem envelope (the DrugGEN ChEMBL vocabulary is
C,O,N,F,Ca,K,Br,B,S,P,Cl,As — reference README.md:141-145 — but we support
the usual superset so arbitrary SMILES parse).
"""

from __future__ import annotations

# symbol -> atomic number
SYMBOL_TO_NUM = {
    "H": 1, "He": 2,
    "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Ne": 10,
    "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16, "Cl": 17,
    "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22, "V": 23, "Cr": 24,
    "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30, "Ga": 31,
    "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54,
    "Cs": 55, "Ba": 56, "La": 57, "Gd": 64, "Pt": 78, "Au": 79, "Hg": 80,
    "Tl": 81, "Pb": 82, "Bi": 83,
}

NUM_TO_SYMBOL = {v: k for k, v in SYMBOL_TO_NUM.items()}

# Average atomic masses (enough precision for MW descriptors).
ATOMIC_MASS = {
    1: 1.008, 2: 4.003, 3: 6.941, 4: 9.012, 5: 10.811, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.180, 11: 22.990, 12: 24.305,
    13: 26.982, 14: 28.086, 15: 30.974, 16: 32.065, 17: 35.453, 18: 39.948,
    19: 39.098, 20: 40.078, 24: 51.996, 25: 54.938, 26: 55.845, 27: 58.933,
    28: 58.693, 29: 63.546, 30: 65.38, 31: 69.723, 32: 72.64, 33: 74.922,
    34: 78.96, 35: 79.904, 42: 95.96, 44: 101.07, 45: 102.906, 46: 106.42,
    47: 107.868, 48: 112.411, 50: 118.71, 51: 121.76, 52: 127.60,
    53: 126.904, 56: 137.327, 78: 195.084, 79: 196.967, 80: 200.59,
    81: 204.383, 82: 207.2, 83: 208.980,
}

# Exact (monoisotopic) masses for ExactMolWt-style descriptors
# (reference uses Descriptors.ExactMolWt in obey_lipinski — utils.py:641).
MONOISOTOPIC_MASS = {
    1: 1.007825, 5: 11.009305, 6: 12.0, 7: 14.003074, 8: 15.994915,
    9: 18.998403, 11: 22.989770, 12: 23.985042, 14: 27.976927,
    15: 30.973762, 16: 31.972071, 17: 34.968853, 19: 38.963707,
    20: 39.962591, 26: 55.934942, 29: 62.929601, 30: 63.929147,
    33: 74.921596, 34: 79.916522, 35: 78.918338, 53: 126.904473,
    78: 194.964774, 79: 196.966552, 80: 201.970626,
}

# Default-valence lists per element (ordered, smallest first), mirroring the
# common organic valence model: implicit hydrogens fill up to the smallest
# default valence >= current explicit valence.  ``None`` entries mean "no
# implicit H model" (metals etc. get 0 implicit H).
DEFAULT_VALENCES = {
    1: (1,),
    5: (3,),
    6: (4,),
    7: (3,),          # neutral N
    8: (2,),
    9: (1,),
    14: (4,),
    15: (3, 5),
    16: (2, 4, 6),
    17: (1,),
    33: (3, 5),
    34: (2, 4, 6),
    35: (1,),
    53: (1,),
}

# Elements in the SMILES "organic subset" (may appear unbracketed).
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

# Elements that may be aromatic in SMILES (lowercase forms).
AROMATIC_ELEMENTS = {5, 6, 7, 8, 15, 16, 33, 34}  # b c n o p s as se

# Pauling electronegativities for the handful of elements where descriptor
# heuristics need them.
ELECTRONEGATIVITY = {1: 2.20, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98,
                     15: 2.19, 16: 2.58, 17: 3.16, 35: 2.96, 53: 2.66}


def default_valence(atomic_num: int, explicit_valence: float, charge: int = 0) -> int | None:
    """Smallest default valence >= explicit_valence for the (possibly charged)
    atom, or None if the element has no implicit-H model.

    The charge adjustment follows the usual organic-chemistry convention:
    cations of N-group elements gain a bond slot (e.g. N+ has valence 4),
    anions of O-group lose one (e.g. O- has valence 1).
    """
    vals = DEFAULT_VALENCES.get(atomic_num)
    if vals is None:
        return None
    adjusted = []
    for v in vals:
        if atomic_num in (7, 15, 33):       # N, P, As
            adjusted.append(v + charge)
        elif atomic_num in (8, 16, 34):     # O, S, Se
            adjusted.append(v + charge)
        elif atomic_num == 6:               # C+ / C- both have 3 bonds
            adjusted.append(v - abs(charge))
        elif atomic_num == 5:               # B- has 4 bonds
            adjusted.append(v - charge)
        elif atomic_num in (9, 17, 35, 53, 1):  # halogens / H
            adjusted.append(v + (charge if charge < 0 else charge))
        else:
            adjusted.append(v)
    for v in sorted(adjusted):
        if v >= explicit_valence - 1e-9 and v >= 0:
            return v
    return None


def max_allowed_valence(atomic_num: int, charge: int = 0) -> int | None:
    """Largest allowed valence for valency checking, or None => unchecked."""
    vals = DEFAULT_VALENCES.get(atomic_num)
    if vals is None:
        return None
    top = vals[-1]
    if atomic_num in (7, 15, 33, 8, 16, 34):
        top += max(charge, 0) if charge > 0 else charge
    elif atomic_num == 6:
        top -= abs(charge)
    elif atomic_num == 5:
        top -= charge
    elif atomic_num in (9, 17, 35, 53):
        # Hypervalent halogens (e.g. ClO4-) are rare; allow up to 7 for
        # Cl/Br/I when charged or bonded to O, keep 1 for F.
        if atomic_num != 9:
            return 7
    return max(top, 0)

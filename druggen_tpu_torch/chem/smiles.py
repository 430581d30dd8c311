"""SMILES parser.

Copied from ``druggen_tpu/chem/smiles.py``; imports point at this package.

Our own replacement for RDKit's ``Chem.MolFromSmiles`` (used by the reference
at ``src/data/dataset.py:98,297`` and throughout the metrics).  Supports the
feature set needed for ChEMBL-style drug-like SMILES:

- organic-subset atoms (``B C N O P S F Cl Br I``) and their aromatic
  lowercase forms,
- bracket atoms ``[isotope?symbol@?H?+-?:class?]`` (chirality and atom-map
  parsed but discarded — the dense graph representation carries neither,
  exactly like the reference's featurizer ``src/data/dataset.py:119-159``),
- bonds ``- = # :`` plus directional ``/ \\`` (treated as single; cis/trans
  stereo is dropped),
- ring closures (single digit and ``%nn``), branches, dot-disconnections.

``mol_from_smiles`` returns ``None`` on any parse or sanitization failure
when ``strict`` (mirroring RDKit's behaviour), or raises when ``strict`` is
disabled ... inverted: pass ``raise_errors=True`` to get exceptions.
"""

from __future__ import annotations

from druggen_tpu_torch.chem import periodic
from druggen_tpu_torch.chem.mol import Atom, Bond, BondType, Mol, SanitizeError


class SmilesParseError(ValueError):
    pass


_BOND_CHARS = {
    "-": BondType.SINGLE,
    "=": BondType.DOUBLE,
    "#": BondType.TRIPLE,
    ":": BondType.AROMATIC,
    "/": BondType.SINGLE,
    "\\": BondType.SINGLE,
}

_TWO_LETTER_ORGANIC = ("Cl", "Br")
_AROMATIC_ORGANIC = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16}


def _parse_bracket_atom(s: str, i: int) -> tuple[Atom, int]:
    """Parse a bracket atom starting at ``s[i] == '['``; returns (atom, next_i)."""
    j = s.index("]", i)  # caller guarantees a closing bracket exists
    body = s[i + 1:j]
    k = 0
    n = len(body)
    # isotope
    isotope = 0
    while k < n and body[k].isdigit():
        isotope = isotope * 10 + int(body[k])
        k += 1
    if k >= n:
        raise SmilesParseError(f"empty bracket atom: [{body}]")
    # element symbol (possibly aromatic lowercase, incl. 'se'/'as')
    aromatic = False
    if body[k:k + 2] in ("se", "as"):
        sym = body[k:k + 2].capitalize()
        aromatic = True
        k += 2
    elif body[k].islower() and body[k] in "bcnops":
        sym = body[k].upper()
        aromatic = True
        k += 1
    else:
        if k + 1 < n and body[k + 1].islower() and (body[k:k + 2] in periodic.SYMBOL_TO_NUM):
            sym = body[k:k + 2]
            k += 2
        elif body[k] == "*":
            sym = "*"
            k += 1
        else:
            sym = body[k]
            k += 1
    if sym == "*":
        atomic_num = 0  # wildcard / attachment point
    else:
        atomic_num = periodic.SYMBOL_TO_NUM.get(sym)
        if atomic_num is None:
            raise SmilesParseError(f"unknown element '{sym}' in [{body}]")
    # chirality (parsed, dropped)
    while k < n and body[k] == "@":
        k += 1
        if body[k:k + 2] in ("TH", "AL", "SP", "TB", "OH"):
            k += 2
            while k < n and body[k].isdigit():
                k += 1
    # explicit hydrogens
    hcount = 0
    if k < n and body[k] == "H":
        k += 1
        hcount = 1
        num = ""
        while k < n and body[k].isdigit():
            num += body[k]
            k += 1
        if num:
            hcount = int(num)
    # charge
    charge = 0
    while k < n and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        num = ""
        while k < n and body[k].isdigit():
            num += body[k]
            k += 1
        if num:
            charge += sign * int(num)
        else:
            charge += sign
            # allow ++ / -- runs
            while k < n and body[k] == ("+" if sign > 0 else "-"):
                charge += sign
                k += 1
    # atom map class (parsed, dropped)
    if k < n and body[k] == ":":
        k += 1
        if k >= n or not body[k].isdigit():
            raise SmilesParseError(f"bad atom map in [{body}]")
        while k < n and body[k].isdigit():
            k += 1
    if k != n:
        raise SmilesParseError(f"trailing junk in bracket atom [{body}]")
    atom = Atom(atomic_num=atomic_num, charge=charge, aromatic=aromatic,
                explicit_hs=hcount, isotope=isotope)
    return atom, j + 1


def parse_smiles(smiles: str) -> Mol:
    """Parse SMILES into an **unsanitized** :class:`Mol`.

    Raises :class:`SmilesParseError` on syntax errors."""
    mol = Mol()
    if not isinstance(smiles, str):
        raise SmilesParseError("not a string")
    s = smiles.strip().split()[0] if smiles.strip() else ""
    if not s:
        raise SmilesParseError("empty SMILES")

    prev_atom: int | None = None
    pending_bond: BondType | None = None
    branch_stack: list[tuple[int | None, BondType | None]] = []
    # ring-closure table: number -> (atom_idx, bond_type_or_None)
    ring_open: dict[int, tuple[int, BondType | None]] = {}

    def close_ring(num: int, cur: int, bond_sym: BondType | None):
        if num in ring_open:
            other, obond = ring_open.pop(num)
            if other == cur:
                raise SmilesParseError(f"ring bond {num} to self")
            bt = bond_sym or obond
            if bond_sym and obond and bond_sym != obond:
                raise SmilesParseError(f"conflicting ring bond {num}")
            if bt is None:
                bt = (BondType.AROMATIC
                      if mol.atoms[other].aromatic and mol.atoms[cur].aromatic
                      else BondType.SINGLE)
            try:
                mol.add_bond(other, cur, bt)
            except ValueError as e:
                raise SmilesParseError(str(e))
        else:
            ring_open[num] = (cur, bond_sym)

    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        new_atom: Atom | None = None
        if c == "[":
            if "]" not in s[i:]:
                raise SmilesParseError("unclosed bracket")
            new_atom, i = _parse_bracket_atom(s, i)
        elif s[i:i + 2] in _TWO_LETTER_ORGANIC:
            new_atom = Atom(periodic.SYMBOL_TO_NUM[s[i:i + 2]])
            i += 2
        elif c in "BCNOPSFI":
            sym = c
            new_atom = Atom(periodic.SYMBOL_TO_NUM[sym])
            i += 1
        elif c in "bcnops":
            new_atom = Atom(_AROMATIC_ORGANIC[c], aromatic=True)
            i += 1
        elif c == "*":
            new_atom = Atom(0)
            i += 1
        elif c in _BOND_CHARS:
            if pending_bond is not None and c not in "/\\":
                raise SmilesParseError("two bond symbols in a row")
            pending_bond = _BOND_CHARS[c]
            i += 1
            continue
        elif c == "(":
            if prev_atom is None:
                raise SmilesParseError("branch with no root atom")
            branch_stack.append((prev_atom, pending_bond))
            pending_bond = None
            i += 1
            continue
        elif c == ")":
            if not branch_stack:
                raise SmilesParseError("unmatched ')'")
            prev_atom, _ = branch_stack.pop()
            pending_bond = None
            i += 1
            continue
        elif c == ".":
            prev_atom = None
            pending_bond = None
            i += 1
            continue
        elif c.isdigit() or c == "%":
            if prev_atom is None:
                raise SmilesParseError("ring closure with no atom")
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    raise SmilesParseError("bad %nn ring closure")
                num = int(s[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            close_ring(num, prev_atom, pending_bond)
            pending_bond = None
            continue
        else:
            raise SmilesParseError(f"unexpected character {c!r} at {i}")

        # we parsed an atom
        idx = mol.add_atom(new_atom)
        if prev_atom is not None:
            bt = pending_bond
            if bt is None:
                bt = (BondType.AROMATIC
                      if mol.atoms[prev_atom].aromatic and new_atom.aromatic
                      else BondType.SINGLE)
            try:
                mol.add_bond(prev_atom, idx, bt)
            except ValueError as e:
                raise SmilesParseError(str(e))
        prev_atom = idx
        pending_bond = None

    if branch_stack:
        raise SmilesParseError("unclosed branch")
    if ring_open:
        raise SmilesParseError(f"unclosed ring bonds: {sorted(ring_open)}")
    if pending_bond is not None:
        raise SmilesParseError("dangling bond")
    return mol


def mol_from_smiles(smiles: str, sanitize: bool = True,
                    raise_errors: bool = False) -> Mol | None:
    """Parse + sanitize; returns ``None`` on failure (RDKit-compatible
    contract relied on by the reference, e.g. ``src/util/utils.py:409-419``).
    """
    try:
        mol = parse_smiles(smiles)
        if sanitize:
            mol.sanitize()
        return mol
    except (SmilesParseError, SanitizeError, ValueError, IndexError):
        if raise_errors:
            raise
        return None

"""SMARTS substructure-query engine.

Copied from ``druggen_tpu/chem/smarts.py``; imports point at this package.

The reference delegates SMARTS matching to RDKit's C++ core — PAINS
filtering builds a ``FilterCatalog`` of SMARTS patterns
(``reference/src/util/utils.py:892-930``) and QED's ALERTS term
counts structural-alert SMARTS hits.  RDKit is not available here, so this
module implements the SMARTS language subset those catalogues need, from
scratch, against :class:`druggen_tpu_torch.chem.mol.Mol`:

Atom primitives
    ``*  a  A`` · organic-subset symbols (``C c N n O o S s P p B b F Cl
    Br I`` …) · ``[#n]`` atomic number · two-letter bracket elements
    (``Si``, ``Se``, ``se``, ``As``, ``Te`` …) · charge ``+ - +2 -- …`` ·
    ``H<n>``/``h<n>`` total/implicit hydrogens · ``D<n>`` degree ·
    ``X<n>`` total connections · ``v<n>`` valence · ``R``/``R0``/``R<n>``
    SSSR-ring membership · ``r``/``r<n>`` ring size · isotopes · atom maps
    (parsed, ignored) · chirality ``@``/``@@`` (parsed, ignored — the Mol
    graph carries no stereo) · recursive SMARTS ``$(...)``.

Bond primitives
    ``- = # : ~ @`` plus ``/ \\`` (matched as single bonds — no stereo),
    and the *default* bond (single-or-aromatic).

Logical operators with Daylight precedence: ``!`` > ``&``/juxtaposition >
``,`` > ``;`` — on both atom and bond expressions.  Branches, ring
closures (``1``–``9``, ``%nn``), and disconnected components (``.``) are
supported.

Matching is subgraph *monomorphism* (standard SMARTS semantics): query
atoms map injectively to molecule atoms, every query bond must map onto an
existing molecule bond satisfying its bond expression, and molecule atoms
may have additional unmatched neighbors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from druggen_tpu_torch.chem import periodic
from druggen_tpu_torch.chem.mol import BondType, Mol

__all__ = ["SmartsError", "SmartsPattern", "MolFeatures", "compile_smarts",
           "has_match", "count_pattern_hits"]


class SmartsError(ValueError):
    """Raised on a malformed or unsupported SMARTS string."""


# =====================================================================
# Expression tree
# =====================================================================

@dataclass(frozen=True)
class _Prim:
    kind: str
    value: object = None

    def __repr__(self):  # compact for debugging
        return f"{self.kind}:{self.value}"


@dataclass(frozen=True)
class _Not:
    sub: object


@dataclass(frozen=True)
class _And:
    subs: tuple


@dataclass(frozen=True)
class _Or:
    subs: tuple


_TRUE = _Prim("any")


def _eval(expr, feats: "MolFeatures", idx: int) -> bool:
    if isinstance(expr, _Prim):
        return _eval_prim(expr, feats, idx)
    if isinstance(expr, _Not):
        return not _eval(expr.sub, feats, idx)
    if isinstance(expr, _And):
        return all(_eval(s, feats, idx) for s in expr.subs)
    if isinstance(expr, _Or):
        return any(_eval(s, feats, idx) for s in expr.subs)
    raise AssertionError(expr)


def _eval_prim(p: _Prim, feats: "MolFeatures", i: int) -> bool:
    a = feats.mol.atoms[i]
    k = p.kind
    if k == "any":
        return True
    if k == "aromatic":          # 'a'
        return a.aromatic
    if k == "aliphatic":         # 'A'
        return not a.aromatic
    if k == "elem":              # (atomic_num, aromatic: bool|None)
        num, arom = p.value
        if a.atomic_num != num:
            return False
        return arom is None or a.aromatic == arom
    if k == "charge":
        return a.charge == p.value
    if k == "Htotal":
        return a.total_hs() == p.value
    if k == "himpl":
        return a.implicit_hs == p.value
    if k == "degree":
        return feats.degree(i) == p.value
    if k == "connect":
        return feats.degree(i) + a.total_hs() == p.value
    if k == "valence":
        return feats.valence(i) == p.value
    if k == "ringmem":           # None => R (in any ring); 0 => R0
        n = p.value
        if n is None:
            return feats.ring_count(i) > 0
        return feats.ring_count(i) == n
    if k == "ringsize":          # None => r (in any ring)
        n = p.value
        if n is None:
            return feats.ring_count(i) > 0
        return n in feats.ring_sizes(i)
    if k == "isotope":
        return a.isotope == p.value
    if k == "recursive":
        return feats.recursive_hit(p.value, i)
    raise AssertionError(f"unknown primitive {k}")


def _eval_bond(expr, feats: "MolFeatures", a1: int, a2: int,
               btype: BondType) -> bool:
    if isinstance(expr, _Prim):
        k = expr.kind
        if k == "b~":
            return True
        if k == "b-":
            return btype == BondType.SINGLE
        if k == "b=":
            return btype == BondType.DOUBLE
        if k == "b#":
            return btype == BondType.TRIPLE
        if k == "b:":
            return btype == BondType.AROMATIC
        if k == "b@":
            return feats.is_ring_bond(a1, a2)
        if k == "bdefault":      # single-or-aromatic
            return btype in (BondType.SINGLE, BondType.AROMATIC)
        raise AssertionError(k)
    if isinstance(expr, _Not):
        return not _eval_bond(expr.sub, feats, a1, a2, btype)
    if isinstance(expr, _And):
        return all(_eval_bond(s, feats, a1, a2, btype) for s in expr.subs)
    if isinstance(expr, _Or):
        return any(_eval_bond(s, feats, a1, a2, btype) for s in expr.subs)
    raise AssertionError(expr)


# =====================================================================
# Molecule feature cache
# =====================================================================

class MolFeatures:
    """Per-molecule derived features shared across many pattern matches.

    Build once per molecule when screening a catalogue (PAINS runs
    hundreds of patterns against each mol)."""

    def __init__(self, mol: Mol):
        self.mol = mol
        rings = mol.ring_info()
        n = mol.num_atoms()
        self._ring_count = [0] * n
        self._ring_sizes: list[set[int]] = [set() for _ in range(n)]
        self._ring_bonds: set[frozenset[int]] = set()
        for ring in rings:
            ln = len(ring)
            for pos, ai in enumerate(ring):
                self._ring_count[ai] += 1
                self._ring_sizes[ai].add(ln)
                self._ring_bonds.add(
                    frozenset((ai, ring[(pos + 1) % ln])))
        self._recursive_cache: dict[int, dict[int, bool]] = {}

    def degree(self, i: int) -> int:
        return self.mol.degree(i)

    def valence(self, i: int) -> float:
        v = self.mol.explicit_valence(i) + (
            self.mol.atoms[i].implicit_hs
            if self.mol.atoms[i].explicit_hs is None else 0)
        return v

    def ring_count(self, i: int) -> int:
        return self._ring_count[i]

    def ring_sizes(self, i: int) -> set[int]:
        return self._ring_sizes[i]

    def is_ring_bond(self, a1: int, a2: int) -> bool:
        return frozenset((a1, a2)) in self._ring_bonds

    def recursive_hit(self, pattern: "SmartsPattern", i: int) -> bool:
        cache = self._recursive_cache.setdefault(id(pattern), {})
        if i not in cache:
            cache[i] = pattern._matches_rooted(self, i)
        return cache[i]


# =====================================================================
# Parser
# =====================================================================

# two-letter aliphatic element symbols accepted inside brackets
_TWO_LETTER = {s for s in periodic.SYMBOL_TO_NUM if len(s) == 2}
# aromatic-capable lowercase symbols
_AROMATIC_SYMS = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16,
                  "se": 34, "as": 33, "te": 52, "si": 14}
# organic subset usable without brackets
_ORGANIC = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I")


class _Cursor:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def next(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def take_digits(self) -> str:
        out = ""
        while self.peek().isdigit():
            out += self.next()
        return out

    def error(self, msg: str) -> SmartsError:
        return SmartsError(f"{msg} at position {self.i} in {self.s!r}")


def _parse_bracket_atom(cur: _Cursor):
    """Parse the inside of [...] up to the closing bracket."""
    expr = _parse_expr_low(cur, _parse_atom_unary)
    if cur.next() != "]":
        raise cur.error("expected ']'")
    return expr


def _parse_expr_low(cur, unary):
    subs = [_parse_expr_mid(cur, unary)]
    while cur.peek() == ";":
        cur.next()
        subs.append(_parse_expr_mid(cur, unary))
    return subs[0] if len(subs) == 1 else _And(tuple(subs))


def _parse_expr_mid(cur, unary):
    subs = [_parse_expr_hi(cur, unary)]
    while cur.peek() == ",":
        cur.next()
        subs.append(_parse_expr_hi(cur, unary))
    return subs[0] if len(subs) == 1 else _Or(tuple(subs))


def _parse_expr_hi(cur, unary):
    subs = [_parse_unary(cur, unary)]
    while True:
        if cur.peek() == "&":
            cur.next()
            subs.append(_parse_unary(cur, unary))
            continue
        # implicit AND: another primitive follows directly
        nxt = unary(cur, probe=True)
        if nxt is None:
            break
        subs.append(nxt)
    subs = [s for s in subs if s is not None]
    return subs[0] if len(subs) == 1 else _And(tuple(subs))


def _parse_unary(cur, unary):
    if cur.peek() == "!":
        cur.next()
        return _Not(_parse_unary(cur, unary))
    got = unary(cur, probe=False)
    if got is None:
        raise cur.error("expected primitive")
    return got


def _parse_atom_unary(cur: _Cursor, probe: bool):
    """Parse one atom primitive (or None when probing and none follows)."""
    c = cur.peek()
    if c == "!":
        if probe:
            cur.next()
            return _Not(_parse_unary(cur, _parse_atom_unary))
        return None
    if c == "" or c in ";,&]":
        return None
    # isotope: leading digits inside a bracket
    if c.isdigit():
        return _Prim("isotope", int(cur.take_digits()))
    if c == "*":
        cur.next()
        return _TRUE
    if c == "#":
        cur.next()
        d = cur.take_digits()
        if not d:
            raise cur.error("expected digits after '#'")
        return _Prim("elem", (int(d), None))
    if c == "$":
        cur.next()
        if cur.next() != "(":
            raise cur.error("expected '(' after '$'")
        depth, start = 1, cur.i
        while depth:
            ch = cur.next()
            if ch == "":
                raise cur.error("unbalanced '$('")
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
        inner = cur.s[start:cur.i - 1]
        return _Prim("recursive", compile_smarts(inner))
    if c in "+-":
        sign = 1 if c == "+" else -1
        cur.next()
        d = cur.take_digits()
        if d:
            return _Prim("charge", sign * int(d))
        n = 1
        while cur.peek() == c:       # ++ / --
            cur.next()
            n += 1
        return _Prim("charge", sign * n)
    if c == "@":
        cur.next()                   # chirality: parsed, ignored
        if cur.peek() == "@":
            cur.next()
        return _TRUE
    if c == ":":
        cur.next()
        cur.take_digits()            # atom map: parsed, ignored
        return _TRUE
    # H/h/D/X/R/r/v with optional count.  NB: 'H' *followed by a lowercase
    # letter forming an element* would be Hf/He etc. — handle two-letter
    # element symbols first.
    two = c + cur.peek(1)
    if two in _TWO_LETTER and two not in ("Ho",):   # Ho is rare; prefer H
        cur.next(); cur.next()
        return _Prim("elem", (periodic.SYMBOL_TO_NUM[two], False))
    if two in _AROMATIC_SYMS and len(two) == 2 and two in ("se", "as", "te",
                                                           "si"):
        cur.next(); cur.next()
        return _Prim("elem", (_AROMATIC_SYMS[two], True))
    if c == "H":
        cur.next()
        d = cur.take_digits()
        return _Prim("Htotal", int(d) if d else 1)
    if c == "h":
        cur.next()
        d = cur.take_digits()
        return _Prim("himpl", int(d) if d else 1)
    if c == "D":
        cur.next()
        d = cur.take_digits()
        return _Prim("degree", int(d) if d else 1)
    if c == "X":
        cur.next()
        d = cur.take_digits()
        return _Prim("connect", int(d) if d else 1)
    if c == "v":
        cur.next()
        d = cur.take_digits()
        return _Prim("valence", int(d) if d else 1)
    if c == "R":
        cur.next()
        d = cur.take_digits()
        return _Prim("ringmem", int(d) if d else None)
    if c == "r":
        cur.next()
        d = cur.take_digits()
        return _Prim("ringsize", int(d) if d else None)
    if c == "a":
        cur.next()
        return _Prim("aromatic")
    if c == "A":
        cur.next()
        return _Prim("aliphatic")
    if c.isupper():
        cur.next()
        return _Prim("elem", (periodic.SYMBOL_TO_NUM.get(c) or
                              _sym_err(cur, c), False))
    if c.islower():
        if c in _AROMATIC_SYMS:
            cur.next()
            return _Prim("elem", (_AROMATIC_SYMS[c], True))
        raise cur.error(f"unknown aromatic symbol {c!r}")
    if probe:
        return None
    raise cur.error(f"unexpected {c!r} in atom expression")


def _sym_err(cur, c):
    raise cur.error(f"unknown element symbol {c!r}")


_BOND_CHARS = "-=#:~@/\\"


def _parse_bond_unary(cur: _Cursor, probe: bool):
    c = cur.peek()
    if c == "!":
        cur.next()
        return _Not(_parse_unary(cur, _parse_bond_unary))
    if c in "-/\\":
        cur.next()
        return _Prim("b-")          # stereo slashes match as single
    if c == "=":
        cur.next()
        return _Prim("b=")
    if c == "#":
        cur.next()
        return _Prim("b#")
    if c == ":":
        cur.next()
        return _Prim("b:")
    if c == "~":
        cur.next()
        return _Prim("b~")
    if c == "@":
        cur.next()
        return _Prim("b@")
    return None


def _parse_bond_expr(cur: _Cursor):
    """Parse a bond expression if one starts at the cursor; else None."""
    if cur.peek() not in _BOND_CHARS + "!":
        return None
    return _parse_expr_low(cur, _parse_bond_unary)


_DEFAULT_BOND = _Prim("bdefault")


@dataclass
class _QueryAtom:
    expr: object
    neighbors: list = field(default_factory=list)  # (other_idx, bond_expr)
    component: int = 0


class SmartsPattern:
    """A compiled SMARTS query."""

    def __init__(self, smarts: str):
        self.smarts = smarts
        self.atoms: list[_QueryAtom] = []
        self._components: list[list[int]] = []
        self._parse(smarts)
        self._plan()

    # ---------------------------------------------------------- parsing
    def _add_bond(self, i: int, j: int, expr) -> None:
        self.atoms[i].neighbors.append((j, expr))
        self.atoms[j].neighbors.append((i, expr))

    def _parse(self, s: str) -> None:
        cur = _Cursor(s)
        prev: int | None = None
        pending_bond = None
        ring: dict[str, tuple[int, object]] = {}
        stack: list[int] = []
        component = 0

        def new_atom(expr) -> int:
            idx = len(self.atoms)
            self.atoms.append(_QueryAtom(expr, component=component))
            return idx

        while cur.peek():
            c = cur.peek()
            if c == "(":
                cur.next()
                if prev is None:
                    raise cur.error("branch before any atom")
                stack.append(prev)
                continue
            if c == ")":
                cur.next()
                if not stack:
                    raise cur.error("unbalanced ')'")
                prev = stack.pop()
                continue
            if c == ".":
                cur.next()
                if pending_bond is not None:
                    raise cur.error("bond before '.'")
                prev = None
                component += 1
                continue
            bexpr = _parse_bond_expr(cur)
            if bexpr is not None:
                pending_bond = bexpr
                c = cur.peek()
            if c.isdigit() or c == "%":
                if c == "%":
                    cur.next()
                    d = cur.next() + cur.next()
                    if not d.isdigit():
                        raise cur.error("expected two digits after '%'")
                else:
                    d = cur.next()
                if prev is None:
                    raise cur.error("ring closure before any atom")
                if d in ring:
                    other, obond = ring.pop(d)
                    expr = pending_bond or obond or _DEFAULT_BOND
                    self._add_bond(prev, other, expr)
                else:
                    ring[d] = (prev, pending_bond)
                pending_bond = None
                continue
            if c == "[":
                cur.next()
                expr = _parse_bracket_atom(cur)
                idx = new_atom(expr)
            else:
                idx = None
                for sym in _ORGANIC:
                    if cur.s.startswith(sym, cur.i):
                        cur.i += len(sym)
                        idx = new_atom(
                            _Prim("elem",
                                  (periodic.SYMBOL_TO_NUM[sym], False)))
                        break
                if idx is None:
                    if c == "*":
                        cur.next()
                        idx = new_atom(_TRUE)
                    elif c == "a":
                        cur.next()
                        idx = new_atom(_Prim("aromatic"))
                    elif c == "A":
                        cur.next()
                        idx = new_atom(_Prim("aliphatic"))
                    elif c in _AROMATIC_SYMS and c in "bcnops":
                        cur.next()
                        idx = new_atom(_Prim("elem",
                                             (_AROMATIC_SYMS[c], True)))
                    else:
                        raise cur.error(f"unexpected {c!r}")
            if prev is not None:
                self._add_bond(prev, idx, pending_bond or _DEFAULT_BOND)
            pending_bond = None
            prev = idx
        if ring:
            raise SmartsError(f"unclosed ring bond(s) {sorted(ring)} "
                              f"in {s!r}")
        if stack:
            raise SmartsError(f"unbalanced '(' in {s!r}")
        if not self.atoms:
            raise SmartsError("empty SMARTS")

    # ---------------------------------------------------------- planning
    def _plan(self) -> None:
        """Order each component's atoms so that every atom after the first
        is adjacent to an earlier one (greedy connected order → the matcher
        always extends along a known bond)."""
        seen: set[int] = set()
        comps: dict[int, list[int]] = {}
        for i, qa in enumerate(self.atoms):
            comps.setdefault(qa.component, []).append(i)
        self._components = []
        for comp_atoms in comps.values():
            order: list[int] = []
            frontier = [comp_atoms[0]]
            while frontier:
                x = frontier.pop()
                if x in seen:
                    continue
                seen.add(x)
                order.append(x)
                for j, _ in self.atoms[x].neighbors:
                    if j not in seen:
                        frontier.append(j)
            for x in comp_atoms:     # a '.' inside parens could disconnect
                if x not in seen:
                    raise SmartsError(
                        "disconnected atoms within one component")
            self._components.append(order)

    # ---------------------------------------------------------- matching
    def has_match(self, mol_or_feats) -> bool:
        feats = (mol_or_feats if isinstance(mol_or_feats, MolFeatures)
                 else MolFeatures(mol_or_feats))
        return self._match_components(feats, 0, {})

    def _match_components(self, feats: MolFeatures, ci: int,
                          mapping: dict[int, int]) -> bool:
        if ci == len(self._components):
            return True
        order = self._components[ci]
        return self._extend(feats, order, 0, mapping, ci)

    def _extend(self, feats: MolFeatures, order: list[int], pos: int,
                mapping: dict[int, int], ci: int) -> bool:
        if pos == len(order):
            return self._match_components(feats, ci + 1, mapping)
        q = order[pos]
        qa = self.atoms[q]
        used = set(mapping.values())
        anchored = [(j, be) for j, be in qa.neighbors if j in mapping]
        if anchored:
            j0, _ = anchored[0]
            candidates = feats.mol.neighbors(mapping[j0])
        else:
            candidates = range(feats.mol.num_atoms())
        for m in candidates:
            if m in used:
                continue
            if not _eval(qa.expr, feats, m):
                continue
            ok = True
            for j, bexpr in anchored:
                b = feats.mol.get_bond(m, mapping[j])
                if b is None or not _eval_bond(bexpr, feats, b.a1, b.a2,
                                               b.type):
                    ok = False
                    break
            if not ok:
                continue
            mapping[q] = m
            if self._extend(feats, order, pos + 1, mapping, ci):
                del mapping[q]
                return True
            del mapping[q]
        return False

    def _matches_rooted(self, feats: MolFeatures, root: int) -> bool:
        """Recursive-SMARTS semantics: does this pattern match with its
        first atom mapped to ``root``?"""
        order = self._components[0]  # always starts at parsed atom 0
        if not _eval(self.atoms[0].expr, feats, root):
            return False
        # _extend's base case chains on to the remaining components
        return self._extend(feats, order, 1, {0: root}, 0)

    def matching_atoms(self, mol_or_feats) -> list[int]:
        """Molecule atoms that anchor a match with the pattern's FIRST
        parsed atom (RDKit ``GetSubstructMatches`` first-column analogue;
        for single-atom patterns this is exactly the matching atom set)."""
        feats = (mol_or_feats if isinstance(mol_or_feats, MolFeatures)
                 else MolFeatures(mol_or_feats))
        return [i for i in range(feats.mol.num_atoms())
                if self._matches_rooted(feats, i)]

    def __repr__(self):
        return f"SmartsPattern({self.smarts!r})"


@lru_cache(maxsize=4096)
def compile_smarts(smarts: str) -> SmartsPattern:
    return SmartsPattern(smarts)


def has_match(smarts: str, mol: Mol | MolFeatures) -> bool:
    return compile_smarts(smarts).has_match(mol)


def count_pattern_hits(patterns, mol: Mol) -> int:
    """Number of patterns with ≥1 match (RDKit ``HasSubstructMatch``
    counting, as QED's ALERTS term uses)."""
    feats = MolFeatures(mol)
    return sum(1 for p in patterns if p.has_match(feats))

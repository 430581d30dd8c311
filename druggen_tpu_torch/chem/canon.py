"""Canonical atom ranking and SMILES writer.

Copied from ``druggen_tpu/chem/canon.py``; imports point at this package.

Replacement for RDKit's ``Chem.MolToSmiles`` (reference uses it for
uniqueness/novelty bookkeeping, e.g. ``src/util/utils.py:487-500,530-547``).

Canonicalization = iterative Weisfeiler-Lehman refinement over atom
invariants with deterministic tie-breaking, then a DFS writer that emits
neighbors in canonical-rank order.  Two isomorphic graphs (with identical
atom/bond attributes) therefore produce identical strings, which is all the
uniqueness/novelty metrics require; the strings also round-trip through
:func:`druggen_tpu_torch.chem.smiles.mol_from_smiles`.
"""

from __future__ import annotations

import functools

from druggen_tpu_torch.chem import periodic
from druggen_tpu_torch.chem.mol import BondType, Mol
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def canonical_ranks(mol: Mol) -> list[int]:
    """Canonical rank per atom (0 = first/root).  Deterministic."""
    n = mol.num_atoms()
    if n == 0:
        return []
    # initial invariants
    inv: list[tuple] = []
    for i, a in enumerate(mol.atoms):
        inv.append((a.atomic_num, a.charge, int(a.aromatic), a.total_hs(),
                    mol.degree(i), int(a.in_ring), a.isotope))
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for pos, i in enumerate(order):
        if pos > 0 and inv[i] != inv[order[pos - 1]]:
            r = pos
        ranks[i] = r

    def refine(ranks: list[int]) -> list[int]:
        while True:
            keys = []
            for i in range(n):
                nbr = sorted((ranks[j], int(mol.get_bond(i, j).type))
                             for j in mol.neighbors(i))
                keys.append((ranks[i], tuple(nbr)))
            order = sorted(range(n), key=lambda i: keys[i])
            new_ranks = [0] * n
            r = 0
            for pos, i in enumerate(order):
                if pos > 0 and keys[i] != keys[order[pos - 1]]:
                    r = pos
                new_ranks[i] = r
            if new_ranks == ranks:
                return ranks
            ranks = new_ranks

    ranks = refine(ranks)
    # tie-breaking: promote the lowest-index atom of the smallest tied class
    while len(set(ranks)) < n:
        counts: dict[int, list[int]] = {}
        for i, rk in enumerate(ranks):
            counts.setdefault(rk, []).append(i)
        tied_rank = min(rk for rk, idxs in counts.items() if len(idxs) > 1)
        chosen = min(counts[tied_rank])
        # give 'chosen' a strictly smaller rank than its tied peers
        ranks = [rk if (rk != tied_rank or i == chosen) else rk + 1
                 for i, rk in enumerate(ranks)]
        ranks = refine(ranks)
    return ranks


def _needs_bracket(mol: Mol, i: int) -> bool:
    a = mol.atoms[i]
    if a.atomic_num == 0:
        return True
    sym = a.symbol
    if sym not in periodic.ORGANIC_SUBSET:
        return True
    if a.charge != 0 or a.isotope:
        return True
    if a.aromatic and a.atomic_num not in (5, 6, 7, 8, 15, 16):
        return True
    # Would the implied implicit-H count on re-parse match the true H count?
    ev = mol.explicit_valence(i) - (a.explicit_hs if a.explicit_hs is not None else 0)
    if a.aromatic and a.atomic_num == 7 and a.charge == 0:
        implied = 0 if a.total_hs() == 0 else -1  # pyridine-type n => 0 H
    else:
        dv = periodic.default_valence(a.atomic_num, ev, a.charge)
        implied = 0 if dv is None else max(int(round(dv - ev)), 0)
    return implied != a.total_hs()


def _atom_token(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    if a.atomic_num == 0:
        return "*"
    sym = a.symbol
    if a.aromatic:
        sym = sym.lower()
    if not _needs_bracket(mol, i):
        return sym
    body = ""
    if a.isotope:
        body += str(a.isotope)
    body += sym
    h = a.total_hs()
    if h == 1:
        body += "H"
    elif h > 1:
        body += f"H{h}"
    if a.charge == 1:
        body += "+"
    elif a.charge == -1:
        body += "-"
    elif a.charge > 1:
        body += f"+{a.charge}"
    elif a.charge < -1:
        body += f"-{-a.charge}"
    return f"[{body}]"


def _bond_token(mol: Mol, b) -> str:
    t = b.type
    if t == BondType.SINGLE:
        # between two aromatic atoms an unmarked bond would re-parse as
        # aromatic => emit explicit '-' (biphenyl-type linkage)
        if mol.atoms[b.a1].aromatic and mol.atoms[b.a2].aromatic:
            return "-"
        return ""
    if t == BondType.AROMATIC:
        if mol.atoms[b.a1].aromatic and mol.atoms[b.a2].aromatic:
            return ""
        return ":"
    if t == BondType.DOUBLE:
        return "="
    if t == BondType.TRIPLE:
        return "#"
    return ""


def mol_to_smiles(mol: Mol, canonical: bool = True) -> str:
    """Write SMILES.  Call on a sanitized Mol (H counts must be final).

    Two passes with the *same* recursive traversal order (root = terminal
    atom of lowest canonical rank; children visited in rank order): the
    first pass classifies tree vs ring-closure edges, the second emits
    tokens.  Keeping the orders identical guarantees closure digits open at
    the first-visited endpoint and the output stays human-typical
    (e.g. ``CCO`` rather than ``C(C)O``)."""
    n = mol.num_atoms()
    if n == 0:
        return ""
    ranks = canonical_ranks(mol) if canonical else list(range(n))

    import sys
    old_limit = sys.getrecursionlimit()

    def root_key(i: int):
        # prefer terminal atoms as the string start, then lowest rank
        return (mol.degree(i) != 1, ranks[i])

    # ---- pass 1: tree/ring classification in writer order
    tree_edges: set[frozenset[int]] = set()
    ring_edges: set[frozenset[int]] = set()
    visited = [False] * n
    comp_roots: list[int] = []
    sys.setrecursionlimit(max(old_limit, 2 * n + 100))

    def classify(i: int, parent: int | None) -> None:
        visited[i] = True
        for j in sorted(mol.neighbors(i), key=lambda j: ranks[j]):
            if j == parent:
                continue
            key = frozenset((i, j))
            if key in tree_edges or key in ring_edges:
                continue
            if visited[j]:
                ring_edges.add(key)
            else:
                tree_edges.add(key)
                classify(j, i)

    try:
        for root in sorted(range(n), key=root_key):
            if not visited[root]:
                comp_roots.append(root)
                classify(root, None)
    except Exception:
        sys.setrecursionlimit(old_limit)
        raise

    # ---- pass 2: emit
    ring_digit_of: dict[frozenset[int], int] = {}
    used_digits: set[int] = set()

    def alloc_digit() -> int:
        d = 1
        while d in used_digits:
            d += 1
        used_digits.add(d)
        return d

    visited = [False] * n
    pieces: list[str] = []

    def emit(i: int, parent: int | None) -> None:
        visited[i] = True
        pieces.append(_atom_token(mol, i))
        nbrs = sorted(mol.neighbors(i), key=lambda j: ranks[j])
        for j in nbrs:
            key = frozenset((i, j))
            if key in ring_edges:
                if key in ring_digit_of:
                    d = ring_digit_of.pop(key)
                    used_digits.discard(d)
                    tok = ""  # bond token emitted at the opening side
                else:
                    d = alloc_digit()
                    ring_digit_of[key] = d
                    tok = _bond_token(mol, mol.get_bond(i, j))
                pieces.append(f"{tok}%{d:02d}" if d > 9 else f"{tok}{d}")
        children = [j for j in nbrs
                    if frozenset((i, j)) in tree_edges and j != parent
                    and not visited[j]]
        for idx, j in enumerate(children):
            b = mol.get_bond(i, j)
            if idx != len(children) - 1:
                pieces.append("(")
                pieces.append(_bond_token(mol, b))
                emit(j, i)
                pieces.append(")")
            else:
                pieces.append(_bond_token(mol, b))
                emit(j, i)

    out_parts = []
    try:
        for root in comp_roots:
            pieces = []
            emit(root, None)
            out_parts.append("".join(pieces))
    finally:
        sys.setrecursionlimit(old_limit)
    return ".".join(out_parts)


@functools.lru_cache(maxsize=1_000_000)
def canonical_smiles(smiles: str) -> str | None:
    """Parse + sanitize + canonical write; None if invalid (the contract of
    the reference's ``canonic_smiles`` helper, ``src/util/utils.py:487-500``).

    Memoized: metric kernels (novelty, uniqueness) re-canonicalize the same
    training corpus every logging step; the cache turns that into a one-time
    cost (~60 B/entry, bounded).
    """
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    return mol_to_smiles(mol)

"""Fragment-recombination corpus builder.

The reference trains on 1.59M real ChEMBL molecules
(``reference/README.md:141-145``) — unavailable offline.  Round 2
used a procedurally-generated corpus, which measurement showed to be
chemically narrow: its 150k molecules contribute ~600 new Morgan
environments over the ~22k real reference-released molecules (see
PERF.md round-3 notes), and the GAN trained on it collapsed to small
3-atom-type outputs.

This module builds arbitrarily large corpora whose substructure
distribution comes from *real* molecules: single-point crossover on the
molecular graph.  Two parents are each cut at a random acyclic single
bond and the halves are re-joined across parents.  Because a single bond
is replaced by a single bond, valences are preserved exactly and ring
systems transfer whole, so products are valid by construction (still
re-sanitized + canonicalized, and size-capped).  The products inherit
real ring systems, functional groups, and local chemistry, with
combinatorial global diversity — the corpus analogue of BRICS
recombination.

Copied from ``druggen_tpu/data/fragmenter.py``; imports point at this package.
"""

from __future__ import annotations

import random
from dataclasses import replace

from druggen_tpu_torch.chem.canon import mol_to_smiles
from druggen_tpu_torch.chem.mol import Atom, BondType, Mol
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def cuttable_bonds(mol: Mol) -> list[int]:
    """Indices of acyclic SINGLE bonds (cutting one splits the molecule
    into two valid fragments)."""
    ring_bonds = set()
    for r in mol.ring_info():
        n = len(r)
        for i in range(n):
            ring_bonds.add(frozenset((r[i], r[(i + 1) % n])))
    out = []
    for bi, b in enumerate(mol.bonds):
        if b.type != BondType.SINGLE:
            continue
        if frozenset((b.a1, b.a2)) in ring_bonds:
            continue
        out.append(bi)
    return out


def split_at(mol: Mol, bond_idx: int) -> tuple[list[int], list[int]]:
    """Atom index sets of the two components after removing ``bond_idx``
    (the bond must be acyclic).  The first list contains the bond's a1."""
    b = mol.bonds[bond_idx]
    seen = {b.a1}
    stack = [b.a1]
    adj = mol.adj()
    while stack:
        u = stack.pop()
        for bj in adj[u]:
            if bj == bond_idx:
                continue
            v = mol.bonds[bj].other(u)
            if v not in seen:
                seen.add(v)
                stack.append(v)
    side_a = sorted(seen)
    side_b = [i for i in range(mol.num_atoms()) if i not in seen]
    return side_a, side_b


def _copy_side(dst: Mol, src: Mol, atoms: list[int],
               skip_bond: int) -> dict[int, int]:
    """Copy the sub-molecule induced by ``atoms`` into ``dst``; returns the
    old->new index map."""
    amap = {}
    for i in atoms:
        a = src.atoms[i]
        amap[i] = dst.add_atom(Atom(atomic_num=a.atomic_num,
                                    charge=a.charge, aromatic=a.aromatic,
                                    explicit_hs=a.explicit_hs,
                                    isotope=a.isotope))
    inset = set(atoms)
    for bi, b in enumerate(src.bonds):
        if bi == skip_bond:
            continue
        if b.a1 in inset and b.a2 in inset:
            dst.add_bond(amap[b.a1], amap[b.a2], b.type)
    return amap


def crossover(mol_a: Mol, mol_b: Mol, rng: random.Random,
              max_atom: int = 45, min_atom: int = 10,
              cuts_a: list[int] | None = None,
              cuts_b: list[int] | None = None,
              roundtrip_guard: bool = True) -> str | None:
    """One single-point crossover child of two parents, as canonical
    SMILES — or None when no cut exists / the child fails size or
    sanitization limits.

    ``cuts_a``/``cuts_b`` let callers pass precomputed
    :func:`cuttable_bonds` for immutable parents (the corpus builder's
    hot loop recomputes them ~2x per attempt otherwise — measured 23% of
    build time).  ``roundtrip_guard=False`` skips the defensive re-parse
    of the child SMILES (another ~30%); safe when the consumer re-parses
    anyway, as the dataset featurizer does (``data/dataset.py``
    ``featurize_smiles`` filters unparseable rows)."""
    if cuts_a is None:
        cuts_a = cuttable_bonds(mol_a)
    if cuts_b is None:
        cuts_b = cuttable_bonds(mol_b)
    if not cuts_a or not cuts_b:
        return None
    ba = rng.choice(cuts_a)
    bb = rng.choice(cuts_b)
    side_a1, _ = split_at(mol_a, ba)
    side_b1, side_b2 = split_at(mol_b, bb)
    # join A's a1-side to B's a2-side (a single bond replaces a single
    # bond at both attachment atoms: valence-exact)
    attach_a = mol_a.bonds[ba].a1
    attach_b = mol_b.bonds[bb].a2
    n_child = len(side_a1) + len(side_b2)
    if not (min_atom <= n_child <= max_atom):
        return None
    child = Mol()
    amap_a = _copy_side(child, mol_a, side_a1, ba)
    amap_b = _copy_side(child, mol_b, side_b2, bb)
    child.add_bond(amap_a[attach_a], amap_b[attach_b], BondType.SINGLE)
    try:
        child.sanitize()
        smi = mol_to_smiles(child)
    except Exception:
        return None
    # round-trip guard: the corpus must be parseable by the data pipeline
    if roundtrip_guard and mol_from_smiles(smi) is None:
        return None
    return smi


def build_corpus(parent_smiles: list[str], n: int, seed: int = 0,
                 max_atom: int = 45, min_atom: int = 10,
                 include_parents: bool = True,
                 progress_every: int = 0,
                 roundtrip_guard: bool = True) -> list[str]:
    """Generate ``n`` unique molecules by repeated crossover of real
    parents.  Deterministic given (parents, n, seed,
    roundtrip_guard)."""
    rng = random.Random(seed)
    parents: list[Mol] = []
    seen: set[str] = set()
    out: list[str] = []
    for smi in parent_smiles:
        m = mol_from_smiles(smi)
        if m is None or m.num_atoms() > max_atom:
            continue
        parents.append(m)
        if include_parents and len(out) < n:
            c = mol_to_smiles(m)
            if c not in seen:
                seen.add(c)
                out.append(c)
    if len(parents) < 2:
        raise ValueError("need at least two parseable parents")
    # parents are immutable from here: precompute their cut sites once
    parent_cuts = [cuttable_bonds(m) for m in parents]
    attempts = 0
    max_attempts = 60 * n
    while len(out) < n and attempts < max_attempts:
        attempts += 1
        ia = rng.randrange(len(parents))
        ib = rng.randrange(len(parents))
        smi = crossover(parents[ia], parents[ib], rng, max_atom=max_atom,
                        min_atom=min_atom, cuts_a=parent_cuts[ia],
                        cuts_b=parent_cuts[ib],
                        roundtrip_guard=roundtrip_guard)
        if smi is None or smi in seen:
            continue
        seen.add(smi)
        out.append(smi)
        if progress_every and len(out) % progress_every == 0:
            print(f"corpus: {len(out)}/{n} ({attempts} attempts)",
                  flush=True)
    if len(out) < n:
        raise RuntimeError(
            f"only {len(out)}/{n} unique molecules in {attempts} attempts")
    return out

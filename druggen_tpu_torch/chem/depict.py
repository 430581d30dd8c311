"""2D molecule depiction (PNG grids).

The reference renders per-sample molecule images through RDKit's drawing
code (``mols2grid_image``, ``src/util/utils.py:130-151``).  This module is
our renderer: stress-majorization 2D coordinates (Kamada-Kawai on
shortest-path distances, deterministically seeded) drawn with matplotlib —
single molecules and sample grids.

Copied from ``druggen_tpu/chem/depict.py``; imports point at this package.
"""

from __future__ import annotations

import os

import numpy as np

from druggen_tpu_torch.chem.mol import BondType, Mol


def compute_coords(mol: Mol, iters: int = 200, seed: int = 0) -> np.ndarray:
    """[N, 2] coordinates via stress majorization over graph distances."""
    n = mol.num_atoms()
    if n == 0:
        return np.zeros((0, 2))
    if n == 1:
        return np.zeros((1, 2))
    # all-pairs shortest path (BFS per atom; N <= ~100)
    dist = np.full((n, n), np.inf)
    for s in range(n):
        dist[s, s] = 0
        q = [s]
        while q:
            nq = []
            for u in q:
                for v in mol.neighbors(u):
                    if dist[s, v] == np.inf:
                        dist[s, v] = dist[s, u] + 1
                        nq.append(v)
            q = nq
    finite = np.isfinite(dist)
    dmax = dist[finite].max() if finite.any() else 1.0
    dist[~finite] = dmax + 2.0  # separate disconnected fragments

    # spectral initialization (Fiedler vectors of the graph Laplacian)
    # untangles fused-ring systems far better than a random start
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n))
    for b in mol.bonds:
        adj[b.a1, b.a2] = adj[b.a2, b.a1] = 1.0
    lap = np.diag(adj.sum(axis=1)) - adj
    try:
        _, vecs = np.linalg.eigh(lap)
        pos = vecs[:, 1:3] * np.sqrt(n)
        if pos.shape[1] < 2:
            pos = rng.standard_normal((n, 2))
    except np.linalg.LinAlgError:
        pos = rng.standard_normal((n, 2))
    pos = pos + rng.standard_normal((n, 2)) * 0.01  # break symmetry ties
    w = 1.0 / np.maximum(dist, 1e-6) ** 2
    np.fill_diagonal(w, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    for _ in range(iters):
        diff = pos[:, None, :] - pos[None, :, :]          # [n, n, 2]
        norm = np.linalg.norm(diff, axis=-1)
        np.fill_diagonal(norm, 1.0)
        target = diff / norm[:, :, None] * dist[:, :, None]
        pos = (w[:, :, None] * (pos[None, :, :] + target)).sum(axis=1) / wsum
    pos -= pos.mean(axis=0)
    return pos


_ATOM_COLORS = {6: "#222222", 7: "#2255cc", 8: "#cc2222", 9: "#22aa55",
                16: "#b8a000", 17: "#22aa55", 35: "#884400", 15: "#cc7722",
                53: "#770077"}


def draw_molecule(mol: Mol, ax=None, seed: int = 0):
    """Draw onto a matplotlib Axes (created if None).  Returns the Axes."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(3, 3))
    pos = compute_coords(mol, seed=seed)
    for b in mol.bonds:
        p1, p2 = pos[b.a1], pos[b.a2]
        d = p2 - p1
        nl = np.linalg.norm(d)
        if nl < 1e-9:
            continue
        perp = np.array([-d[1], d[0]]) / nl * 0.08
        if b.type == BondType.DOUBLE:
            for off in (-0.5, 0.5):
                ax.plot([p1[0] + off * perp[0], p2[0] + off * perp[0]],
                        [p1[1] + off * perp[1], p2[1] + off * perp[1]],
                        color="#444444", lw=1.3)
        elif b.type == BondType.TRIPLE:
            for off in (-1.0, 0.0, 1.0):
                ax.plot([p1[0] + off * perp[0], p2[0] + off * perp[0]],
                        [p1[1] + off * perp[1], p2[1] + off * perp[1]],
                        color="#444444", lw=1.1)
        elif b.type == BondType.AROMATIC:
            ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color="#444444", lw=1.5)
            ax.plot([p1[0] + perp[0], p2[0] + perp[0]],
                    [p1[1] + perp[1], p2[1] + perp[1]],
                    color="#888888", lw=0.9, linestyle=(0, (2, 2)))
        else:
            ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color="#444444", lw=1.5)
    for i, a in enumerate(mol.atoms):
        if a.atomic_num == 6 and mol.degree(i) > 0:
            continue  # skeletal convention: carbons unlabeled
        label = a.symbol if a.atomic_num else "*"
        h = a.total_hs()
        if h and a.atomic_num != 6:
            label += "H" if h == 1 else f"H{h}"
        ax.text(pos[i, 0], pos[i, 1], label, fontsize=9, ha="center",
                va="center", color=_ATOM_COLORS.get(a.atomic_num, "#555555"),
                bbox=dict(boxstyle="round,pad=0.08", fc="white", ec="none"))
    ax.set_aspect("equal")
    ax.axis("off")
    return ax


def mols_to_grid_image(mols, path: str, per_row: int = 4,
                       titles=None) -> str | None:
    """Save a grid PNG of molecules (reference mols2grid_image,
    utils.py:130-151).  None entries are skipped.  Returns the path, or
    None if nothing to draw."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    drawable = [(i, m) for i, m in enumerate(mols) if m is not None
                and m.num_atoms() > 0]
    if not drawable:
        return None
    rows = -(-len(drawable) // per_row)
    fig, axes = plt.subplots(rows, per_row,
                             figsize=(3 * per_row, 3 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for ax in axes:
        ax.axis("off")
    for ax, (i, m) in zip(axes, drawable):
        draw_molecule(m, ax=ax)
        if titles is not None and i < len(titles) and titles[i]:
            ax.set_title(str(titles[i])[:40], fontsize=7)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path

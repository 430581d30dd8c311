"""Training diagnostics (port of ``druggen_tpu/utils/diagnostics.py``).

Small parity utilities completing the reference inventory:

- :func:`grad_flow_summary` / :func:`plot_grad_flow` — per-layer gradient
  magnitudes for vanishing/exploding-gradient checks (reference
  ``plot_grad_flow``, ``src/util/utils.py:358-396``), over a module's
  ``.grad``s; rows carry the JAX package's names (``params/trunk/...``)
  for the models the weight bridge maps, so the two packages' summaries
  line up row for row.
- :func:`dense_to_sparse_with_attr` — dense adjacency -> (indices, attrs)
  (reference ``utils.py:183-202``).
- :func:`tanimoto_sim_1v2` — mean pairwise Tanimoto over aligned
  fingerprint pairs (reference ``Metrics.tanimoto_sim_1v2``,
  ``utils.py:56-75``).

The last two are copied from the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def gradient_tree(module: nn.Module):
    """``module``'s gradients (zeros where a parameter has none): the JAX
    package's variables tree for a Generator, Discriminator or SimpleDisc
    (through :mod:`..interop.weights`), else ``{torch name: grad}`` in
    parameter order (numpy leaves)."""
    from druggen_tpu_torch.interop import weights
    from druggen_tpu_torch.models.models import Discriminator, Generator, SimpleDisc

    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().float().cpu().numpy()
             for name, p in module.named_parameters()}
    bridges = ((Generator, weights.torch_generator_to_flax),
               (Discriminator, weights.torch_discriminator_to_flax),
               (SimpleDisc, weights.torch_simple_disc_to_flax))
    for kind, to_flax in bridges:
        if isinstance(module, kind):
            return to_flax(grads)
    return grads


def _leaves(tree, prefix: str = ""):
    """(name, leaf) of a variables tree in ``jax.tree_util`` order (dict
    keys sorted), names joined by "/"."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)


def grad_flow_summary(module: nn.Module) -> list[tuple[str, float, float]]:
    """[(layer_name, mean_abs, max_abs)] per non-bias parameter of
    ``module`` (after a backward)."""
    tree = gradient_tree(module)
    leaves = _leaves(tree) if "params" in tree else tree.items()
    out = []
    for name, leaf in leaves:
        if name.endswith("bias"):
            continue
        arr = np.abs(np.asarray(leaf))
        out.append((name, float(arr.mean()), float(arr.max())))
    return out


def plot_grad_flow(module: nn.Module, model_name: str, step: int,
                   out_dir: str) -> str:
    """Bar plot of per-layer mean/max gradient magnitudes (reference
    plot_grad_flow, utils.py:358-396).  Needs matplotlib, which is imported
    here and nowhere else."""
    import os

    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_grad_flow needs matplotlib, which is not "
                          "installed; grad_flow_summary gives the same numbers "
                          "without it") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rows = grad_flow_summary(module)
    names = [r[0] for r in rows]
    means = [r[1] for r in rows]
    maxes = [r[2] for r in rows]
    fig, ax = plt.subplots(figsize=(max(6, len(rows) * 0.4), 4))
    xs = np.arange(len(rows))
    ax.bar(xs, maxes, alpha=0.3, color="c", label="max-gradient")
    ax.bar(xs, means, alpha=0.6, color="b", label="mean-gradient")
    ax.set_xticks(xs)
    ax.set_xticklabels(names, rotation="vertical", fontsize=6)
    ax.set_ylabel("|grad|")
    ax.set_title(f"Gradient flow: {model_name} @ step {step}")
    ax.legend()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"gradflow_{model_name}_{step}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def dense_to_sparse_with_attr(adj: np.ndarray):
    """Dense adjacency ([N,N] or [B,N,N]) -> (indices, edge_attr), with the
    reference's batch-offset flattening for 3-D input (utils.py:183-202)."""
    adj = np.asarray(adj)
    assert adj.ndim in (2, 3)
    assert adj.shape[-1] == adj.shape[-2]
    index = np.nonzero(adj)
    edge_attr = adj[index]
    if len(index) == 3:
        batch = index[0] * adj.shape[-1]
        index = (batch + index[1], batch + index[2])
    return index, edge_attr


def tanimoto_sim_1v2(fps1: np.ndarray, fps2: np.ndarray) -> float:
    """Mean Tanimoto over aligned pairs (truncates to the shorter set)."""
    n = min(len(fps1), len(fps2))
    if n == 0:
        return 0.0
    sims = []
    for a, b in zip(fps1[:n], fps2[:n]):
        inter = float(np.sum(np.logical_and(a, b)))
        union = float(np.sum(np.logical_or(a, b)))
        sims.append(inter / union if union else 1.0)
    return float(np.mean(sims))

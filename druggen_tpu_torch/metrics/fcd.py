"""Fréchet distance between molecule-set embeddings.

Copied from ``druggen_tpu/metrics/fcd.py``; imports point at this package.

The reference's offline evaluator computes FCD with ``fcd_torch``
(ChemNet activations; ``results/evaluate.py:12,36,69-83``).  The ChemNet
weights ship via download and are unavailable offline, so this module
separates the two halves:

- :func:`frechet_distance` — the exact Fréchet/Wasserstein-2 formula
  between Gaussians fitted to two embedding sets (same math as FCD).
- a pluggable featurizer.  The default :class:`SurrogateChemNet` embeds a
  molecule as a fixed random projection (deterministic seed) of its Morgan
  fingerprint concatenated with a normalized physchem descriptor vector,
  tanh-squashed — a stand-in with ChemNet-like invariances (structure +
  property sensitivity).  Distances are comparable *within* this featurizer
  only; if real ChemNet weights are supplied via
  ``FCD(featurizer=...)`` the numbers become literal FCD.
"""

from __future__ import annotations

import numpy as np

from druggen_tpu_torch.chem.descriptors import (
    crippen_logp,
    mol_weight,
    num_aromatic_rings,
    num_h_acceptors,
    num_h_donors,
    num_rotatable_bonds,
    tpsa,
)
from druggen_tpu_torch.chem.fingerprints import morgan_fingerprint
from druggen_tpu_torch.chem.smiles import mol_from_smiles


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}) via scipy sqrtm."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


class SurrogateChemNet:
    """Deterministic molecule embedder (see module docstring)."""

    def __init__(self, out_dim: int = 256, n_bits: int = 1024, seed: int = 7):
        rng = np.random.default_rng(seed)
        self.proj = rng.standard_normal((n_bits + 8, out_dim)) / np.sqrt(
            n_bits + 8)
        self.n_bits = n_bits

    def __call__(self, smiles_list) -> np.ndarray:
        rows = []
        for s in smiles_list:
            mol = mol_from_smiles(s) if s is not None else None
            if mol is None:
                continue
            fp = morgan_fingerprint(mol, n_bits=self.n_bits).astype(np.float64)
            desc = np.array([
                mol_weight(mol) / 500.0,
                crippen_logp(mol) / 5.0,
                tpsa(mol) / 140.0,
                num_h_donors(mol) / 5.0,
                num_h_acceptors(mol) / 10.0,
                num_rotatable_bonds(mol) / 10.0,
                num_aromatic_rings(mol) / 4.0,
                mol.num_atoms() / 45.0,
            ])
            rows.append(np.tanh(np.concatenate([fp, desc]) @ self.proj))
        if not rows:
            return np.zeros((0, self.proj.shape[1]))
        return np.stack(rows)


class FCD:
    """Fréchet distance runner with the reference evaluator's call contract
    (``self.fcd(gen_smiles, ref_smiles)``, evaluate.py:76)."""

    def __init__(self, featurizer=None):
        self.featurizer = featurizer or SurrogateChemNet()

    def __call__(self, gen_smiles, ref_smiles) -> float:
        gen = self.featurizer(gen_smiles)
        ref = self.featurizer(ref_smiles)
        if len(gen) < 2 or len(ref) < 2:
            return float("nan")
        mu_g, sig_g = gen.mean(0), np.cov(gen, rowvar=False)
        mu_r, sig_r = ref.mean(0), np.cov(ref, rowvar=False)
        return frechet_distance(mu_g, sig_g, mu_r, sig_r)

"""Sample decoding + artifact dumps.

Covers the reference's per-log-step sampling machinery:
``mol_sample`` / ``save_smiles_matrices`` (``src/util/utils.py:153-238``)
and the metric block of ``logging()`` (``utils.py:241-335``).

Copied from ``druggen_tpu/utils/sampling.py``; imports point at this package.
"""

from __future__ import annotations

import os

import numpy as np

from druggen_tpu_torch.chem.canon import mol_to_smiles
from druggen_tpu_torch.chem.codec import matrices_to_mol, strip_to_largest_fragment
from druggen_tpu_torch.chem.fingerprints import morgan_fingerprint
from druggen_tpu_torch.chem.vocab import Vocab
from druggen_tpu_torch.metrics import molecular as mm


def decode_batch(node_logits, edge_logits, vocab: Vocab, strict: bool = True):
    """argmax-decode a batch of generator logits into Mols (None where
    sanitization fails) — the device->host edge of the reference hot loop
    (``utils.py:265-277``)."""
    node_labels = np.argmax(np.asarray(node_logits), axis=-1)
    edge_labels = np.argmax(np.asarray(edge_logits), axis=-1)
    mols = [matrices_to_mol(n, e, vocab, strict=strict)
            for n, e in zip(node_labels, edge_labels)]
    return mols, node_labels, edge_labels


def mols_to_smiles_list(mols) -> list[str | None]:
    return [None if m is None else mol_to_smiles(m) for m in mols]


def training_metrics(node_logits, edge_logits, real_x_labels, real_a_labels,
                     vocab: Vocab, drug_smiles: list[str],
                     drug_fps: np.ndarray, max_atom: int = 45) -> dict:
    """The reference logging() metric set (utils.py:312-335): Validity,
    Uniqueness, Novelty (vs the real batch), Novelty_drug, SNN_real,
    SNN_drug, MaxLen, Atom_types."""
    gen_mols, gen_node_labels, _ = decode_batch(node_logits, edge_logits,
                                                vocab, strict=True)
    real_mols = [matrices_to_mol(n, e, vocab, strict=True)
                 for n, e in zip(np.asarray(real_x_labels),
                                 np.asarray(real_a_labels))]
    gen_smiles = mols_to_smiles_list(gen_mols)
    gen_saves = [None if s is None else strip_to_largest_fragment(s)
                 for s in gen_smiles]
    # NOTE deviation: the reference compares largest-fragment generated
    # SMILES against *unstripped* real decodes (which keep their PAD-'*'
    # fragments), so its train-time Novelty is ~always 1.  We strip the
    # real side identically, making Novelty-vs-real-batch meaningful.
    real_smiles = [strip_to_largest_fragment(mol_to_smiles(m))
                   for m in real_mols if m is not None]

    gen_fps = np.stack([morgan_fingerprint(m) for m in gen_mols
                        if m is not None]) if any(gen_mols) else np.zeros((0, 1024), np.uint8)
    real_fps = np.stack([morgan_fingerprint(m) for m in real_mols
                         if m is not None]) if any(real_mols) else np.zeros((0, 1024), np.uint8)

    metrics = {
        "Validity": mm.fraction_valid(gen_saves),
        "Uniqueness": mm.fraction_unique(gen_saves),
        "Novelty": mm.novelty(gen_saves, real_smiles),
        "Novelty_drug": mm.novelty(gen_saves, drug_smiles),
        "SNN_real": mm.average_agg_tanimoto(real_fps, gen_fps)
        if len(gen_fps) and len(real_fps) else 0.0,
        "SNN_drug": mm.average_agg_tanimoto(drug_fps, gen_fps)
        if len(gen_fps) and len(drug_fps) else 0.0,
        "MaxLen": mm.max_component([s for s in gen_saves if s is not None],
                                   max_atom),
        "Atom_types": mm.mean_atom_type(gen_node_labels),
    }
    return metrics


def save_sample_artifacts(sample_dir: str, epoch: int, it: int,
                          node_logits, edge_logits, vocab: Vocab) -> int:
    """Dump valid samples: one txt per molecule with edge matrix, node
    matrix and SMILES (reference save_smiles_matrices, utils.py:153-181),
    plus a combined samples.smi.  Returns the number of valid samples."""
    mols, node_labels, edge_labels = decode_batch(node_logits, edge_logits,
                                                  vocab, strict=True)
    out_dir = os.path.join(sample_dir, f"{epoch + 1}_{it + 1}-epoch_iteration")
    n_valid = 0
    lines = []
    for i, m in enumerate(mols):
        if m is None:
            continue
        smi = mol_to_smiles(m)
        if not smi:
            continue
        n_valid += 1
        smi_clean = strip_to_largest_fragment(smi)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{i + 1}.txt"), "w") as f:
            f.write("edge matrix:\n")
            np.savetxt(f, edge_labels[i], fmt="%d")
            f.write("\nnode matrix:\n")
            np.savetxt(f, node_labels[i], fmt="%d")
            f.write(f"\nsmiles:\n{smi}\n")
        lines.append(smi_clean)
    if lines:
        with open(os.path.join(out_dir, "samples.smi"), "w") as f:
            f.write("\n".join(lines) + "\n")
        # grid PNG of the valid samples (reference mols2grid_image,
        # utils.py:130-151)
        try:
            from druggen_tpu_torch.chem.depict import mols_to_grid_image

            mols_to_grid_image([m for m in mols if m is not None],
                               os.path.join(out_dir, "samples.png"),
                               titles=lines)
        except Exception as e:  # rendering must never kill training
            print(f"sample grid rendering skipped: {e}")
    return n_valid

"""The port's copies of the descriptor and report-metric modules against the
JAX package's, on the CPU.

On 200 corpus molecules QED, SA, Crippen logP and the QED alert count, and
their means, equal the JAX package's exactly; the canonical sets (serial,
in a two-worker pool, and through the disk cache), ``remove_invalid`` and
the internal diversity equal JAX's (Tanimoto sums to 1e-6).  No model runs.
"""

import os

import numpy as np
import pytest
import torch

from druggen_tpu.chem import descriptors as jax_descriptors
from druggen_tpu.chem.fingerprints import fingerprints_for_smiles as jax_fps
from druggen_tpu.chem.smiles import mol_from_smiles as jax_mol_from_smiles
from druggen_tpu.metrics import descriptor_metrics as jax_dm
from druggen_tpu.metrics import molecular as jax_mm
from druggen_tpu_torch.chem import descriptors
from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.metrics import descriptor_metrics as dm
from druggen_tpu_torch.metrics import molecular as mm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMILES_FILE = os.path.join(REPO, "data", "chembl_like_150k.smi")
N_MOLECULES = 200
# two strings that do not parse and one salt, so that the filters have work
ODD = ["C1CC", "c1cccc1X", "CC(=O)[O-].[Na+]"]


@pytest.fixture(scope="module")
def corpus():
    with open(SMILES_FILE) as f:
        smiles = [line.split()[0] for _, line in zip(range(N_MOLECULES), f)]
    return smiles + ODD


@pytest.fixture(scope="module")
def mols(corpus):
    pairs = [(mol_from_smiles(s), jax_mol_from_smiles(s)) for s in corpus]
    assert all((p is None) == (j is None) for p, j in pairs)
    pairs = [(p, j) for p, j in pairs if p is not None]
    assert len(pairs) >= N_MOLECULES
    return pairs


@pytest.mark.parametrize("name", ["qed", "sa_score", "crippen_logp", "count_alerts"])
def test_descriptor_equals_jax(mols, name):
    port_fn, jax_fn = getattr(descriptors, name), getattr(jax_descriptors, name)
    got = [port_fn(p) for p, _ in mols]
    want = [jax_fn(j) for _, j in mols]
    assert got == want
    assert len(set(got)) > 2      # the values vary over the sample


@pytest.mark.parametrize("name", ["mean_qed", "mean_sa"])
def test_mean_descriptor_equals_jax(corpus, name):
    got = getattr(dm, name)(corpus + [None])
    assert got == getattr(jax_dm, name)(corpus + [None])
    assert got > 0


@pytest.mark.parametrize("mode", ["serial", "pool", "cache"])
def test_canonical_set_equals_jax(corpus, tmp_path, mode):
    want = jax_mm.canonical_set(corpus)
    assert None not in want and len(want) >= N_MOLECULES
    if mode == "serial":
        assert mm.canonical_set(corpus) == want
    elif mode == "pool":
        assert mm.canonical_set(corpus, n_jobs=2) == want
    else:
        src = tmp_path / "corpus.smi"
        src.write_text("\n".join(corpus) + "\n")
        assert mm.canonical_set(corpus, cache_for=str(src)) == want
        cached = list((tmp_path / "cache").glob("canon_corpus_*.txt"))
        assert len(cached) == 1
        # the second call reads the port's cache file, which JAX reads too
        assert mm.canonical_set([], cache_for=str(src)) == want
        assert jax_mm.canonical_set([], cache_for=str(src)) == want


@pytest.mark.parametrize("canonize", [True, False])
def test_remove_invalid_equals_jax(corpus, canonize):
    got = mm.remove_invalid(corpus, canonize=canonize)
    assert got == jax_mm.remove_invalid(corpus, canonize=canonize)
    assert len(got) == len(corpus) - 2


def test_internal_diversity_equals_jax(corpus):
    fps = fingerprints_for_smiles(corpus)
    np.testing.assert_array_equal(fps, jax_fps(corpus))
    got = mm.average_agg_tanimoto(fps, fps[:50], agg="mean", intdiv=True)
    want = jax_mm.average_agg_tanimoto(fps, fps[:50], agg="mean", intdiv=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mean, std = mm.internal_diversity(fps)
    jax_mean, jax_std = jax_mm.internal_diversity(fps)
    assert mean == pytest.approx(jax_mean, abs=1e-6) and 0 < mean < 1
    assert std == pytest.approx(jax_std, abs=1e-6)
    assert mm.average_agg_tanimoto(fps[:30], fps) == pytest.approx(
        jax_mm.average_agg_tanimoto(fps[:30], fps), abs=1e-6)

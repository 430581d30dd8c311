"""Package rules and copied host modules of the PyTorch port.

The port imports nothing of JAX, flax, msgpack or the JAX package (an AST
scan of every module and of chip_smoke.py); its copies of the JAX package's
pure-Python chemistry and data modules behave exactly like the originals.
"""

import ast
import dataclasses
import os
import re

import numpy as np
import pytest

from druggen_tpu.chem import canon as jax_canon
from druggen_tpu.chem import codec as jax_codec
from druggen_tpu.chem import vocab as jax_vocab
from druggen_tpu.data import dataset as jax_dataset
from druggen_tpu.data.corpus import DRUGLIKE_SMILES
from druggen_tpu_torch.chem import canon, codec, vocab
from druggen_tpu_torch.data import dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "druggen_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "druggen_tpu")
# a citation of the reference repository by an absolute path
ABSOLUTE_REFERENCE = re.compile(r"``/\w+/reference/")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources())
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_whole_package():
    paths = _port_sources()
    assert "chip_smoke.py" in paths
    assert "druggen_tpu_torch/ops/fused_mlp.py" in paths
    assert "druggen_tpu_torch/ops/fused_attention.py" in paths
    assert "druggen_tpu_torch/ops/fused_block.py" in paths
    assert "druggen_tpu_torch/ops/fused_generator.py" in paths
    assert "druggen_tpu_torch/models/layers.py" in paths
    assert "druggen_tpu_torch/infer/engine.py" in paths
    assert "druggen_tpu_torch/train/trainer.py" in paths
    assert "druggen_tpu_torch/train/__main__.py" in paths
    for module in ("native/__init__.py", "metrics/chemnet.py", "metrics/fcd.py",
                   "metrics/frag_scaf.py", "chem/scaffolds.py", "evaluate.py",
                   "select_checkpoint.py"):
        assert f"druggen_tpu_torch/{module}" in paths


@pytest.mark.parametrize("name", ["periodic", "mol", "smiles", "canon", "codec",
                                  "fingerprints", "depict", "smarts", "crippen",
                                  "alerts", "descriptors", "pains", "filters",
                                  "scaffolds"])
def test_chem_copies_are_verbatim(name):
    """The copies differ from the originals only by the import paths and
    the one-line note naming the original."""
    _assert_verbatim_copy("chem", name)


@pytest.mark.parametrize("name", ["sampling", "logging", "prefetch"])
def test_utils_copies_are_verbatim(name):
    _assert_verbatim_copy("utils", name)


@pytest.mark.parametrize("package, name", [
    ("data", "corpus"), ("metrics", "parallel_map"),
    ("metrics", "descriptor_metrics"), ("metrics", "__init__"),
    ("metrics", "frag_scaf"), ("metrics", "fcd")])
def test_data_and_metrics_copies_are_verbatim(package, name):
    _assert_verbatim_copy(package, name)


def test_native_source_is_byte_equal():
    """The port builds the JAX package's chem kernel source, byte for byte."""
    with open(os.path.join(REPO, "druggen_tpu", "native", "chem.cpp"), "rb") as f:
        orig = f.read()
    with open(os.path.join(PORT, "native", "chem.cpp"), "rb") as f:
        assert f.read() == orig


def _assert_verbatim_copy(package, name):
    """Equal but for the note, the import paths and the reference
    repository's path, which the copies cite relative to the checkouts
    (``reference/...``) where the originals give it absolute."""
    orig = open(os.path.join(REPO, "druggen_tpu", package, f"{name}.py")).read()
    copy = open(os.path.join(PORT, package, f"{name}.py")).read()
    note = (f"\n\nCopied from ``druggen_tpu/{package}/{name}.py``; imports "
            "point at this package.")
    assert note in copy
    assert not ABSOLUTE_REFERENCE.search(copy)
    copy = copy.replace(note, "", 1).replace("druggen_tpu_torch.", "druggen_tpu.")
    assert copy == ABSOLUTE_REFERENCE.sub("``reference/", orig)


def test_train_config_is_the_jax_one_plus_device():
    from druggen_tpu.config import TrainConfig as JaxTrainConfig
    from druggen_tpu_torch.config import TrainConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields


def test_training_metrics_match():
    """The training-cadence metrics of the port (torch Tanimoto matmul) equal
    the JAX package's on the same decoded batch."""
    from druggen_tpu.chem.fingerprints import fingerprints_for_smiles as jax_fps
    from druggen_tpu.utils.sampling import training_metrics as jax_metrics
    from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles
    from druggen_tpu_torch.utils.sampling import training_metrics

    jv, pv = _vocab_pair()
    jd = jax_dataset.featurize_smiles(DRUGLIKE_SMILES, jv, 45, use_native=False)
    pd = dataset.featurize_smiles(DRUGLIKE_SMILES, pv, 45)
    # logits that decode to real molecules of the corpus, two of them perturbed
    rng = np.random.default_rng(0)
    node_logits = 4.0 * np.eye(pv.m_dim, dtype=np.float32)[pd.x[8:16]]
    edge_logits = 4.0 * np.eye(pv.b_dim, dtype=np.float32)[pd.a[8:16]]
    node_logits[:2] += rng.normal(size=node_logits[:2].shape).astype(np.float32) * 3
    drugs = DRUGLIKE_SMILES[:20]
    got = training_metrics(node_logits, edge_logits, pd.x[:8], pd.a[:8], pv,
                           drugs, fingerprints_for_smiles(drugs))
    ref = jax_metrics(node_logits, edge_logits, jd.x[:8], jd.a[:8], jv, drugs,
                      jax_fps(drugs))
    assert got.keys() == ref.keys() and got["Validity"] > 0.5
    assert 0 < got["SNN_drug"] < 1
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-6, abs=1e-9), key


def _vocab_pair():
    return (jax_vocab.build_vocab(DRUGLIKE_SMILES, 45, use_native=False),
            vocab.build_vocab(DRUGLIKE_SMILES, 45))


def test_vocab_matches():
    j, p = _vocab_pair()
    assert (p.atom_labels, p.bond_labels) == (j.atom_labels, j.bond_labels)
    assert vocab.CHEMBL_VOCAB.to_json() == jax_vocab.CHEMBL_VOCAB.to_json()


def test_featurize_decode_and_canon_match():
    jv, pv = _vocab_pair()
    jd = jax_dataset.featurize_smiles(DRUGLIKE_SMILES, jv, 45, use_native=False)
    pd = dataset.featurize_smiles(DRUGLIKE_SMILES, pv, 45)
    assert pd.smiles == jd.smiles and len(pd) > 10
    np.testing.assert_array_equal(pd.x, jd.x)
    np.testing.assert_array_equal(pd.a, jd.a)
    decoded = 0
    for i in range(len(pd)):
        pm = codec.matrices_to_mol(pd.x[i], pd.a[i], pv, strict=True)
        jm = jax_codec.matrices_to_mol(jd.x[i], jd.a[i], jv, strict=True)
        assert (pm is None) == (jm is None)
        if pm is not None:
            decoded += 1
            assert canon.mol_to_smiles(pm) == jax_canon.mol_to_smiles(jm)
    assert decoded > len(pd) // 2
    assert codec.strip_to_largest_fragment("C*C.O") == "CCC"


def test_batch_iterator_matches():
    jv, pv = _vocab_pair()
    jd = jax_dataset.featurize_smiles(DRUGLIKE_SMILES, jv, 45, use_native=False)
    pd = dataset.featurize_smiles(DRUGLIKE_SMILES, pv, 45)
    jit = iter(jax_dataset.BatchIterator(jd, 4, seed=3, loop=True))
    pit = iter(dataset.BatchIterator(pd, 4, seed=3, loop=True))
    for _ in range(2 * len(pd) // 4 + 1):     # across an epoch boundary
        (jx, ja), (px, pa) = next(jit), next(pit)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(pa, ja)


def test_load_dataset_cache_round_trip(tmp_path):
    _, pv = _vocab_pair()
    raw = tmp_path / "corpus.smi"
    raw.write_text("\n".join(DRUGLIKE_SMILES) + "\n")
    first = dataset.load_dataset(str(raw), pv, 45, str(tmp_path))
    assert (tmp_path / "corpus45.npz").exists()
    again = dataset.load_dataset(str(raw), pv, 45, str(tmp_path))
    np.testing.assert_array_equal(again.x, first.x)
    assert again.smiles == first.smiles

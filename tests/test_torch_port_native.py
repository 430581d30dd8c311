"""The port's native chem kernel (``druggen_tpu_torch/native``) on the CPU.

Its featurizer and vocabulary scan are bit-equal to the port's Python path
and to the JAX package's Python path on the corpus molecules, the edge cases
of ``tests/test_native.py`` and the first 2,000 molecules of
``data/chembl_like_150k.smi``; the batch output does not depend on the
thread count; a build that cannot run or fails raises with the compiler's
output instead of falling back to Python.
"""

import os
import stat

import numpy as np
import pytest

from druggen_tpu.chem import vocab as jax_vocab
from druggen_tpu.data import dataset as jax_dataset
from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, generate_corpus
from druggen_tpu_torch import native
from druggen_tpu_torch.chem import vocab
from druggen_tpu_torch.chem.codec import smiles_to_matrices
from druggen_tpu_torch.data import dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ATOM = 45
# tests/test_native.py's edge cases: rejected inputs, a bracket charge, a
# triple bond, an over-size chain
INVALID = ["", "((((", "C1CC", "[Xx]", "garbage", "C=#C", "cc"]
EDGE = INVALID + ["C#N", "[O-]C(=O)C", "C" * 60, "c1ccccc1"]


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(REPO, "data", "chembl_like_150k.smi")) as f:
        head = [line.split()[0] for _, line in zip(range(2000), f)]
    return DRUGLIKE_SMILES + TARGET_SMILES + EDGE + head


@pytest.fixture(scope="module")
def vocabs(corpus):
    return (vocab.build_vocab(corpus, MAX_ATOM),
            vocab.build_vocab(corpus, MAX_ATOM, use_native=False),
            jax_vocab.build_vocab(corpus, MAX_ATOM, use_native=False))


def test_vocab_scan_matches_both_python_paths(corpus, vocabs):
    native_v, python_v, jax_v = vocabs
    assert native_v == python_v
    assert (native_v.atom_labels, native_v.bond_labels) == (jax_v.atom_labels,
                                                            jax_v.bond_labels)
    # the scan honours max_atom: a small cap drops the big molecules' labels
    small = [vocab.build_vocab(corpus, 8, use_native=flag) for flag in (True, False)]
    assert small[0] == small[1]
    assert small[0].atom_labels == jax_vocab.build_vocab(corpus, 8, use_native=False).atom_labels


def test_featurizer_matches_both_python_paths(corpus, vocabs):
    v = vocabs[0]
    got = dataset.featurize_smiles(corpus, v, MAX_ATOM)
    python = dataset.featurize_smiles(corpus, v, MAX_ATOM, use_native=False)
    jax = jax_dataset.featurize_smiles(corpus, vocabs[2], MAX_ATOM, use_native=False)
    assert len(got) > 1900
    for ref in (python, jax):
        assert got.smiles == ref.smiles
        np.testing.assert_array_equal(got.x, ref.x)
        np.testing.assert_array_equal(got.a, ref.a)
    assert got.x.dtype == np.int8 and got.a.dtype == np.int8


def test_single_molecule_api(vocabs):
    v = vocabs[0]
    for s in DRUGLIKE_SMILES + EDGE:
        py = smiles_to_matrices(s, v, MAX_ATOM)
        cc = native.featurize_smiles_native(s, v, MAX_ATOM)
        assert (py is None) == (cc is None), s
        if py is not None:
            np.testing.assert_array_equal(cc[0], py[0])
            np.testing.assert_array_equal(cc[1], py[1])
    for bad in INVALID:
        assert native.featurize_smiles_native(bad, v, MAX_ATOM) is None


def test_batch_is_deterministic_across_thread_counts(vocabs):
    mols = generate_corpus(200, seed=3) + INVALID
    runs = [native.featurize_batch_native(mols, vocabs[0], MAX_ATOM, n_threads=t)
            for t in (1, 3, 8)]
    for x, a, kept in runs[1:]:
        assert kept == runs[0][2]
        np.testing.assert_array_equal(x, runs[0][0])
        np.testing.assert_array_equal(a, runs[0][1])
    scans = {tuple(map(tuple, native.vocab_scan_native(mols, MAX_ATOM, n_threads=t)))
             for t in (1, 8)}
    assert len(scans) == 1


def test_load_dataset_goes_native(tmp_path, vocabs, monkeypatch):
    raw = tmp_path / "corpus.smi"
    raw.write_text("\n".join(DRUGLIKE_SMILES + INVALID[1:]) + "\n")
    ref = dataset.featurize_smiles(DRUGLIKE_SMILES + INVALID[1:], vocabs[0], MAX_ATOM,
                                   use_native=False)

    def python_path(*args):
        raise AssertionError("load_dataset took the Python featurizer")

    monkeypatch.setattr(dataset, "smiles_to_matrices", python_path)
    data = dataset.load_dataset(str(raw), vocabs[0], MAX_ATOM, str(tmp_path),
                                use_cache=False)
    assert data.smiles == ref.smiles
    np.testing.assert_array_equal(data.a, ref.a)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_a_missing_compiler_raises(fresh_build, monkeypatch, vocabs):
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        dataset.featurize_smiles(DRUGLIKE_SMILES, vocabs[0], MAX_ATOM)
    with pytest.raises(RuntimeError, match="cannot run"):
        vocab.build_vocab(DRUGLIKE_SMILES, MAX_ATOM)
    with pytest.raises(RuntimeError):
        native.available()
    # the Python path is the explicit way round it
    assert len(dataset.featurize_smiles(DRUGLIKE_SMILES, vocabs[0], MAX_ATOM,
                                        use_native=False)) > 10


def test_a_failed_build_raises_with_the_compilers_output(fresh_build, monkeypatch):
    fake = fresh_build / "cxx"
    fake.write_text("#!/bin/sh\necho 'chem.cpp:1: error: broken toolchain' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*broken toolchain"):
        native.build()
    assert not list((fresh_build / "_build").glob("*.so*"))


def test_the_build_is_keyed_by_compiler_and_machine(monkeypatch):
    monkeypatch.setenv("CXX", "g++")
    default = native.library_path()
    monkeypatch.setenv("CXX", "clang++")
    assert native.library_path() != default
    monkeypatch.setenv("CXX", "g++")
    monkeypatch.setattr(native.platform, "machine", lambda: "aarch64")
    assert native.library_path() != default
    assert default.parent == native.BUILD_DIR and default.name.startswith("libdruggen_chem-")

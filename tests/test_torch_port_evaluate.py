"""The port's offline evaluator (``python -m druggen_tpu_torch.evaluate``)
against the JAX package's ``evaluate.py``, on the CPU.

Both evaluate the same small files (written with ``data.corpus.
write_corpus``), with and without ``--ref1-sample``, with the surrogate FCD
and with a random-init ChemNet saved as ``.npz``: the unrounded results are
equal, key for key and in the same order, exactly but for the ChemNet FCD
(rtol 1e-3); with the surrogate the JSON and CSV files are byte-equal.  The
workers the evaluator forks (``--n-jobs``) import nothing of torch, so a
fork after ChemNet has made its CUDA context is safe.
"""

import ast
import math
import os

import pytest
import torch

import evaluate as jax_evaluate
from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, generate_corpus, write_corpus
from druggen_tpu.metrics.chemnet import ChemNet
from druggen_tpu_torch import evaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHEMNET_CONFIG = [
    {"type": "conv", "filters": 8, "kernel": 5, "activation": "selu"},
    {"type": "conv", "filters": 12, "kernel": 4, "activation": "selu"},
    {"type": "lstm", "units": 16, "return_sequences": True},
    {"type": "lstm", "units": 8, "return_sequences": False},
]
GEN = generate_corpus(24, seed=5) + DRUGLIKE_SMILES[:4] + ["garbage", "C1CC"]
REF1 = DRUGLIKE_SMILES[:30] + generate_corpus(16, seed=1)
REF2 = TARGET_SMILES + DRUGLIKE_SMILES[40:44]


def _write_inputs(d, csv: bool):
    d.mkdir()
    gen = d / ("gen.csv" if csv else "gen.smi")
    write_corpus(str(gen), (["SMILES"] if csv else []) + GEN)
    write_corpus(str(d / "ref1.smi"), REF1)
    write_corpus(str(d / "ref2.smi"), REF2)
    return str(gen), str(d / "ref1.smi"), str(d / "ref2.smi")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chemnet") / "chemnet.npz")
    ChemNet.random_init(7, CHEMNET_CONFIG).save_npz(path)
    return path


def _same(got, want, rel):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if rel:
        return got == pytest.approx(want, rel=rel)
    return got == want


@pytest.mark.parametrize("chemnet,ref1_sample,n_jobs", [(False, 0, 2), (True, 30, 1)])
def test_report_equals_jax(tmp_path, weights, chemnet, ref1_sample, n_jobs):
    """``n_jobs``: the port's workers (the JAX side runs serially; the pool
    changes no value)."""
    kwargs = dict(chemnet_weights=weights if chemnet else None,
                  ref1_sample=ref1_sample, ref1_sample_seed=3)
    csv = ref1_sample > 0
    jax_files = _write_inputs(tmp_path / "jax", csv)
    port_files = _write_inputs(tmp_path / "port", csv)
    want = jax_evaluate.evaluate_molecules_from_files(
        *jax_files, output_prefix=str(tmp_path / "jax" / "out"), n_jobs=1, **kwargs)
    got = evaluate.evaluate_molecules_from_files(
        *port_files, output_prefix=str(tmp_path / "port" / "out"), n_jobs=n_jobs,
        device="cpu", **kwargs)
    assert list(got) == list(want)
    assert got["fcd_is_literal"] is chemnet
    assert got["n_reference_1_kernel_sample"] == (ref1_sample or len(REF1))
    for key, value in want.items():
        rel = 1e-3 if chemnet and key.startswith("fcd_ref") else 0
        assert _same(got[key], value, rel), (key, got[key], value)
    assert 0 < got["validity"] < 1 and math.isfinite(got["fcd_ref1"])
    if not chemnet:
        for ext in (".json", ".csv"):
            assert ((tmp_path / "port" / f"out{ext}").read_bytes()
                    == (tmp_path / "jax" / f"out{ext}").read_bytes())


def test_cli_writes_the_report_and_times_each_part(tmp_path, weights, monkeypatch):
    gen, ref1, ref2 = _write_inputs(tmp_path / "in", csv=False)
    evaluators = []
    init = evaluate.MoleculeEvaluator.__init__

    def keep(self, *args, **kwargs):
        evaluators.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(evaluate.MoleculeEvaluator, "__init__", keep)
    results = evaluate.main(["--gen", gen, "--ref1", ref1, "--ref2", ref2,
                             "--output", str(tmp_path / "res.json"), "--n-jobs", "1",
                             "--chemnet-weights", weights,
                             "--device", "cpu"])
    assert results["fcd_is_literal"] is True
    assert (tmp_path / "res.json").exists() and (tmp_path / "res.csv").exists()
    assert list(evaluators[0].seconds) == ["basic", "property", "frechet", "similarity",
                                           "drug-likeness"]
    assert evaluators[0].device == torch.device("cpu")


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    gen, ref1, _ = _write_inputs(tmp_path / "in", csv=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--gen", gen, "--ref1", ref1, "--output", str(tmp_path / "r"),
                       "--n-jobs", "1"])


def _port_imports(module: str) -> set[str]:
    """Every module (and top-level package) that ``module`` imports, at any
    depth through the port's own modules, function bodies included."""
    seen, todo, roots = set(), [module], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = os.path.join(REPO, *name.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *name.split("."), "__init__.py")
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for imported in names:
                roots.add(imported.split(".")[0])
                if imported.startswith("druggen_tpu_torch."):
                    todo.append(imported)
    return roots


def test_forked_workers_import_no_torch():
    """``parallel_map``'s workers are forked after ChemNet and the IntDiv
    products have used the card; nothing they import touches torch."""
    roots = _port_imports("druggen_tpu_torch.metrics.parallel_map")
    assert "druggen_tpu_torch" in roots and "torch" not in roots
    assert "torch" in _port_imports("druggen_tpu_torch.evaluate")   # the scan sees torch

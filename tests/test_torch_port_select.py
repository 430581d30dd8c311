"""The port's checkpoint selector (``python -m
druggen_tpu_torch.select_checkpoint``) against the JAX package's
``scripts/select_checkpoint.py``, on the CPU.

A model directory holds three cadence G exports at the interop sizes (dim
32, depth 2, 4 heads, N 9 on small corpus molecules), written with the
port's msgpack writer from perturbed copies of one parameter set, one of
them in the stacked ``scan_layers`` layout, and no ``DrugGEN-G.ckpt``.  Both
selectors run the screen and a finalist phase in f32 over the same batches
(shuffle seed 42, ``max_batches``): ``selection.json`` is equal, rows,
ranking and finalists.  Also: the stacked export loads as the unrolled one,
and the engine's weight swap serves the new weights, through the modules
and through K9's plain version (``use_pallas``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from druggen_tpu.models.layers import stack_block_params
from druggen_tpu_torch import select_checkpoint
from druggen_tpu_torch.chem.vocab import build_vocab, read_smiles_file
from druggen_tpu_torch.config import InferenceConfig
from druggen_tpu_torch.data.dataset import featurize_smiles
from druggen_tpu_torch.infer.engine import InferenceEngine
from druggen_tpu_torch.interop.weights import torch_generator_to_flax
from druggen_tpu_torch.models import Generator
from druggen_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_interop.py's sizes: dim 32, 4 heads, depth 2, mlp_ratio
# 3, N 9, a batch of 3
DIM, HEADS, DEPTH, MLP_RATIO, N, BATCH = 32, 4, 2, 3, 9, 3
CKPTS = ("0-8-G.ckpt", "0-16-G.ckpt", "1-24-G.ckpt")
STACKED = "0-16-G.ckpt"


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("select")
    with open(os.path.join(REPO, "data", "chembl_like_150k.smi")) as f:
        head = [line.split()[0] for _, line in zip(range(20000), f)]
    small = featurize_smiles(head, build_vocab(head, N), N).smiles
    (tmp / "inf.smi").write_text("\n".join(small[:96]) + "\n")
    (tmp / "drugs.smi").write_text("\n".join(small[200:240]) + "\n")
    vocab = build_vocab(read_smiles_file(str(tmp / "inf.smi"))
                        + read_smiles_file(str(tmp / "drugs.smi")), N)
    torch.manual_seed(0)
    G = Generator(act="relu", vertexes=N, edges=vocab.b_dim, nodes=vocab.m_dim,
                  dropout=0.0, dim=DIM, depth=DEPTH, heads=HEADS, mlp_ratio=MLP_RATIO)
    base = G.state_dict()
    rng = np.random.default_rng(0)
    models = tmp / "models"
    models.mkdir()
    for name in CKPTS:
        sd = {k: v + torch.from_numpy(0.3 * rng.standard_normal(v.shape).astype(np.float32))
              for k, v in base.items()}
        tree = torch_generator_to_flax(sd)
        if name == STACKED:
            tree = stack_block_params(tree)
        checkpoint.save_params(str(models / name), tree)
    return tmp


def _argv(tmp, output):
    return ["--model_dir", str(tmp / "models"), "--inf_smiles", str(tmp / "inf.smi"),
            "--train_smiles", str(tmp / "inf.smi"),
            "--train_drug_smiles", str(tmp / "drugs.smi"),
            "--sample_num", "12", "--inf_batch_size", str(BATCH), "--dim", str(DIM),
            "--depth", str(DEPTH), "--heads", str(HEADS), "--max_atom", str(N),
            "--compute_dtype", "float32", "--finalists", "2",
            "--finalist_samples", "18", "--output", str(output)]


def _jit_template_engine(cfg, first_ckpt_path):
    """The JAX tool's ``_build_engine`` with its template made by one jitted
    ``init`` instead of an eager one (one compile, not ~130; the template's
    values are all replaced by the checkpoint's)."""
    import jax
    import jax.numpy as jnp

    from druggen_tpu.infer.engine import InferenceEngine as JaxInferenceEngine
    from druggen_tpu.train import checkpoint as jax_checkpoint

    eng = JaxInferenceEngine(cfg, g_params="__pending__")
    template = jax.jit(eng.G.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, eng.vertexes, eng.vertexes, eng.b_dim)),
        jnp.zeros((1, eng.vertexes, eng.m_dim)))
    eng.g_params = jax_checkpoint.load_params_auto(first_ckpt_path, template)
    return eng


@pytest.fixture(scope="module")
def selections(run_dir):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import select_checkpoint as jax_select
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_select, "_build_engine", _jit_template_engine)
        jax_select.main(_argv(run_dir, run_dir / "jax.json"))
    port, seconds = select_checkpoint.main(
        _argv(run_dir, run_dir / "port.json") + ["--device", "cpu"])
    return (json.loads((run_dir / "jax.json").read_text()),
            json.loads((run_dir / "port.json").read_text()), port, seconds)


def test_selection_equals_jax(selections):
    jax, port, returned, _ = selections
    assert port == jax
    assert returned == port
    assert [r["ckpt"] for r in port["rows"]] == list(CKPTS)
    assert len(port["finalists"]) == 2 and port["ranked"][0]["score"] > 0
    # the rows differ, so the ranking is a real one
    assert len({r["score"] for r in port["rows"]}) == len(CKPTS)


def test_seconds_count_every_checkpoint_and_forward(selections):
    _, port, _, seconds = selections
    assert [(s["ckpt"], s["phase"]) for s in seconds] == (
        [(c, "screen") for c in CKPTS]
        + [(r["ckpt"], "finalist") for r in port["ranked"][:2]])
    assert [s["forwards"] for s in seconds] == [4, 4, 4, 6, 6]
    assert all(s["forward_s"] > 0 and s["decode_s"] > 0 for s in seconds)


def test_stacked_export_loads_as_unrolled(run_dir, tmp_path):
    stacked = checkpoint.load_params_auto(str(run_dir / "models" / STACKED))
    flat = checkpoint.read_flax_checkpoint(str(run_dir / "models" / STACKED))
    checkpoint.save_params(str(tmp_path / "flat.ckpt"), flat)
    unrolled = checkpoint.load_params_auto(str(tmp_path / "flat.ckpt"))
    assert stacked.keys() == unrolled.keys()
    assert any(".1." in k for k in stacked)           # both blocks
    for k in stacked:
        assert torch.equal(stacked[k], unrolled[k]), k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_weight_swap_serves_the_new_weights(run_dir, use_pallas):
    """A swapped engine serves exactly what an engine built with those
    weights serves (with ``use_pallas``, K9's packed weights are renewed)."""
    cfg = InferenceConfig(
        inference_model=str(run_dir / "models"), inf_smiles=str(run_dir / "inf.smi"),
        train_smiles=str(run_dir / "inf.smi"), train_drug_smiles=str(run_dir / "drugs.smi"),
        inf_batch_size=BATCH, dim=DIM, depth=DEPTH, heads=HEADS, max_atom=N,
        mol_data_dir=str(run_dir / "swap"), use_pallas=use_pallas, device="cpu")
    first, second = (checkpoint.load_params_auto(str(run_dir / "models" / c))
                     for c in CKPTS[:2])
    swapped = InferenceEngine(cfg, g_state_dict=first)
    x, a = swapped.data.x[:BATCH], swapped.data.a[:BATCH]
    before = swapped.forward(a, x)
    old_k9 = swapped.k9_weights
    swapped.load_generator(second)
    assert (swapped.k9_weights is not old_k9) == use_pallas
    fresh = InferenceEngine(cfg, g_state_dict=second)
    after, want = swapped.forward(a, x), fresh.forward(a, x)
    for got, ref in zip(after, want):
        assert torch.equal(got, ref)
    assert any(not torch.equal(b, g) for b, g in zip(before, after))

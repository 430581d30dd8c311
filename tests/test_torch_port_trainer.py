"""The port's trainer, its CLI and its checkpoints, on the CPU.

``python -m druggen_tpu_torch.train --device cpu`` trains end to end on a
tiny corpus; the ``DrugGEN-G.ckpt`` it writes loads in the JAX package's
``load_params`` (the flax msgpack format, values bit-equal) and serves
through the port's ``InferenceEngine``.  The numerics ladder escalates as
the JAX trainer's does (``tests/test_numerics_ladder.py:175``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, write_corpus
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.train import checkpoint as jax_ckpt
from druggen_tpu_torch.config import InferenceConfig, parse_train_args
from druggen_tpu_torch.infer.engine import InferenceEngine
from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_serialize
from druggen_tpu_torch.interop.weights import flax_generator_to_torch
from druggen_tpu_torch.train import checkpoint as ckpt
from druggen_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(tmp_path, *extra):
    write_corpus(str(tmp_path / "chembl.smi"), DRUGLIKE_SMILES)
    write_corpus(str(tmp_path / "drugs.smi"), TARGET_SMILES)
    return ["--raw_file", str(tmp_path / "chembl.smi"),
            "--drug_raw_file", str(tmp_path / "drugs.smi"),
            "--submodel", "DrugGEN", "--max_atom", "25", "--dim", "16",
            "--heads", "2", "--batch_size", "8", "--epoch", "1",
            "--mol_data_dir", str(tmp_path / "c"),
            "--drug_data_dir", str(tmp_path / "cd"),
            "--log_dir", str(tmp_path / "l"),
            "--sample_dir", str(tmp_path / "s"),
            "--model_save_dir", str(tmp_path / "m"),
            "--set_seed", "--seed", "7", *extra]


def test_trainer_ladder_escalation(tmp_path):
    """Escalates tier by tier through gp_f32 -> f32_stats -> full f32 on the
    same parameters and optimizer state, and the step keeps running."""
    cfg = parse_train_args(_args(tmp_path, "--compute_dtype", "bf16",
                                 "--fused_mlp", "--fused_critic",
                                 "--device", "cpu"))
    assert cfg.gp_f32 == "auto" and cfg.f32_stats == "auto"
    tr = Trainer(cfg)
    assert tr._numerics_tier == 0 and tr._ladder == [1, 2, 3]
    params = list(tr.G.parameters()) + list(tr.D.parameters())
    x = np.zeros((8, 25), np.int8)
    a = np.zeros((8, 25, 25), np.int8)
    expect = {0: (False, False, True, torch.bfloat16),
              1: (True, False, True, torch.bfloat16),
              2: (True, True, False, torch.bfloat16),
              3: (False, False, False, torch.float32)}
    for tier in (0, 1, 2, 3):
        step = tr.step_fn
        gp32, stats, fused, dtype = expect[tier]
        assert tr._numerics_tier == tier
        assert (step.gp_cast is not None) == gp32
        assert step.g_numerics["f32_stats"] == stats
        assert step.g_numerics["fused_mlp"] == step.d_first["fused_mlp"] == fused
        assert step.compute_dtype == dtype
        out = step(x, a, x, a)
        assert np.isfinite(out["d_loss"].float().item())
        assert int(tr.d_opt.state.count) == tier + 1
        if tier < 3:
            tr._escalate_numerics()
    assert not tr._ladder
    assert all(p is q for p, q in zip(params, list(tr.G.parameters())
                                      + list(tr.D.parameters())))
    tr._escalate_numerics()         # past the last tier: warns, no raise
    assert tr._ladder_exhausted_warned


def test_cli_trains_and_its_checkpoint_serves(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "druggen_tpu_torch.train", *_args(
            tmp_path, "--compute_dtype", "bf16", "--fused_mlp",
            "--fused_critic", "--log_sample_step", "5", "--device", "cpu")],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "model saved at epoch 0 iteration 4" in proc.stdout
    run = [d for d in os.listdir(tmp_path / "m")]
    assert len(run) == 1
    model_dir = tmp_path / "m" / run[0]
    for name in ("DrugGEN-G.ckpt", "1-5-G.ckpt", "1-5-D.ckpt", "1-10-G.ckpt",
                 "state_10.msgpack"):
        assert (model_dir / name).exists(), name
    # full-state checkpoints at the cadence and at the end, the newest three
    steps = sum(1 for line in open(next((tmp_path / "l").rglob("*.jsonl")))
                if '"d_loss"' in line)
    states = sorted(int(p.stem[len("state_"):]) for p in model_dir.glob("state_*.msgpack"))
    assert states == sorted(set(range(5, steps + 1, 5)) | {steps})[-3:]

    # the JAX package's load_params reads it, into a JAX Generator template
    ours = ckpt.load_params(str(model_dir / "DrugGEN-G.ckpt"))
    m_dim = ours["params"]["readout_n"]["bias"].shape[0]
    b_dim = ours["params"]["readout_e"]["bias"].shape[0]
    jg = JaxG(act="relu", vertexes=25, edges=b_dim, nodes=m_dim, dropout=0.0,
              dim=16, depth=1, heads=2, mlp_ratio=3)
    template = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 25, 25, b_dim)),
                       jnp.zeros((1, 25, m_dim)))
    loaded = jax_ckpt.load_params(str(model_dir / "DrugGEN-G.ckpt"), template)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(loaded))
    flat_p = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(leaf), flat_p[path])
    logits = jg.apply(loaded, jnp.zeros((2, 25, 25, b_dim)),
                      jnp.zeros((2, 25, m_dim)))
    assert np.isfinite(np.asarray(logits[2])).all()

    # and the port's engine serves it
    inf = InferenceConfig(
        submodel="DrugGEN", inference_model=str(model_dir),
        inf_smiles=str(tmp_path / "chembl.smi"),
        train_smiles=str(tmp_path / "chembl.smi"),
        train_drug_smiles=str(tmp_path / "drugs.smi"), max_atom=25, dim=16,
        heads=2, inf_batch_size=8, inf_max_batches=1, sample_num=8,
        mol_data_dir=str(tmp_path / "c"), disable_correction=True,
        compute_dtype="bfloat16", fused_mlp=True, device="cpu")
    engine = InferenceEngine(inf)
    sd = flax_generator_to_torch(ours)
    for k, v in engine.G.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    kept, decoded, _, _ = engine.sample()
    assert len(decoded) == 8


def test_msgpack_writer_matches_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {"params": {"trunk": {"node_fc1": {
        "kernel": rng.normal(size=(5, 64)).astype(np.float32),
        "bias": np.zeros(64, np.float32)}},
        "readout_n": {"kernel": rng.normal(size=(16, 8)).astype(np.float32),
                      "bias": rng.normal(size=(8,)).astype(np.float32)}}}
    assert msgpack_serialize(tree) == serialization.to_bytes(tree)


def test_training_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    cfg = parse_train_args(_args(tmp_path))
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg)


@pytest.mark.parametrize("flag", [
    ["--mesh_model", "2"], ["--mesh_node", "2"], ["--mesh_data", "2"],
    ["--distributed"]])
def test_unported_knobs_raise(tmp_path, flag):
    cfg = parse_train_args(_args(tmp_path, "--device", "cpu", *flag))
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(cfg)


@pytest.mark.parametrize("flag", [
    ["--gp_mode", "fwdrev"], ["--split_step"], ["--steps_per_dispatch", "4"],
    ["--scan_layers"], ["--features"]])
def test_single_device_options_train(tmp_path, flag):
    """Each single-device option of the JAX trainer trains 2 steps on the
    CPU (a 16-molecule corpus, batch 8) with finite losses and writes its
    files."""
    args = _args(tmp_path, "--device", "cpu", "--compute_dtype", "bf16",
                 "--log_sample_step", "2", *flag)
    write_corpus(str(tmp_path / "chembl.smi"), DRUGLIKE_SMILES[:16])
    tr = Trainer(parse_train_args(args)).train()
    assert tr.step == 2
    logs = [json.loads(line) for line in open(tr.logger.jsonl_path)]
    losses = [(r["d_loss"], r["g_loss"]) for r in logs if "d_loss" in r]
    assert losses and np.isfinite(losses).all()
    assert sorted(os.listdir(tr.model_dir)) == [
        "1-2-D.ckpt", "1-2-G.ckpt", "D_modules.txt", "DrugGEN-G.ckpt", "G_modules.txt",
        "state_2.msgpack"]
    # the export serves: it loads into a Generator of the run's widths
    sd = ckpt.load_params_auto(os.path.join(tr.model_dir, "DrugGEN-G.ckpt"))
    assert sd["readout_n.weight"].shape == (tr.m_dim, 16)
    if flag == ["--features"]:
        assert tr.m_dim == tr.vocab.m_dim + 54

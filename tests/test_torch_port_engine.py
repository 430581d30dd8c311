"""The port's serving slice end to end, on the CPU, against the JAX engine.

Both engines load the trained r2_scale Generator at full width (N 45, dim
128, depth 1, 8 heads) from its tracked flax checkpoint (the port with its
own reader) and serve the same 8-graph batch in f32: the argmax labels and
the decoded SMILES must be identical.  Also: the CLI twin, the config
flags, and the device rule (asking for cuda without a card raises).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from druggen_tpu.chem.vocab import Vocab as JaxVocab
from druggen_tpu.config import InferenceConfig as JaxInferenceConfig
from druggen_tpu.infer.engine import InferenceEngine as JaxInferenceEngine
from druggen_tpu_torch import inference as port_cli
from druggen_tpu_torch.chem.vocab import Vocab
from druggen_tpu_torch.config import InferenceConfig, parse_inference_args
from druggen_tpu_torch.infer.engine import InferenceEngine, resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(
    REPO, "experiments", "r2_scale", "models",
    "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512_epoch35"
    "_datasetchembl_like_150k45_dropout0.0")
VOCAB_JSON = os.path.join(REPO, "data", "cache", "vocab",
                          "vocab_akt1_drugs_chembl_like_150k_45.json")
SMILES_FILE = os.path.join(REPO, "data", "chembl_like_150k.smi")
BATCH = 8
SEED = 1   # the engines' default shuffle seed


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    smi = tmp / "inf.smi"
    with open(SMILES_FILE) as src:
        smi.write_text("".join(line for _, line in zip(range(64), src)))
    with open(VOCAB_JSON) as f:
        vocab_json = f.read()
    common = dict(submodel="DrugGEN", inference_model=CKPT_DIR,
                  sample_num=BATCH, disable_correction=True,
                  inf_smiles=str(smi), train_smiles=str(smi),
                  train_drug_smiles=str(smi), inf_batch_size=BATCH,
                  inf_max_batches=1, seed=SEED)
    jax_engine = JaxInferenceEngine(
        JaxInferenceConfig(**common, mol_data_dir=str(tmp / "jax")),
        vocab=JaxVocab.from_json(vocab_json))
    port_engine = InferenceEngine(
        InferenceConfig(**common, mol_data_dir=str(tmp / "port"),
                        output_dir=str(tmp / "out"), device="cpu"),
        vocab=Vocab.from_json(vocab_json))
    return jax_engine, port_engine


def test_same_batch_same_labels(served):
    jax_engine, port_engine = served
    np.testing.assert_array_equal(port_engine.data.x, jax_engine.data.x)
    np.testing.assert_array_equal(port_engine.data.a, jax_engine.data.a)
    x, a = port_engine.data.x[:BATCH], port_engine.data.a[:BATCH]
    n_j, e_j = jax_engine._forward(jax_engine.g_params, a, x)
    n_p, e_p = port_engine.forward(a, x)
    assert n_p.dtype == torch.int32 and n_p.shape == (BATCH, 45)
    assert e_p.shape == (BATCH, 45, 45)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_j))


def test_same_batch_same_smiles(served):
    jax_engine, port_engine = served
    kept_j, decoded_j, _, _ = jax_engine.sample()
    kept_p, decoded_p = port_engine.sample()
    assert len(decoded_p) == BATCH
    assert decoded_p == decoded_j
    assert kept_p == kept_j and kept_p
    assert len(port_engine.timings) == 1


def test_cli_serves_on_cpu(tmp_path):
    smi = tmp_path / "inf.smi"
    with open(SMILES_FILE) as src:
        smi.write_text("".join(line for _, line in zip(range(40), src)))
    vocab_dir = tmp_path / "data" / "vocab"
    vocab_dir.mkdir(parents=True)
    with open(VOCAB_JSON) as f:
        (vocab_dir / "vocab_inf_inf_45.json").write_text(f.read())
    results = port_cli.main([
        "--submodel", "DrugGEN", "--inference_model", CKPT_DIR,
        "--inf_smiles", str(smi), "--train_smiles", str(smi),
        "--train_drug_smiles", str(smi), "--mol_data_dir",
        str(tmp_path / "data"), "--output_dir", str(tmp_path / "out"),
        "--inf_batch_size", "4", "--inf_max_batches", "1", "--sample_num",
        "4", "--compute_dtype", "bf16", "--fused_mlp", "--disable_correction",
        "--device", "cpu"])
    assert set(results) == {"submodel", "validity", "generator_validity",
                            "uniqueness"}
    lines = (tmp_path / "out" / "DrugGEN" / "inference_drugs.csv").read_text()
    assert lines.startswith("SMILES")


def test_config_takes_every_jax_flag():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxInferenceConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(InferenceConfig)}
    assert set(port_fields) - set(jax_fields) == {"device"}
    assert all(port_fields[k] == v for k, v in jax_fields.items())
    cfg = parse_inference_args(["--inf_smiles", "a", "--train_smiles", "b",
                                "--train_drug_smiles", "c", "--compute_dtype",
                                "bf16", "--fused_mlp"])
    assert cfg.device == "cuda" and cfg.compute_dtype == "bfloat16"
    assert parse_inference_args(["--inf_smiles", "a", "--train_smiles", "b",
                                 "--train_drug_smiles", "c", "--device",
                                 "cpu"]).device == "cpu"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(InferenceConfig(inf_smiles="never-read.smi"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_raise(served):
    _, port_engine = served
    with pytest.raises(NotImplementedError, match="correction"):
        engine = object.__new__(InferenceEngine)
        engine.cfg = dataclasses.replace(port_engine.cfg,
                                         disable_correction=False)
        engine.run()


def test_f32_guard_turns_the_kernel_off(served):
    _, port_engine = served
    cfg = dataclasses.replace(port_engine.cfg, fused_mlp=True)
    with pytest.warns(UserWarning, match="fused_mlp"):
        engine = InferenceEngine(cfg, vocab=port_engine.vocab,
                                 g_state_dict=port_engine.G.state_dict())
    assert engine.cfg.fused_mlp is False
    assert not any(b.fused_mlp for b in engine.G.TransformerEncoder.Encoder_Blocks)

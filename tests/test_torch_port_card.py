"""Card-only tests of the PyTorch port: its CUDA kernels have no CPU mode.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card.py

Without a CUDA card every test skips (decided inside the test).
Tolerances, compared in f32: bf16 |err| <= 3e-2 + 2^-7 |ref| and mean
<= 2e-3 — the sums run in another order, so an output may round to the
neighbouring bf16 value: 2^-6 below |y| = 4, 2^-5 up to 8 (the gains here,
1 ± 0.5, reach past 4); f32 1e-4.
"""

import math
import os

import numpy as np
import pytest
import torch

from druggen_tpu_torch.ops import fused_mlp as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, H = port.KERNEL_C, port.KERNEL_H


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _params(seed):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C, H)) / math.sqrt(C), rng.normal(size=(H,)) * 0.1,
         rng.normal(size=(H, C)) / math.sqrt(H), rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1)
    return [torch.from_numpy(x.astype(np.float32)).cuda() for x in p]


def _assert_close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out, ref, atol=3e-2, rtol=2 ** -7)
        assert err.mean().item() <= 2e-3
    else:
        assert err.max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 1000),
                                        (torch.float32, 1000),
                                        (torch.bfloat16, 16 * 4096 + 5),
                                        (torch.bfloat16, 7)])
def test_kernel_matches_plain(dtype, rows):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(rows)
    s = torch.randn(rows, C, generator=g, device="cuda").to(dtype)
    p = _params(rows)
    before = port.fused_ln_mlp_ln.launches
    out = port.fused_ln_mlp_ln(s, *p)
    torch.cuda.synchronize()
    assert port.fused_ln_mlp_ln.launches == before + 1
    assert out.dtype == dtype and out.shape == s.shape
    _assert_close(out, port.fused_ln_mlp_ln_reference(s, *p), dtype)


@pytest.mark.cuda
def test_kernel_keeps_leading_axes():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    s = torch.randn(2, 45, 45, C, generator=g, device="cuda").bfloat16()
    p = _params(0)
    out = port.fused_ln_mlp_ln(s, *p)
    assert out.shape == s.shape
    _assert_close(out, port.fused_ln_mlp_ln_reference(s, *p), torch.bfloat16)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    p = _params(1)
    s = torch.randn(64, C, device="cuda")
    with pytest.raises(TypeError):
        port.fused_ln_mlp_ln(s.half(), *p)
    with pytest.raises(ValueError, match="contiguous"):
        port.fused_ln_mlp_ln(torch.randn(C, 64, device="cuda").t(), *p)
    with pytest.raises(ValueError, match="compiled for"):
        port.fused_ln_mlp_ln(torch.randn(64, 32, device="cuda"), *p)
    with pytest.raises(ValueError, match="is on"):
        port.fused_ln_mlp_ln(s, p[0].cpu(), *p[1:])


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(tmp_path):
    """One 16-graph batch of the trained r2_scale Generator on the card in
    bf16: the kernel runs once per block, and its labels equal the plain
    bf16 path's."""
    _need_card()
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.infer.engine import InferenceEngine

    smi = tmp_path / "inf.smi"
    with open(os.path.join(REPO, "data", "chembl_like_150k.smi")) as src:
        smi.write_text("".join(line for _, line in zip(range(64), src)))
    with open(os.path.join(REPO, "data", "cache", "vocab",
                           "vocab_akt1_drugs_chembl_like_150k_45.json")) as f:
        vocab = Vocab.from_json(f.read())
    cfg = InferenceConfig(
        submodel="DrugGEN", inference_model=os.path.join(
            REPO, "experiments", "r2_scale", "models",
            "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512"
            "_epoch35_datasetchembl_like_150k45_dropout0.0"),
        inf_smiles=str(smi), train_smiles=str(smi), train_drug_smiles=str(smi),
        mol_data_dir=str(tmp_path), compute_dtype="bfloat16", fused_mlp=True,
        device="cuda")
    engine = InferenceEngine(cfg, vocab=vocab)
    x, a = engine.data.x[:16], engine.data.a[:16]
    before = port.fused_ln_mlp_ln.launches
    n_k, e_k = engine.forward(a, x)
    assert port.fused_ln_mlp_ln.launches == before + cfg.depth
    for blk in engine.G.TransformerEncoder.Encoder_Blocks:
        blk.fused_mlp = False
    n_p, e_p = engine.forward(a, x)
    assert port.fused_ln_mlp_ln.launches == before + cfg.depth
    same = (n_k == n_p).sum().item() + (e_k == e_p).sum().item()
    assert same / (n_k.numel() + e_k.numel()) >= 0.999

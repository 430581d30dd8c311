"""Card-only tests of the PyTorch port: its CUDA kernels have no CPU mode.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card.py

Without a CUDA card every test skips (decided inside the test).
Tolerances, compared in f32: bf16 |err| <= 3e-2 + 2^-7 |ref| and mean
<= 2e-3 — the sums run in another order, so an output may round to the
neighbouring bf16 value: 2^-6 below |y| = 4, 2^-5 up to 8 (the gains here,
1 ± 0.5, reach past 4); f32 1e-4.  K2 (the backward): ``ds`` as above but
with rtol 2^-6, since ``dm`` and ``dh`` are rounded to bf16 on the way and a
rounding flip there moves ``ds`` by a few of its own ulps; each parameter
gradient (a sum over all rows) by relative norm error, bf16 1e-2, f32 1e-5.
A hidden unit whose pre-activation lies within rounding of the ReLU kink
may take either side of it, in the kernel and in the plain version alike;
its ``dh`` element, and so its ``ds`` row, then differ by O(1e-1).  Each
row beyond the tolerance must be witnessed as such
(``fused_mlp.witness_kink_flips``: the plain row matches the kernel's once
the units within rounding reach of the kink are set to one side or the
other), such rows may be at most 0.1 % of the rows, and ``ds`` and the
gradients are then held against the plain version with those settings.
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


GRAD_NAMES = ("dg1", "dbl1", "dw1", "db1", "dw2", "db2", "dg2", "dbl2")


def _rel_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _row_ok(dtype):
    if dtype == torch.bfloat16:
        return lambda a, b: ((a.float() - b.float()).abs()
                             <= 3e-2 + 2 ** -6 * b.float().abs()).all(-1)
    return lambda a, b: ((a.float() - b.float()).abs() <= 1e-4).all(-1)


def _witnessed_reference(got, s, p, dout, dtype):
    """The plain version with the witnessed kink settings of ``got``'s rows
    beyond tolerance; asserts that every such row is witnessed."""
    ref = port.fused_ln_mlp_ln_bwd_reference(s, *p, dout)
    assert got[0].dtype == dtype and got[0].shape == ref[0].shape
    bad = torch.nonzero(~_row_ok(dtype)(got[0], ref[0])).flatten()
    assert len(bad) <= max(1, s.shape[0] // 1000), len(bad)
    relu_set, unexplained = port.witness_kink_flips(s, p, dout, got[0], bad,
                                                    _row_ok(dtype))
    assert len(unexplained) == 0, unexplained[:10].tolist()
    return port.fused_ln_mlp_ln_bwd_reference(s, *p, dout, relu_set=relu_set)


def _assert_ds_close(got, ref, dtype):
    assert _row_ok(dtype)(got[0], ref[0]).all()
    if dtype == torch.bfloat16:
        assert (got[0].float() - ref[0].float()).abs().mean().item() <= 2e-3


def _assert_grads_close(got, ref, dtype):
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for name, g, r in zip(GRAD_NAMES, got[1:], ref[1:]):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= tol, (name, _rel_err(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 1000),
                                        (torch.float32, 1000),
                                        (torch.bfloat16, 16 * 4096 + 5),
                                        (torch.float32, 16 * 512 + 3),
                                        (torch.bfloat16, 7)])
def test_bwd_kernel_matches_plain(dtype, rows):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(rows)
    s = torch.randn(rows, C, generator=g, device="cuda").to(dtype)
    dout = torch.randn(rows, C, generator=g, device="cuda").to(dtype)
    p = _params(rows)
    before = port.fused_ln_mlp_ln_bwd.launches
    got = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    torch.cuda.synchronize()
    assert port.fused_ln_mlp_ln_bwd.launches == before + 1
    ref = _witnessed_reference(got, s, p, dout, dtype)
    _assert_ds_close(got, ref, dtype)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic():
    """No float atomics: two calls on the same inputs give the same bits."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    s = torch.randn(50_000, C, generator=g, device="cuda").bfloat16()
    dout = torch.randn(50_000, C, generator=g, device="cuda").bfloat16()
    p = _params(5)
    first = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    second = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_function_is_first_order_only():
    _need_card()
    p = [t.requires_grad_() for t in _params(2)]
    s = torch.randn(64, C, device="cuda", requires_grad=True)
    out = port.FusedLnMlpLn.apply(s, *p)
    (gs,) = torch.autograd.grad(out.square().sum(), s, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gs.sum(), p[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_gradients_match_plain_block(dtype):
    """The edge tail of a fused_mlp block trains on the card: its parameter
    and input gradients match the plain block's (f32: relative 1e-4; bf16:
    relative 5e-2, the plain path rounds at its own points)."""
    _need_card()
    from druggen_tpu_torch.models.layers import EncoderBlock, init_torch_style_

    torch.manual_seed(0)
    blk = EncoderBlock(C, 8, 3, 0.0, None if dtype == torch.float32 else dtype,
                       fused_mlp=True)
    init_torch_style_(blk, torch.Generator().manual_seed(0))
    blk = blk.cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 9, C, generator=g, device="cuda").to(dtype)
    y = torch.randn(4, 9, 9, C, generator=g, device="cuda").to(dtype)
    w = torch.randn(4, 9, 9, C, generator=g, device="cuda")
    grads = {}
    for fused in (True, False):
        blk.fused_mlp = fused
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = port.fused_ln_mlp_ln_bwd.launches
        xo, yo = blk(xi, yi)
        loss = (yo.float() * w).sum() + xo.float().sum()
        params = list(blk.parameters())
        grads[fused] = torch.autograd.grad(loss, [xi, yi] + params)
        assert port.fused_ln_mlp_ln_bwd.launches == before + int(fused)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(grads[True], grads[False]):
        assert _rel_err(a.float(), b.float()) <= tol


@pytest.mark.cuda
def test_full_width_training_step_runs_through_the_kernels():
    """One bf16 training step of the r2_scale widths (N 45, dim 128, depth 1,
    8 heads, mlp_ratio 3, m_dim 8, b_dim 5) on the card: K1 and K2 launch
    once each (the Generator's tail; the critic's last-block tail is
    skipped), the losses are finite and both models' parameters move."""
    _need_card()
    from druggen_tpu_torch.models import Discriminator, Generator
    from druggen_tpu_torch.train.optim import AdamW
    from druggen_tpu_torch.train.step import TrainStep

    n, m_dim, b_dim, batch = 45, 8, 5, 64
    common = dict(act="relu", vertexes=n, edges=b_dim, nodes=m_dim,
                  dropout=0.0, dim=C, depth=1, heads=8, mlp_ratio=3,
                  dtype=torch.bfloat16)
    G = Generator(fused_mlp=True, generator=torch.Generator().manual_seed(0),
                  **common).cuda()
    D = Discriminator(generator=torch.Generator().manual_seed(1), **common).cuda()
    g_opt, d_opt = AdamW(G, 1e-5), AdamW(D, 1e-5)
    before = [g_opt.flat.clone(), d_opt.flat.clone()]
    step = TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=m_dim,
                     b_dim=b_dim, compute_dtype=torch.bfloat16, g_fused=True,
                     fused_critic=True,
                     generator=torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(0)
    x = rng.integers(0, m_dim, (batch, n))
    a = rng.integers(0, b_dim, (batch, n, n))
    k1, k2 = port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches
    out = step(x, a, x, a)
    torch.cuda.synchronize()
    assert port.fused_ln_mlp_ln.launches == k1 + 1
    assert port.fused_ln_mlp_ln_bwd.launches == k2 + 1
    assert math.isfinite(out["d_loss"].item()) and math.isfinite(out["g_loss"].item())
    assert out["edge_logits"].shape == (batch, n, n, b_dim)
    for o, b in zip((g_opt, d_opt), before):
        assert (o.flat - b).abs().max().item() > 0
        assert int(o.state.count) == 1

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
C, H = 128, 384          # the published widths: dim 128, mlp_ratio 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 stays f32


def _params(seed, c=C, h=H):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(c,)) * 0.5 + 1.0, rng.normal(size=(c,)) * 0.1,
         rng.normal(size=(c, h)) / math.sqrt(c), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, c)) / math.sqrt(h), rng.normal(size=(c,)) * 0.1,
         rng.normal(size=(c,)) * 0.5 + 1.0, rng.normal(size=(c,)) * 0.1)
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
    with pytest.raises(ValueError, match="has shape"):
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
    """No float atomics: two calls on the same inputs give the same bits, at
    the training shape (512 graphs of 45 x 45 edge rows)."""
    _need_card()
    rows = 512 * 45 * 45
    g = torch.Generator(device="cuda").manual_seed(5)
    s = torch.randn(rows, C, generator=g, device="cuda").bfloat16()
    dout = torch.randn(rows, C, generator=g, device="cuda").bfloat16()
    p = _params(5)
    first = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    second = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# the single pass's widths, then the split path's: C not a multiple of 8, C
# padded to 64 above 256 (dim 512 with mlp_ratio 3)
WIDTHS = [(64, 192), (96, 192), (128, 384), (128, 512), (256, 768),
          (100, 300), (264, 792), (512, 1536)]
# row counts around the 64-row warpgroup tile of the bf16 kernels
EDGE_ROWS = (1, 63, 64, 65, 127, 129, 8195)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_tile_edges_match_plain(c, h, dtype):
    """K1 and K2 at row counts around the 64-row tile, at every width the
    card tests build, against their plain versions (K2 with the kink
    witness)."""
    _need_card()
    p = _params(c + h, c, h)
    for rows in EDGE_ROWS:
        g = torch.Generator(device="cuda").manual_seed(rows)
        s = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
        dout = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
        _assert_close(port.fused_ln_mlp_ln(s, *p), port.fused_ln_mlp_ln_reference(s, *p),
                      dtype)
        got = port.fused_ln_mlp_ln_bwd(s, *p, dout)
        torch.cuda.synchronize()
        ref = _witnessed_reference(got, s, p, dout, dtype)
        _assert_ds_close(got, ref, dtype)
        _assert_grads_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", WIDTHS)
def test_launch_plan_matches_the_library(c, h):
    """The pure-Python launch plan gives the shared memory and the staging
    that the bf16 kernels were compiled with."""
    _need_card()
    plan = port.launch_plan(c, h, 1000, port.num_sms(0))
    lib, blib = port._kernel_lib(c, h), port._bwd_lib(c, h)
    assert plan.fwd_smem == lib.fused_ln_mlp_ln_fwd_smem_bytes(1)
    assert plan.rows_smem == blib.fused_ln_mlp_ln_bwd_smem_bytes(1)
    assert plan.wgrad_smem == blib.fused_ln_mlp_ln_bwd_wgrad_smem_bytes(1)
    assert plan.fwd_staged == bool(lib.fused_ln_mlp_ln_fwd_stages_weights(1))
    assert plan.rows_staged == bool(blib.fused_ln_mlp_ln_bwd_stages_weights(1))
    assert plan.split == bool(lib.fused_ln_mlp_ln_split())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_function_matches_plain(dtype):
    """FusedLnMlpLn through autograd: K1 forward and K2 backward, one launch
    each, against the plain versions."""
    _need_card()
    rows = 16 * 512 + 3
    p = [t.requires_grad_() for t in _params(7)]
    g = torch.Generator(device="cuda").manual_seed(7)
    s = torch.randn(rows, C, generator=g, device="cuda").to(dtype).requires_grad_()
    dout = torch.randn(rows, C, generator=g, device="cuda").to(dtype)
    before = (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches)
    out = port.FusedLnMlpLn.apply(s, *p)
    got = torch.autograd.grad(out, [s, *p], dout)
    torch.cuda.synchronize()
    assert (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [t.detach() for t in p]
    _assert_close(out, port.fused_ln_mlp_ln_reference(s.detach(), *plain), dtype)
    ref = _witnessed_reference(got, s.detach(), plain, dout, dtype)
    _assert_ds_close(got, ref, dtype)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.cuda
def test_autograd_function_is_first_order_only():
    _need_card()
    p = [t.requires_grad_() for t in _params(2)]
    s = torch.randn(64, C, device="cuda", requires_grad=True)
    out = port.FusedLnMlpLn.apply(s, *p)
    (gs,) = torch.autograd.grad(out.square().sum(), s, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gs.sum(), p[2])


def _fused_vs_plain_block(dim, ratio, dtype):
    """Forward outputs and input and parameter gradients of one
    EncoderBlock with the fused tail against the same block without it
    (f32: relative 1e-4; bf16: relative 5e-2, the plain path rounds at its
    own points); K1 and K2 launch once each on the fused pass."""
    from druggen_tpu_torch.models.layers import EncoderBlock, init_torch_style_

    torch.manual_seed(0)
    blk = EncoderBlock(dim, 8, ratio, 0.0, None if dtype == torch.float32 else dtype,
                       fused_mlp=True)
    init_torch_style_(blk, torch.Generator().manual_seed(0))
    blk = blk.cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 9, dim, generator=g, device="cuda").to(dtype)
    y = torch.randn(4, 9, 9, dim, generator=g, device="cuda").to(dtype)
    w = torch.randn(4, 9, 9, dim, generator=g, device="cuda")
    grads, outs = {}, {}
    for fused in (True, False):
        blk.fused_mlp = fused
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches)
        xo, yo = blk(xi, yi)
        outs[fused] = (xo.detach(), yo.detach())
        loss = (yo.float() * w).sum() + xo.float().sum()
        params = list(blk.parameters())
        grads[fused] = torch.autograd.grad(loss, [xi, yi] + params)
        assert (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches) == (
            before[0] + int(fused), before[1] + int(fused))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(outs[True] + grads[True], outs[False] + grads[False]):
        assert _rel_err(a.float(), b.float()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_gradients_match_plain_block(dtype):
    """The edge tail of a fused_mlp block trains on the card: its outputs and
    its parameter and input gradients match the plain block's."""
    _need_card()
    _fused_vs_plain_block(C, 3, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ratio", [(64, 3), (96, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_at_other_widths_matches_plain_block(dim, ratio, dtype):
    """K1/K2 built for dim 64 / mlp_ratio 3 and for dim 96 / mlp_ratio 2
    (96 = 3 x 32 columns: a warp holds a row in 24 lanes) run the fused
    tail, under the same limits as dim 128."""
    _need_card()
    _fused_vs_plain_block(dim, ratio, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ratio", [(128, 4), (256, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_fused_block_runs_in_bf16_and_f32(dim, ratio, dtype):
    """dim 128 / mlp_ratio 4 and dim 256 / mlp_ratio 3: the bf16 weights do
    not fit one SM's shared memory beside the tile's buffers, so K1/K2 read
    them through L2 (the library says it does not stage them); the fused
    block trains at these widths under the limits of the narrower ones."""
    _need_card()
    bf16 = int(dtype == torch.bfloat16)
    assert not port._kernel_lib(dim, dim * ratio).fused_ln_mlp_ln_fwd_stages_weights(bf16)
    assert not port._bwd_lib(dim, dim * ratio).fused_ln_mlp_ln_bwd_stages_weights(bf16)
    _fused_vs_plain_block(dim, ratio, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", [(64, 192), (96, 192), (128, 512), (256, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_other_widths_match_plain(c, h, dtype):
    """K1 and K2 at other widths against their plain versions, under the
    limits of the dim-128 tests above (K2 with the kink witness)."""
    _need_card()
    rows = 16 * 512 + 5
    g = torch.Generator(device="cuda").manual_seed(c + h)
    s = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
    dout = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
    p = _params(c, c, h)
    out = port.fused_ln_mlp_ln(s, *p)
    _assert_close(out, port.fused_ln_mlp_ln_reference(s, *p), dtype)
    got = port.fused_ln_mlp_ln_bwd(s, *p, dout)
    torch.cuda.synchronize()
    ref = _witnessed_reference(got, s, p, dout, dtype)
    _assert_ds_close(got, ref, dtype)
    _assert_grads_close(got, ref, dtype)


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


# --- K5 / K6: the fused edge attention -------------------------------------
# Kernel against its plain version on the same inputs, compared in f32.
# Outputs: bf16 |err| <= 1e-2 + 2^-7 |ref| (the f32 products are summed in
# another order, so a value can round to the neighbouring bf16 value), f32
# 1e-4 + 1e-5 |ref|.  K6's eight gradients by relative norm error, bf16
# 1e-3, f32 1e-5 (sums over all rows in another order; bf16 reads at most
# 2.7e-5 on an H100, and a K6 that rounded e, de or its upstream gradient to
# bf16 would read over 2e-3, test_torch_port_fused_attention.py).

# bf16 at D 128 and N <= 64 takes the Hopper kernels, every other shape the
# CUDA-core ones (fused_attention.hopper_route; both routes are held here).
ATTN_SHAPES = [(torch.bfloat16, 8, 45, 128), (torch.float32, 8, 45, 128),
               (torch.bfloat16, 4, 45, 256), (torch.float32, 2, 45, 384),
               (torch.bfloat16, 2, 45, 512), (torch.bfloat16, 5, 13, 128),
               (torch.float32, 3, 50, 128), (torch.bfloat16, 2, 70, 128),
               (torch.bfloat16, 3, 64, 128), (torch.bfloat16, 4, 1, 128)]
ATTN_GRADS = ("dq", "dk", "dv", "d_eraw", "dwe", "dbe", "dwoe", "dboe")


def _attn_inputs(b, n, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    acts = [r(b, n, d).to(dtype) for _ in range(3)] + [r(b, n, n, d).to(dtype)]
    params = [r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
              r(d, scale=0.1)]
    return acts, params, (r(b, n, n, d).to(dtype), r(b, n, d).to(dtype))


def _attn_close(got, ref, dtype, name):
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=2 ** -7,
                                   msg=name)
    else:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d", ATTN_SHAPES)
def test_attention_fwd_kernel_matches_plain(dtype, b, n, d):
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    assert fa.hopper_route(n, d, dtype) == (dtype == torch.bfloat16 and d == 128 and n <= 64)
    acts, params, _ = _attn_inputs(b, n, d, dtype, seed=n * d)
    before = fa.edge_attention_fwd.launches
    got = fa.edge_attention_fwd(*acts, *params, 8)
    torch.cuda.synchronize()
    assert fa.edge_attention_fwd.launches == before + 1
    ref = fa.edge_attention_fwd_reference(*acts, *params, 8)
    for name, g_, r_ in zip(("edge_out", "node_agg", "t"), got, ref):
        assert torch.isfinite(g_.float()).all(), name
        _attn_close(g_, r_, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d", ATTN_SHAPES)
def test_attention_bwd_kernel_matches_plain(dtype, b, n, d):
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    assert fa.hopper_route(n, d, dtype) == (dtype == torch.bfloat16 and d == 128 and n <= 64)
    acts, params, (ge, gn) = _attn_inputs(b, n, d, dtype, seed=n * d + 1)
    t_res = fa.edge_attention_fwd_reference(*acts, *params, 8)[2]
    before = fa.edge_attention_bwd.launches
    got = fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, 8)
    torch.cuda.synchronize()
    assert fa.edge_attention_bwd.launches == before + 1
    ref = fa.edge_attention_bwd_reference(*acts, *params[:3], t_res, ge, gn, 8)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    for i, (name, g_, r_) in enumerate(zip(ATTN_GRADS, got, ref)):
        assert g_.dtype == (dtype if i < 4 else torch.float32), name
        assert g_.shape == r_.shape and torch.isfinite(g_.float()).all(), name
        assert _rel_err(g_.float(), r_.float()) <= tol, (name, _rel_err(g_.float(), r_.float()))


@pytest.mark.cuda
def test_attention_bwd_kernel_is_deterministic():
    """No float atomics: two calls on the same inputs give the same bits."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, params, (ge, gn) = _attn_inputs(16, 45, 128, torch.bfloat16, seed=9)
    t_res = fa.edge_attention_fwd(*acts, *params, 8)[2]
    first = fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, 8)
    second = fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, 8)
    for name, a, b in zip(ATTN_GRADS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_attention_launch_plan_matches_the_library():
    """The Python plan's wgrad tiles and stage rows equal the libraries';
    their shared memory fits one SM; the shapes above take both routes."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    plan = fa.launch_plan(128, 512, 45, 132)
    lib = fa.library_plan()
    assert plan.hopper
    assert (lib["wgrad_tiles"], lib["wgrad_rows"]) == (plan.wgrad_tiles, fa.WGRAD_ROWS)
    assert 0 < max(lib["fwd_smem"], lib["rows_smem"], lib["wgrad_smem"]) <= fa.SMEM_LIMIT
    assert plan.chunk_rows % lib["wgrad_rows"] == 0
    routes = {fa.hopper_route(n, d, dtype) for dtype, _, n, d in ATTN_SHAPES}
    assert routes == {True, False}


@pytest.mark.cuda
def test_attention_function_is_first_order_only():
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, params, _ = _attn_inputs(2, 9, 128, torch.float32, seed=3)
    leaves = [t.requires_grad_() for t in acts + params]
    eo, _ = fa.EdgeAttentionProj.apply(*leaves, 8)
    (gq,) = torch.autograd.grad(eo.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_mha_use_pallas_matches_plain_attention(dtype):
    """GraphMHA through K5/K6 against the same module on its plain path:
    outputs and input and parameter gradients (f32: relative 1e-4; bf16:
    relative 5e-2, the plain bf16 path rounds e, t and the softmax where the
    kernels keep f32)."""
    _need_card()
    from druggen_tpu_torch.models.layers import GraphMHA, init_torch_style_
    from druggen_tpu_torch.ops import fused_attention as fa

    mha = GraphMHA(128, 8, None if dtype == torch.float32 else dtype)
    init_torch_style_(mha, torch.Generator().manual_seed(0))
    mha = mha.cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(6, 45, 128, generator=g, device="cuda").to(dtype)
    y = torch.randn(6, 45, 45, 128, generator=g, device="cuda").to(dtype)
    wn = torch.randn(6, 45, 128, generator=g, device="cuda")
    we = torch.randn(6, 45, 45, 128, generator=g, device="cuda")
    res = {}
    for fused in (True, False):
        mha.use_pallas = fused
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = (fa.edge_attention_fwd.launches, fa.edge_attention_bwd.launches)
        no, eo = mha(xi, yi)
        loss = (no.float() * wn).sum() + (eo.float() * we).sum()
        grads = torch.autograd.grad(loss, [xi, yi] + list(mha.parameters()))
        assert (fa.edge_attention_fwd.launches, fa.edge_attention_bwd.launches) == (
            before[0] + int(fused), before[1] + int(fused))
        res[fused] = (no.detach(), eo.detach()) + grads
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(res[True], res[False]):
        assert _rel_err(a.float(), b.float()) <= tol


# --- K7 / K8: the megablock -----------------------------------------------------
# Kernel against its plain version on the same inputs, compared in f32.  K7's
# y_out and node_agg as K1's output (bf16 3e-2 + 2^-7 |ref|, mean 2e-3; f32
# 1e-4 + 1e-5 |ref|).  K8: dq, dk, dv and dy as K6's outputs (bf16 1e-2 +
# 2^-7 |ref|; f32 1e-4 + 1e-4 |ref|, a longer f32 chain), each dy row beyond
# that witnessed at the ReLU kink (fused_block.witness_kink_flips: K8's f32
# pre-activation is summed in another order, so a unit within rounding of 0
# may take either side) and at most 0.1 % of the rows; then every output
# against the plain version with the witnessed settings, and the 12 f32
# parameter gradients by relative norm error, bf16 1e-3 and f32 1e-5 (sums
# over all rows in another order), as K6's.

# bf16 at C 128 with H a multiple of 128 and N <= 64 takes the Hopper route
# (fused_block.launch_plan): the training shape, ragged N from 1 to 64, H
# 128 and 512; N 65 and D 256 take the CUDA-core route, as f32 does.
BLOCK_SHAPES = [(torch.bfloat16, 8, 45, 128, 384), (torch.float32, 8, 45, 128, 384),
                (torch.bfloat16, 3, 13, 256, 768), (torch.float32, 3, 13, 256, 768),
                (torch.bfloat16, 5, 1, 128, 384), (torch.bfloat16, 4, 64, 128, 384),
                (torch.bfloat16, 6, 13, 128, 128), (torch.bfloat16, 3, 20, 128, 512),
                (torch.bfloat16, 2, 65, 128, 384)]


def _block_inputs(b, n, d, h, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    acts = [r(b, n, d).to(dtype) for _ in range(3)] + [r(b, n, n, d).to(dtype)]
    params = [r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
              r(d, scale=0.1), r(d, scale=0.1, shift=1.0), r(d, scale=0.1),
              r(d, h, scale=d ** -0.5), r(h, scale=0.1), r(h, d, scale=h ** -0.5),
              r(d, scale=0.1), r(d, scale=0.1, shift=1.0), r(d, scale=0.1)]
    return acts, params, (r(b, n, n, d).to(dtype), r(b, n, d).to(dtype))


def _block_tol(dtype, grad=False):
    if dtype == torch.bfloat16:
        return (1e-2, 2 ** -7) if grad else (3e-2, 2 ** -7)
    return (1e-4, 1e-4) if grad else (1e-4, 1e-5)


def _block_row_ok(dtype):
    atol, rtol = _block_tol(dtype, grad=True)
    return lambda a, b: ((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()).all(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d,h", BLOCK_SHAPES)
def test_block_fwd_kernel_matches_plain(dtype, b, n, d, h):
    _need_card()
    from druggen_tpu_torch.ops import fused_block as fb

    acts, params, _ = _block_inputs(b, n, d, h, dtype, seed=n * d)
    before = fb.fused_block_fwd.launches
    got = fb.fused_block_fwd(*acts, *params, 8)
    torch.cuda.synchronize()
    assert fb.fused_block_fwd.launches == before + 1
    ref = fb.fused_block_fwd_reference(*acts, *params, 8)
    atol, rtol = _block_tol(dtype)
    for name, g_, r_ in zip(("y_out", "node_agg"), got, ref):
        assert g_.dtype == dtype and g_.shape == r_.shape, name
        assert torch.isfinite(g_.float()).all(), name
        err = (g_.float() - r_.float()).abs()
        assert bool((err <= atol + rtol * r_.float().abs()).all()), (name, err.max().item())
        if dtype == torch.bfloat16:
            assert err.mean().item() <= 2e-3, name


def _block_witnessed_reference(got, acts, params, cots, dtype):
    from druggen_tpu_torch.ops import fused_block as fb

    ref = fb.fused_block_bwd_reference(*acts, *params, *cots, 8)
    d = acts[0].shape[-1]
    row_ok = _block_row_ok(dtype)
    bad = torch.nonzero(~row_ok(got[3].reshape(-1, d), ref[3].reshape(-1, d))).flatten()
    rows = got[3].numel() // d
    assert len(bad) <= max(1, rows // 1000), len(bad)
    if not len(bad):
        return ref
    relu_set, unexplained = fb.witness_kink_flips(*acts, params, *cots, 8, got[3], bad, row_ok)
    assert len(unexplained) == 0, unexplained[:10].tolist()
    return fb.fused_block_bwd_reference(*acts, *params, *cots, 8, relu_set=relu_set)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d,h", BLOCK_SHAPES)
def test_block_bwd_kernel_matches_plain(dtype, b, n, d, h):
    _need_card()
    from druggen_tpu_torch.ops import fused_block as fb

    acts, params, cots = _block_inputs(b, n, d, h, dtype, seed=n * d + 1)
    before = fb.fused_block_bwd.launches
    got = fb.fused_block_bwd(*acts, *params, *cots, 8)
    torch.cuda.synchronize()
    assert fb.fused_block_bwd.launches == before + 1
    ref = _block_witnessed_reference(got, acts, params, cots, dtype)
    atol, rtol = _block_tol(dtype, grad=True)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    for i, (name, g_, r_) in enumerate(zip(fb.GRAD_NAMES, got, ref)):
        assert g_.dtype == (dtype if i < 4 else torch.float32), name
        assert g_.shape == r_.shape and torch.isfinite(g_.float()).all(), name
        if i < 4:
            err = (g_.float() - r_.float()).abs()
            assert bool((err <= atol + rtol * r_.float().abs()).all()), (name, err.max().item())
        else:
            assert _rel_err(g_.float(), r_.float()) <= tol, (name, _rel_err(g_, r_))


@pytest.mark.cuda
def test_block_bwd_kernel_is_deterministic():
    """No float atomics: two calls on the same inputs give the same bits."""
    _need_card()
    from druggen_tpu_torch.ops import fused_block as fb

    acts, params, cots = _block_inputs(16, 45, 128, 384, torch.bfloat16, seed=9)
    first = fb.fused_block_bwd(*acts, *params, *cots, 8)
    second = fb.fused_block_bwd(*acts, *params, *cots, 8)
    for name, a, b in zip(fb.GRAD_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", [(128, 384), (128, 128), (128, 512), (256, 768)])
def test_block_launch_plan_matches_the_library(c, h):
    """The Python plan's wgrad tiles equal the library's; the libraries'
    shared memory fits one SM (zeros where the width takes the CUDA-core
    route)."""
    _need_card()
    from druggen_tpu_torch.ops import fused_block as fb

    plan = fb.launch_plan(c, h, 512, 45, 132)
    lib = fb.library_plan(c, h)
    if plan.hopper:
        assert lib["wgrad_tiles"] == plan.wgrad_tiles
        assert 0 < max(lib["fwd_smem"], lib["rows_smem"], lib["wgrad_smem"]) <= fb.SMEM_LIMIT
    else:
        assert lib["fwd_smem"] == lib["rows_smem"] == lib["wgrad_smem"] == 0


@pytest.mark.cuda
def test_block_function_is_first_order_only():
    _need_card()
    from druggen_tpu_torch.ops import fused_block as fb

    acts, params, _ = _block_inputs(2, 9, 128, 256, torch.float32, seed=3)
    leaves = [t.requires_grad_() for t in acts + params]
    y_out, _ = fb.FusedBlock.apply(*leaves, 8)
    (gq,) = torch.autograd.grad(y_out.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_block_in_block_mode_matches_plain_block(dtype, monkeypatch):
    """An EncoderBlock with fused_mlp="block" (K7/K8): outputs and input
    and parameter gradients against the same block in block mode through
    K7/K8's plain versions (same rounding points; relative f32 1e-4, bf16
    1e-2) and, in f32, against the block on its plain path (relative 1e-4;
    the plain bf16 path rounds e, t, the softmax and the tail's input where
    the megablock keeps f32, so it is not held)."""
    _need_card()
    from druggen_tpu_torch.models.layers import EncoderBlock, init_torch_style_
    from druggen_tpu_torch.ops import fused_block as fb

    blk = EncoderBlock(128, 8, 3, 0.0, None if dtype == torch.float32 else dtype)
    init_torch_style_(blk, torch.Generator().manual_seed(0))
    blk = blk.cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 45, 128, generator=g, device="cuda").to(dtype)
    y = torch.randn(4, 45, 45, 128, generator=g, device="cuda").to(dtype)
    wn = torch.randn(4, 45, 128, generator=g, device="cuda")
    we = torch.randn(4, 45, 45, 128, generator=g, device="cuda")
    k7, k8 = fb.fused_block_fwd, fb.fused_block_bwd
    res = {}
    for mode in ("block", "block plain", False):
        blk.fused_mlp = mode and "block"
        if mode == "block plain":
            monkeypatch.setattr(fb, "fused_block_fwd", fb.fused_block_fwd_reference)
            monkeypatch.setattr(fb, "fused_block_bwd", fb.fused_block_bwd_reference)
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = (k7.launches, k8.launches)
        xo, yo = blk(xi, yi)
        loss = (xo.float() * wn).sum() + (yo.float() * we).sum()
        grads = torch.autograd.grad(loss, [xi, yi] + list(blk.parameters()))
        on = int(mode == "block")
        assert (k7.launches, k8.launches) == (before[0] + on, before[1] + on)
        res[mode] = (xo.detach(), yo.detach()) + grads
        monkeypatch.undo()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(res["block"], res["block plain"]):
        assert _rel_err(a.float(), b.float()) <= tol
    if dtype == torch.float32:
        for a, b in zip(res["block"], res[False]):
            assert _rel_err(a.float(), b.float()) <= tol


@pytest.mark.cuda
def test_full_width_fused_block_training_steps():
    """Two bf16 training steps of the r2_scale widths with --fused_block's
    routing (G and the critic's first-order passes in block mode): 4 K7 and
    4 K8 launches a step at depth 1 and no K1/K2, finite losses, both
    models' parameters move."""
    _need_card()
    from druggen_tpu_torch.models import Discriminator, Generator
    from druggen_tpu_torch.ops import fused_block as fb
    from druggen_tpu_torch.train.optim import AdamW
    from druggen_tpu_torch.train.step import TrainStep

    n, m_dim, b_dim, batch = 45, 8, 5, 64
    common = dict(act="relu", vertexes=n, edges=b_dim, nodes=m_dim,
                  dropout=0.0, dim=C, depth=1, heads=8, mlp_ratio=3,
                  dtype=torch.bfloat16)
    G = Generator(fused_mlp="block", generator=torch.Generator().manual_seed(0),
                  **common).cuda()
    D = Discriminator(generator=torch.Generator().manual_seed(1), **common).cuda()
    g_opt, d_opt = AdamW(G, 1e-5), AdamW(D, 1e-5)
    before = [g_opt.flat.clone(), d_opt.flat.clone()]
    step = TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=m_dim,
                     b_dim=b_dim, compute_dtype=torch.bfloat16, g_fused="block",
                     fused_critic="block",
                     generator=torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(0)
    counts = (fb.fused_block_fwd.launches, fb.fused_block_bwd.launches,
              port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches)
    for _ in range(2):
        x = rng.integers(0, m_dim, (batch, n))
        a = rng.integers(0, b_dim, (batch, n, n))
        out = step(x, a, x, a)
        assert math.isfinite(out["d_loss"].item()) and math.isfinite(out["g_loss"].item())
    torch.cuda.synchronize()
    assert (fb.fused_block_fwd.launches - counts[0], fb.fused_block_bwd.launches - counts[1],
            port.fused_ln_mlp_ln.launches - counts[2],
            port.fused_ln_mlp_ln_bwd.launches - counts[3]) == (8, 8, 0, 0)
    for o, b in zip((g_opt, d_opt), before):
        assert (o.flat - b).abs().max().item() > 0
        assert int(o.state.count) == 2


# --- K9: the whole generator (use_pallas serving) --------------------------
# Kernel against its plain version (the same rounding points), compared in
# f32.  bf16: logits |err| <= 3e-2 + 2^-7 |ref| and mean <= 2e-3 (the f32
# sums run in another order, so an intermediate may round to the
# neighbouring bf16 value and carry that through the later layers); a label
# may differ only where the plain logits' top two lie within twice that
# bound (random weights give near ties).  f32 1e-4.

K9_CASES = [(128, 384, 1, 45), (128, 384, 2, 13), (64, 128, 1, 45), (64, 128, 2, 13),
            (256, 768, 1, 45), (256, 768, 2, 13)]


def _k9_inputs(c, h, depth, n, seed, b=4, m_dim=8, b_dim=5):
    from druggen_tpu_torch.models import Generator
    from druggen_tpu_torch.ops import fused_generator as fg

    G = Generator(act="relu", vertexes=n, edges=b_dim, nodes=m_dim, dropout=0.0, dim=c,
                  depth=depth, heads=8, mlp_ratio=h // c,
                  generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    lab = np.triu(rng.integers(0, b_dim, (b, n, n)), 1)
    z_e = np.eye(b_dim, dtype=np.float32)[lab + lab.transpose(0, 2, 1)]
    z_n = np.eye(m_dim, dtype=np.float32)[rng.integers(0, m_dim, (b, n))]
    return fg.GeneratorWeights.of(G), torch.from_numpy(z_e).cuda(), torch.from_numpy(z_n).cuda()


def _k9_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
        return
    bound = 3e-2 + 2 ** -7 * ref.abs()
    assert bool((err <= bound).all()), err.max().item()
    assert err.mean().item() <= 2e-3
    lab_g, lab_r = got.argmax(-1, keepdim=True), ref.argmax(-1, keepdim=True)
    margin = ref.gather(-1, lab_r) - ref.gather(-1, lab_g)
    assert bool(((lab_g == lab_r) | (margin <= 2 * bound.gather(-1, lab_r))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,depth,n", K9_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_generator_kernel_matches_plain(c, h, depth, n, dtype):
    _need_card()
    from druggen_tpu_torch.ops import fused_generator as fg

    gw, z_e, z_n = _k9_inputs(c, h, depth, n, seed=c + depth)
    z_e, z_n = z_e.to(dtype), z_n.to(dtype)
    before = fg.fused_generator_logits.launches
    got = fg.fused_generator_logits(gw, z_e, z_n, heads=8)
    torch.cuda.synchronize()
    assert fg.fused_generator_logits.launches == before + 1
    ref = fg.fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=8)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == dtype and g_.shape == r_.shape
        assert torch.isfinite(g_.float()).all()
        _k9_close(g_, r_, dtype)


@pytest.mark.cuda
def test_generator_kernel_rejects_what_it_does_not_take():
    _need_card()
    from druggen_tpu_torch.ops import fused_generator as fg

    gw, z_e, z_n = _k9_inputs(128, 384, 1, 13, seed=1)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fg.fused_generator_logits(gw, z_e.half(), z_n.half(), heads=8)
    with pytest.raises(ValueError, match="z_n"):
        fg.fused_generator_logits(gw, z_e, z_n[:, :-1], heads=8)
    with pytest.raises(ValueError, match="shared memory"):
        gw2, z_e2, z_n2 = _k9_inputs(256, 768, 1, 160, seed=1, b=1)
        fg.fused_generator_logits(gw2, z_e2, z_n2, heads=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_serves_with_use_pallas_through_k9(tmp_path, dtype):
    """One 16-graph batch of the trained r2_scale Generator on the card with
    use_pallas: K9 runs once a forward and no K1; the labels equal K9's
    plain version's on >= 99.9 % of the entries."""
    _need_card()
    import torch.nn.functional as F

    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.ops import fused_generator as fg

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
        mol_data_dir=str(tmp_path), compute_dtype=dtype, use_pallas=True,
        fused_mlp=dtype == "bfloat16", device="cuda")
    engine = InferenceEngine(cfg, vocab=vocab)
    x, a = engine.data.x[:16], engine.data.a[:16]
    before = fg.fused_generator_logits.launches, port.fused_ln_mlp_ln.launches
    n_k, e_k = engine.forward(a, x)
    torch.cuda.synchronize()
    assert (fg.fused_generator_logits.launches, port.fused_ln_mlp_ln.launches) == (
        before[0] + 1, before[1])
    tdt = engine.compute_dtype
    z_e = F.one_hot(torch.as_tensor(a).long().cuda(), engine.b_dim).to(tdt)
    z_n = F.one_hot(torch.as_tensor(x).long().cuda(), engine.m_dim).to(tdt)
    ref_n, ref_e = fg.fused_generator_logits_reference(
        engine.k9_weights.weights, engine.k9_weights.depth, z_e, z_n, heads=cfg.heads)
    same = ((n_k == ref_n.argmax(-1)).sum() + (e_k == ref_e.argmax(-1)).sum()).item()
    assert same / (n_k.numel() + e_k.numel()) >= 0.999


# --- K9 on the Hopper route (bf16, dim 128, N <= 64) -----------------------
# Each launch against its plain stage (fused_generator.PlainStages) on the
# kernel's own inputs, under K9's bf16 limits (|err| <= 3e-2 + 2^-7 |ref|,
# mean <= 2e-3: one stage's f32 sums in another order move an output by at
# most a rounding flip, which the stage's later roundings carry); the whole
# forward against the whole plain version as above, and twice for the same
# bits.

K9_ROUTE_CASES = [(45, 1, "random"), (13, 2, "random"), (64, 1, "random"), (45, 2, "random"),
                  (45, 1, "trained"), (13, 1, "trained"), (64, 1, "trained")]


def _trained_k9():
    from druggen_tpu_torch.interop.msgpack_ckpt import read_flax_checkpoint
    from druggen_tpu_torch.interop.weights import flax_generator_to_torch, to_torch_tensors
    from druggen_tpu_torch.ops import fused_generator as fg

    ckpt = os.path.join(REPO, "experiments", "r2_scale", "models",
                        "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512"
                        "_epoch35_datasetchembl_like_150k45_dropout0.0", "DrugGEN-G.ckpt")
    return fg.GeneratorWeights(*fg.extract_generator_weights(to_torch_tensors(
        flax_generator_to_torch(read_flax_checkpoint(ckpt)))))


def _k9_stage_close(what, got, ref):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all()), what
    assert bool((err <= 3e-2 + 2 ** -7 * ref.abs()).all()), (what, err.max().item())
    assert err.mean().item() <= 2e-3, (what, err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth,weights", K9_ROUTE_CASES)
def test_generator_hopper_route_launches_match_their_stages(n, depth, weights):
    _need_card()
    from druggen_tpu_torch.ops import fused_generator as fg

    gw, z_e, z_n = _k9_inputs(128, 384, depth, n, seed=n + depth, b=16)
    if weights == "trained":
        gw = _trained_k9()
    z_e, z_n = z_e.bfloat16(), z_n.bfloat16()
    assert fg.hopper_route(n, gw.dim, gw.hidden, torch.bfloat16, gw.b_dim)
    by_launch = fg.route_by_launch(gw, z_e, z_n, _k9_stage_close, heads=8)
    before = fg.fused_generator_logits.launches
    got = fg.fused_generator_logits(gw, z_e, z_n, heads=8)
    again = fg.fused_generator_logits(gw, z_e, z_n, heads=8)
    torch.cuda.synchronize()
    assert fg.fused_generator_logits.launches == before + 2
    ref = fg.fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=8)
    for g_, a_, l_, r_ in zip(got, again, by_launch, ref):
        assert torch.equal(g_, a_) and torch.equal(g_, l_)
        _k9_close(g_, r_, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.bfloat16, 65), (torch.float32, 45),
                                     (torch.bfloat16, 45)])
def test_generator_kernel_takes_the_route_by_the_rule(dtype, n, monkeypatch):
    """N 65 and f32 run the generic kernels; the route's shapes run the Hopper
    launches; both held against the plain version."""
    _need_card()
    from druggen_tpu_torch.ops import fused_generator as fg

    gw, z_e, z_n = _k9_inputs(128, 384, 1, n, seed=n, b=2)
    z_e, z_n = z_e.to(dtype), z_n.to(dtype)
    taken = []
    hopper = fg._hopper_forward
    monkeypatch.setattr(fg, "_hopper_forward", lambda *a: (taken.append(1), hopper(*a)))
    got = fg.fused_generator_logits(gw, z_e, z_n, heads=8)
    torch.cuda.synchronize()
    assert bool(taken) == (dtype == torch.bfloat16 and n <= 64)
    ref = fg.fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=8)
    for g_, r_ in zip(got, ref):
        _k9_close(g_, r_, dtype)


@pytest.mark.cuda
def test_generator_launch_plan_matches_the_library():
    """The route's libraries take it at 128/384 and not at 128/512; the
    tail block's shared memory is K1's and the edge readout's weights;
    every block fits the card."""
    _need_card()
    from druggen_tpu_torch.ops import fused_generator as fg

    lp = fg.library_plan(128, 384, 45, 8)
    assert lp["route"] and fg.hopper_route(45, 128, 384, torch.bfloat16, 5)
    assert lp["tail_smem"] > port.launch_plan(C, H, 1000, 132).fwd_smem
    assert max(lp["node_smem"], lp["attn_smem"], lp["tail_smem"]) <= port.SMEM_LIMIT
    assert not fg.library_plan(128, 512, 45, 8)["route"]
    assert not fg.hopper_route(45, 128, 512, torch.bfloat16, 5)


# --- K3 / K4: the v2 edge attention (no projections) -----------------------
# Kernel against its plain version on the same inputs, compared in f32, as
# K5/K6's outputs: bf16 |err| <= 1e-2 + 2^-7 |ref| (sums in another order
# can round to the neighbouring bf16 value), f32 1e-4 + 1e-5 |ref|.

V2_SHAPES = [(torch.bfloat16, 8, 45, 128), (torch.float32, 8, 45, 128),
             (torch.bfloat16, 4, 45, 256), (torch.bfloat16, 5, 13, 128),
             (torch.float32, 3, 50, 128),
             # one key a group and B 7; the last N of 8 and the first of 10 keys
             # a thread (K4's totals in registers at two blocks a SM, then one
             # block); the largest N the JAX rule admits at D 128 in bf16 and f32
             # and at D 256 in bf16
             (torch.bfloat16, 7, 1, 128), (torch.bfloat16, 3, 64, 128),
             (torch.bfloat16, 2, 65, 128), (torch.bfloat16, 1, 108, 128),
             (torch.float32, 1, 89, 128), (torch.bfloat16, 7, 76, 256)]


def _v2_inputs(b, n, d, dtype, seed):
    acts, _, cots = _attn_inputs(b, n, d, dtype, seed)
    return acts, cots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d", V2_SHAPES)
def test_attention_v2_fwd_kernel_matches_plain(dtype, b, n, d):
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, _ = _v2_inputs(b, n, d, dtype, seed=n * d + 2)
    before = fa.edge_attention_v2_fwd.launches
    got = fa.edge_attention_v2_fwd(*acts, 8)
    torch.cuda.synchronize()
    assert fa.edge_attention_v2_fwd.launches == before + 1
    ref = fa.edge_attention_v2_fwd_reference(*acts, 8)
    for name, g_, r_ in zip(("edge_pre", "node_agg"), got, ref):
        assert torch.isfinite(g_.float()).all(), name
        _attn_close(g_, r_, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d", V2_SHAPES)
def test_attention_v2_bwd_kernel_matches_plain(dtype, b, n, d):
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, (ge, gn) = _v2_inputs(b, n, d, dtype, seed=n * d + 3)
    before = fa.edge_attention_v2_bwd.launches
    got = fa.edge_attention_v2_bwd(*acts, ge, gn, 8)
    torch.cuda.synchronize()
    assert fa.edge_attention_v2_bwd.launches == before + 1
    ref = fa.edge_attention_v2_bwd_reference(*acts, ge, gn, 8)
    for name, g_, r_ in zip(("dq", "dk", "dv", "de"), got, ref):
        assert torch.isfinite(g_.float()).all(), name
        _attn_close(g_, r_, dtype, name)


@pytest.mark.cuda
def test_attention_v2_bwd_kernel_is_deterministic():
    """No float atomics: two calls on the same inputs give the same bits."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, (ge, gn) = _v2_inputs(16, 45, 128, torch.bfloat16, seed=11)
    first = fa.edge_attention_v2_bwd(*acts, ge, gn, 8)
    second = fa.edge_attention_v2_bwd(*acts, ge, gn, 8)
    for name, a, b in zip(("dq", "dk", "dv", "de"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_attention_v2_fwd_kernel_is_deterministic():
    """K3's sums run in a fixed order: two calls give the same bits."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, _ = _v2_inputs(16, 45, 128, torch.bfloat16, seed=13)
    first = fa.edge_attention_v2_fwd(*acts, 8)
    second = fa.edge_attention_v2_fwd(*acts, 8)
    for name, a, b in zip(("edge_pre", "node_agg"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d", [(torch.bfloat16, 8, 45, 128),
                                         (torch.float32, 1, 89, 128),
                                         (torch.bfloat16, 2, 65, 128)])
def test_attention_v2_kernels_are_one_device_launch_a_call(dtype, b, n, d):
    """Each wrapper call of K3 and of K4 is one device launch, counted by the
    profiler: K4 has no second pass and no statistics scratch to fill."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, (ge, gn) = _v2_inputs(b, n, d, dtype, seed=n + 7)
    for call, name in ((lambda: fa.edge_attention_v2_fwd(*acts, 8), "attn_v2_fwd_tma"),
                       (lambda: fa.edge_attention_v2_bwd(*acts, ge, gn, 8), "attn_v2_bwd_tma")):
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0
                   and "Memcpy" not in e.key and "Memset" not in e.key]
        assert len(kernels) == 1 and name in kernels[0][0] and kernels[0][1] == 1, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("n,d,dtype", [(45, 128, torch.bfloat16), (45, 128, torch.float32),
                                       (1, 128, torch.bfloat16), (64, 128, torch.bfloat16),
                                       (65, 128, torch.bfloat16), (108, 128, torch.bfloat16),
                                       (89, 128, torch.float32), (76, 256, torch.bfloat16)])
def test_attention_v2_launch_plan_matches_the_library(kernel, n, d, dtype):
    """v2_launch_plan's shared memory and keys a thread are the library's;
    the runtime keeps as many blocks a SM resident as the plan's grid
    assumes; the plan's item runs are the kernels'."""
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa
    from druggen_tpu_torch.ops.fused_mlp import num_sms

    plan = fa.v2_launch_plan(kernel, 512, n, d, dtype, num_sms(0))
    lib = fa.v2_library_plan(kernel, n, dtype, plan.stages)
    assert (lib["smem_bytes"], lib["kpt"]) == (plan.smem_bytes, plan.kpt), (lib, plan)
    assert lib["resident_blocks"] >= plan.blocks_per_sm, (lib, plan)
    for block in (0, 1, plan.grid // 2, plan.grid - 1):
        assert fa.v2_library_item_range(plan.items, plan.grid, block) == plan.item_range(block)


@pytest.mark.cuda
def test_edge_modulated_attention_runs_k3_and_k4_first_order_only():
    _need_card()
    from druggen_tpu_torch.ops import fused_attention as fa

    acts, _ = _v2_inputs(2, 9, 128, torch.float32, seed=12)
    leaves = [t.reshape(2, 9, 8, 16).requires_grad_() for t in acts[:3]]
    leaves.append(acts[3].reshape(2, 9, 9, 8, 16).requires_grad_())
    before = fa.edge_attention_v2_fwd.launches, fa.edge_attention_v2_bwd.launches
    ep, na = fa.edge_modulated_attention(*leaves)
    (gq,) = torch.autograd.grad(ep.square().sum() + na.sum(), leaves[0], create_graph=True)
    assert (fa.edge_attention_v2_fwd.launches, fa.edge_attention_v2_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[3])


# --- the post-training pipeline: ChemNet, the evaluator, the weight swap ----

# ChemNet on the card against the CPU, both f32 with TF32 off for the call:
# the sums of the convs and the two 350-step LSTMs run in another order
TOL_CHEMNET = (2e-4, 2e-5)      # rtol, atol


def _corpus(n):
    with open(os.path.join(REPO, "data", "chembl_like_150k.smi")) as f:
        return [line.split()[0] for _, line in zip(range(n), f)]


@pytest.mark.cuda
def test_chemnet_on_the_card_matches_the_cpu():
    _need_card()
    from druggen_tpu_torch.metrics.chemnet import ChemNet

    smiles = _corpus(96) + ["", "C"]
    card = ChemNet.random_init(0, device="cuda")
    got = card(smiles, batch_size=64)
    ref = ChemNet.random_init(0, device="cpu")(smiles, batch_size=64)
    assert got.shape == ref.shape == (97, 512)
    np.testing.assert_allclose(got, ref, rtol=TOL_CHEMNET[0], atol=TOL_CHEMNET[1])
    # a call leaves the TF32 switches as it found them
    torch.backends.cudnn.allow_tf32 = True
    card(smiles[:2])
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.cuda
def test_evaluator_forks_its_workers_after_chemnet_on_the_card(tmp_path):
    _need_card()
    from druggen_tpu_torch import evaluate
    from druggen_tpu_torch.metrics.chemnet import ChemNet

    weights = str(tmp_path / "chemnet.npz")
    ChemNet.random_init(1, device="cpu").save_npz(weights)
    smiles = _corpus(400)
    for name, part in (("gen.smi", smiles[:60]), ("ref1.smi", smiles[100:400]),
                       ("ref2.smi", smiles[60:100])):
        (tmp_path / name).write_text("\n".join(part) + "\n")
    results = evaluate.main(["--gen", str(tmp_path / "gen.smi"), "--ref1",
                             str(tmp_path / "ref1.smi"), "--ref2", str(tmp_path / "ref2.smi"),
                             "--n-jobs", "2", "--ref1-sample", "200", "--chemnet-weights",
                             weights, "--output", str(tmp_path / "res")])
    assert results["fcd_is_literal"] is True and math.isfinite(results["fcd_ref1"])
    assert 0 < results["internal_diversity"] < 1 and results["validity"] == 1.0


@pytest.mark.cuda
def test_engine_weight_swap_under_use_pallas_serves_the_new_weights(tmp_path):
    """K9 serves a swapped-in checkpoint: the labels equal those of an
    engine built with it, and differ from the first weights'."""
    _need_card()
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.ops import fused_generator as fg
    from druggen_tpu_torch.train.checkpoint import load_params_auto

    smi = tmp_path / "inf.smi"
    smi.write_text("\n".join(_corpus(64)) + "\n")
    with open(os.path.join(REPO, "data", "cache", "vocab",
                           "vocab_akt1_drugs_chembl_like_150k_45.json")) as f:
        vocab = Vocab.from_json(f.read())
    ckpt_dir = os.path.join(
        REPO, "experiments", "r2_scale", "models",
        "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512"
        "_epoch35_datasetchembl_like_150k45_dropout0.0")
    trained = load_params_auto(os.path.join(ckpt_dir, "DrugGEN-G.ckpt"))
    g = torch.Generator().manual_seed(0)
    other = {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
             for k, v in trained.items()}
    cfg = InferenceConfig(
        inference_model=ckpt_dir, inf_smiles=str(smi), train_smiles=str(smi),
        train_drug_smiles=str(smi), mol_data_dir=str(tmp_path), compute_dtype="bfloat16",
        use_pallas=True, device="cuda")
    engine = InferenceEngine(cfg, vocab=vocab, g_state_dict=trained)
    x, a = engine.data.x[:16], engine.data.a[:16]
    first = engine.forward(a, x)
    engine.load_generator(other)
    before = fg.fused_generator_logits.launches
    swapped = engine.forward(a, x)
    assert fg.fused_generator_logits.launches == before + 1
    want = InferenceEngine(cfg, vocab=vocab, g_state_dict=other).forward(a, x)
    for got, ref in zip(swapped, want):
        assert torch.equal(got, ref)
    assert any(not torch.equal(f, s) for f, s in zip(first, swapped))

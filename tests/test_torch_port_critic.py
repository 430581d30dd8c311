"""The port's Discriminator, its parameter bridge, and the numerics switches
of training, against the JAX package on the CPU.

Same numpy-seeded parameters and inputs in both packages; f32 logits to
1e-5 (same math, sums in another order).  Skipping the critic's dead
last-block edge stream changes nothing: bit-equal on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.models import Discriminator as JaxDiscriminator
from druggen_tpu_torch.interop.weights import (
    flax_discriminator_to_torch,
    to_torch_tensors,
    torch_discriminator_to_flax,
)
from druggen_tpu_torch.models import Discriminator, EncoderBlock, numerics
from druggen_tpu_torch.models.layers import GraphMHA, init_torch_style_
from druggen_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

B, N, M_DIM, B_DIM, DIM, HEADS = 3, 7, 5, 4, 16, 4


def _pair(depth, head_mult=1, seed=0):
    jd = JaxDiscriminator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM,
                          dropout=0.0, dim=DIM, depth=depth, heads=HEADS,
                          mlp_ratio=2, head_mult=head_mult)
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(B, N, N, B_DIM)).astype(np.float32)
    n = rng.normal(size=(B, N, M_DIM)).astype(np.float32)
    variables = jd.init(jax.random.PRNGKey(seed), jnp.asarray(e), jnp.asarray(n))
    variables = jax.device_get(variables)
    pd = Discriminator("relu", N, B_DIM, M_DIM, 0.0, DIM, depth, HEADS, 2,
                       head_mult=head_mult)
    pd.load_state_dict(to_torch_tensors(flax_discriminator_to_torch(variables)))
    return jd, variables, pd, e, n


@pytest.mark.parametrize("depth,head_mult", [(1, 1), (2, 1), (2, 2)])
def test_discriminator_matches_flax(depth, head_mult):
    jd, variables, pd, e, n = _pair(depth, head_mult)
    ref = np.asarray(jd.apply(variables, jnp.asarray(e), jnp.asarray(n)))
    with torch.no_grad():
        got = pd(torch.from_numpy(e), torch.from_numpy(n)).numpy()
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_discriminator_params_both_ways():
    _, variables, pd, _, _ = _pair(2, seed=1)
    sd = flax_discriminator_to_torch(variables)
    assert sorted(sd) == sorted(pd.state_dict())
    assert {f"node_mlp.{i}.weight" for i in (0, 2, 4, 6)} <= set(sd)
    back = torch_discriminator_to_flax(pd.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


@pytest.mark.parametrize("depth", [1, 2])
def test_skipping_the_dead_edge_stream_changes_nothing(depth):
    """The head reads only the node stream: the last block's out_e readout
    and edge tail are skipped, with bit-equal logits and input gradients."""
    _, _, pd, e, n = _pair(depth, seed=2)
    outs = []
    for need in (False, True):
        et = torch.from_numpy(e).requires_grad_()
        nt = torch.from_numpy(n).requires_grad_()
        logits = pd(et, nt, need_last_edge=need)
        outs.append((logits,) + torch.autograd.grad(logits.sum(), (et, nt)))
    for skipped, full in zip(*outs):
        assert torch.equal(skipped, full)


def test_numerics_switches_share_the_parameters():
    _, _, pd, e, n = _pair(2, seed=3)
    params = list(pd.parameters())
    block = pd.TransformerEncoder.Encoder_Blocks[0]
    with numerics(pd, dtype=torch.bfloat16, fused_mlp=True, f32_stats=True):
        assert block.fused_mlp and block.f32_stats
        assert block.ln1.dtype == torch.bfloat16 and block.attn.q.dtype == torch.bfloat16
        out = pd(torch.from_numpy(e).bfloat16(), torch.from_numpy(n).bfloat16())
        assert out.dtype == torch.bfloat16
    assert not block.fused_mlp and not block.f32_stats and block.ln1.dtype is None
    assert all(a is b for a, b in zip(params, pd.parameters()))


def _block(seed=0):
    blk = EncoderBlock(DIM, HEADS, 2, 0.0, torch.bfloat16)
    init_torch_style_(blk, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, N, DIM)).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rng.normal(size=(B, N, N, DIM)).astype(np.float32)).bfloat16()
    return blk, x, y


def test_f32_stats_turns_the_fused_tail_off(monkeypatch):
    """JAX layers.py:321-322: under f32_stats the block takes the plain tail
    even with fused_mlp on; the attention keeps the compute dtype outside
    its f32 softmax (layers.py:221-227)."""
    blk, x, y = _block()
    calls = []
    orig = fused_mlp.FusedLnMlpLn.apply
    monkeypatch.setattr(fused_mlp.FusedLnMlpLn, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    with torch.no_grad(), numerics(blk, fused_mlp=True, f32_stats=True):
        got = blk(x, y)
    with torch.no_grad(), numerics(blk, fused_mlp=False, f32_stats=True):
        ref = blk(x, y)
    with torch.no_grad(), numerics(blk, fused_mlp=True, f32_stats=False):
        blk(x, y)
    assert len(calls) == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    mha = GraphMHA(DIM, HEADS, torch.bfloat16, f32_stats=True)
    init_torch_style_(mha, torch.Generator().manual_seed(1))
    with torch.no_grad():
        node, edge = mha(x, y)
    assert node.dtype == edge.dtype == torch.bfloat16


def test_dropout_is_active_in_train_mode_only():
    blk = EncoderBlock(DIM, HEADS, 2, 0.5, None, fused_mlp=True)
    init_torch_style_(blk, torch.Generator().manual_seed(0))
    x = torch.randn(B, N, DIM, generator=torch.Generator().manual_seed(1))
    y = torch.randn(B, N, N, DIM, generator=torch.Generator().manual_seed(2))
    blk.train()
    with torch.no_grad():
        a, b = blk(x, y), blk(x, y)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    blk.eval()
    with torch.no_grad():
        a, b = blk(x, y), blk(x, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

"""The fused edge tail at every width in the PyTorch port, on the CPU.

K1/K2 take their widths C and H from the build, one library a width.  On the
card a bf16 width whose weights do not fit the 227 KB of shared memory an SM
gives a block beside its buffers reads them through L2
(``test_torch_port_card.py``).  On the CPU a ``fused_mlp`` block runs K1/K2's
plain versions at every width, the narrow ones and the wide ones alike, so
it keeps the
Pallas kernel's rounding points: a bf16 block at dim 160 / mlp_ratio 5 is
held against the flax block with ``fused_mlp`` (the Pallas kernel in the
interpreter) from converted weights.  Tolerance bf16: atol 3e-2 + rtol 2^-7
on the outputs compared in f32 (``test_torch_port_fused_mlp.py``'s bf16
limit: the same rounding points, f32 sums in another order, here after a
bf16 attention whose sums also run in another order), and mean |err| of
the edge output at most 1e-3: the port's fused block reads 5.0e-4 there,
its plain composite tail, which rounds elsewhere, 1.7e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.models.layers import EncoderBlock as FlaxEncoderBlock
from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.models import EncoderBlock
from druggen_tpu_torch.models.layers import init_torch_style_
from druggen_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)


def _inputs(dim, n=5, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, n, dim)).astype(np.float32),
            rng.normal(size=(2, n, n, dim)).astype(np.float32))


def _count_tails(monkeypatch):
    calls = []
    orig = fused_mlp.FusedLnMlpLn.apply
    monkeypatch.setattr(fused_mlp.FusedLnMlpLn, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    return calls


@pytest.mark.parametrize("dim,ratio", [(64, 3), (96, 2), (128, 4), (160, 5), (256, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_block_runs_the_fused_tail_at_every_width(dim, ratio, dtype, monkeypatch):
    """One route at every width: the fused tail (K1/K2's plain versions
    here); its node output is the plain block's, its edge output the plain
    block's up to the rounding points (f32: 1e-5)."""
    calls = _count_tails(monkeypatch)
    blk = EncoderBlock(dim, 8, ratio, 0.0, None if dtype == torch.float32 else dtype,
                       fused_mlp=True)
    init_torch_style_(blk, torch.Generator().manual_seed(0))
    x, y = (torch.from_numpy(a).to(dtype) for a in _inputs(dim))
    with torch.no_grad():
        xf, yf = blk(x, y)
        assert len(calls) == 1
        blk.fused_mlp = False
        xp, yp = blk(x, y)
        assert len(calls) == 1
    assert torch.equal(xf, xp)
    if dtype == torch.float32:
        torch.testing.assert_close(yf, yp, atol=1e-5, rtol=1e-5)
    else:
        # the fused tail keeps f32 inside where the plain bf16 block rounds
        torch.testing.assert_close(yf.float(), yp.float(), atol=0.1, rtol=0.05)


def test_wide_bf16_fused_block_matches_flax(monkeypatch):
    """dim 160 / mlp_ratio 5 in bf16 (too wide for the card's kernels to
    stage their weights; they read them through L2): the port's fused block
    against flax's
    with ``fused_mlp``, from one flax init."""
    dim, ratio = 160, 5
    node, edge = _inputs(dim)
    flax_blk = FlaxEncoderBlock(dim, 8, ratio, dtype=jnp.bfloat16, fused_mlp=True)
    jn, je = jnp.asarray(node, jnp.bfloat16), jnp.asarray(edge, jnp.bfloat16)
    variables = flax_blk.init(jax.random.PRNGKey(3), jn, je)
    want = [np.asarray(t.astype(jnp.float32)) for t in flax_blk.apply(variables, jn, je)]
    calls = _count_tails(monkeypatch)
    blk = EncoderBlock(dim, 8, ratio, 0.0, torch.bfloat16, fused_mlp=True)
    blk.load_state_dict(weights.to_torch_tensors(
        weights.flax_encoder_block_to_torch(variables)))
    blk.eval()
    x, y = (torch.from_numpy(a).bfloat16() for a in (node, edge))
    with torch.no_grad():
        got = [t.float().numpy() for t in blk(x, y)]
    assert len(calls) == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=2 ** -7)
    assert np.abs(got[1] - want[1]).mean() <= 1e-3

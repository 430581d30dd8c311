"""Layers and Generator of the PyTorch port against the flax modules.

Parameters come from the flax init and are carried into the port with
``druggen_tpu_torch.interop.weights``; inputs are numpy draws from a seed.
Everything runs in f32 on the CPU (the Pallas edge-tail kernel through its
interpreter), at the interop test sizes (dim 32, 4 heads, depth 2, N 9,
batch 3).  Tolerances: 1e-5 per layer, 1e-4 for the Generator (two blocks
and two readouts of f32 rounding in another order).  Independent numpy
statements of the reference's quirky math pin the per-channel attention,
the residual on the normed input and the edge symmetrisation.
"""

import numpy as np
import pytest
import torch

import jax

from druggen_tpu.models.layers import MLP as FlaxMLP
from druggen_tpu.models.layers import EncoderBlock as FlaxEncoderBlock
from druggen_tpu.models.layers import GraphMHA as FlaxGraphMHA
from druggen_tpu.models.models import Generator as FlaxGenerator
from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.models import MLP, EncoderBlock, Generator, GraphMHA

torch.set_num_threads(1)

DIM, HEADS, DEPTH, MLP_RATIO = 32, 4, 2, 3
B, N, M_DIM, B_DIM = 3, 9, 8, 5


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(module, sd):
    module.load_state_dict(weights.to_torch_tensors(sd))
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


# --- independent numpy statements of the reference math -------------------

def _np_linear(p, name, x):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def _np_ln(p, name, x):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-5) * p[name + ".weight"] + p[name + ".bias"]


def _np_mha(p, node, edge, heads, pre=""):
    b, n, c = node.shape
    dk = c // heads
    q = _np_linear(p, pre + "q", node).reshape(b, n, heads, dk)
    k = _np_linear(p, pre + "k", node).reshape(b, n, heads, dk)
    v = _np_linear(p, pre + "v", node).reshape(b, n, heads, dk)
    e = _np_linear(p, pre + "e", edge).reshape(b, n, n, heads, dk)
    attn = np.einsum("bihd,bjhd->bijhd", q, k) / np.sqrt(dk)   # per channel
    attn = attn * (e + 1.0) * e
    edge_out = _np_linear(p, pre + "out_e", attn.reshape(b, n, n, c))
    w = np.exp(attn - attn.max(axis=2, keepdims=True))
    w = w / w.sum(axis=2, keepdims=True)                      # over keys j
    agg = np.einsum("bijhd,bjhd->bihd", w, v).reshape(b, n, c)
    return _np_linear(p, pre + "out_n", agg), edge_out


def _np_mlp(p, pre, x):
    h = np.maximum(_np_linear(p, pre + ".fc1", x), 0.0)
    return _np_linear(p, pre + ".fc2", h)


def _np_block(p, x, y, heads):
    x1 = _np_ln(p, "ln1", x)
    x2, y1 = _np_mha(p, x1, y, heads, pre="attn.")
    x2 = _np_ln(p, "ln3", x1 + x2)        # residual on the NORMED input
    x = _np_ln(p, "ln5", x2 + _np_mlp(p, "mlp", x2))
    y2 = _np_ln(p, "ln4", y + y1)
    return x, _np_ln(p, "ln6", y2 + _np_mlp(p, "mlp2", y2))


# --- fixtures: one flax init + apply per module kind ------------------------

@pytest.fixture(scope="module")
def node_edge():
    return _normal(1, B, N, DIM), _normal(2, B, N, N, DIM)


def test_mlp_matches_flax():
    x = _normal(3, B, N, DIM)
    mod = FlaxMLP(DIM, DIM * MLP_RATIO, DIM)
    variables = mod.init(jax.random.PRNGKey(0), x)
    port = _load(MLP(DIM, DIM * MLP_RATIO, DIM),
                 weights.flax_mlp_to_torch(variables))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(mod.apply(variables, x)),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def mha(node_edge):
    node, edge = node_edge
    mod = FlaxGraphMHA(DIM, HEADS)
    variables = mod.init(jax.random.PRNGKey(1), node, edge)
    port = _load(GraphMHA(DIM, HEADS), weights.flax_mha_to_torch(variables))
    want = [np.asarray(t) for t in mod.apply(variables, node, edge)]
    with torch.no_grad():
        got = [t.numpy() for t in port(_t(node), _t(edge))]
    return port, got, want


def test_graph_mha_matches_flax(mha):
    _, got, want = mha
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_graph_mha_pins_reference_quirks(mha, node_edge):
    """Element-wise q*k per channel, (e+1)*e, out_e read before the softmax,
    softmax over keys per channel (druggen_tpu/models/layers.py:217-235)."""
    port, got, _ = mha
    node, edge = node_edge
    want = _np_mha(_np_state(port), node.astype(np.float64),
                   edge.astype(np.float64), HEADS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def blocks(node_edge):
    """flax EncoderBlock outputs with fused_mlp off and on (the latter
    through the Pallas interpreter), from one parameter set."""
    node, edge = node_edge
    ref = FlaxEncoderBlock(DIM, HEADS, MLP_RATIO)
    variables = ref.init(jax.random.PRNGKey(2), node, edge)
    sd = weights.flax_encoder_block_to_torch(variables)
    out = {}
    for fused in (False, True):
        mod = FlaxEncoderBlock(DIM, HEADS, MLP_RATIO, fused_mlp=fused)
        out[fused] = [np.asarray(t) for t in mod.apply(variables, node, edge)]
    return sd, out


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_block_matches_flax(blocks, node_edge, fused):
    sd, want = blocks
    node, edge = node_edge
    port = _load(EncoderBlock(DIM, HEADS, MLP_RATIO, fused_mlp=fused), sd)
    with torch.no_grad():
        got = [t.numpy() for t in port(_t(node), _t(edge))]
    for g, w in zip(got, want[fused]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_encoder_block_pins_normed_residual(blocks, node_edge):
    """x2 = ln3(x1 + attn(x1)) with x1 = ln1(x), not x + attn(x1)
    (druggen_tpu/models/layers.py:309-310)."""
    sd, want = blocks
    node, edge = node_edge
    p = {k: np.asarray(v, np.float64) for k, v in sd.items()}
    got = _np_block(p, node.astype(np.float64), edge.astype(np.float64), HEADS)
    for g, w in zip(got, want[False]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def generators():
    z_e, z_n = _normal(4, B, N, N, B_DIM), _normal(5, B, N, M_DIM)
    kw = dict(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=DEPTH, heads=HEADS, mlp_ratio=MLP_RATIO)
    flax_g = FlaxGenerator(**kw)
    variables = flax_g.init(jax.random.PRNGKey(3), z_e, z_n)
    want = {f: [np.asarray(t) for t in
                FlaxGenerator(**kw, fused_mlp=f).apply(variables, z_e, z_n)]
            for f in (False, True)}
    sd = weights.flax_generator_to_torch(variables)
    return kw, sd, (z_e, z_n), want


@pytest.mark.parametrize("fused", [False, True])
def test_generator_matches_flax(generators, fused):
    kw, sd, (z_e, z_n), want = generators
    port = _load(Generator(**kw, fused_mlp=fused), sd)
    with torch.no_grad():
        got = [t.numpy() for t in port(_t(z_e), _t(z_n))]
    names = ("node", "edge", "node_logits", "edge_logits")
    for name, g, w in zip(names, got, want[fused]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)


def test_generator_symmetrises_edges(generators):
    """(e+eᵀ)/2 after the per-edge input MLP (druggen_tpu/models/models.py:81)
    makes the Generator blind to transposing z_e."""
    kw, sd, (z_e, z_n), _ = generators
    port = _load(Generator(**kw), sd)
    with torch.no_grad():
        a = port(_t(z_e), _t(z_n))
        b = port(_t(z_e).transpose(1, 2), _t(z_n))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    assert not np.allclose(z_e, z_e.transpose(0, 2, 1, 3))


def test_state_dict_round_trip(generators):
    """flax tree -> port state_dict -> flax tree is exact and the port's
    parameter names are the reference torch layout."""
    kw, sd, _, _ = generators
    port = _load(Generator(**kw), sd)
    assert set(port.state_dict()) == set(sd)
    back = weights.torch_generator_to_flax(port.state_dict())
    again = weights.flax_generator_to_torch(back)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k])


def test_bf16_generator_follows_f32(generators):
    """The port's bf16 path (flax dtype semantics: bf16 Dense, f32
    LayerNorm) stays close to its f32 path; the fused and unfused bf16
    tails agree to bf16 rounding."""
    kw, sd, (z_e, z_n), _ = generators
    out = {}
    for dtype, fused in ((None, False), (torch.bfloat16, False),
                         (torch.bfloat16, True)):
        g = _load(Generator(**kw, dtype=dtype, fused_mlp=fused), sd)
        dt = dtype or torch.float32
        with torch.no_grad():
            out[dtype, fused] = [t.float() for t in g(_t(z_e).to(dt), _t(z_n).to(dt))]
        assert all(t.dtype == dt for t in g(_t(z_e).to(dt), _t(z_n).to(dt)))
    for f32, b16 in zip(out[None, False], out[torch.bfloat16, False]):
        assert (f32 - b16).abs().max().item() < 0.25
    for plain, fused in zip(out[torch.bfloat16, False], out[torch.bfloat16, True]):
        assert (plain - fused).abs().max().item() < 0.25


def test_generator_init_is_seeded():
    kw = dict(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=MLP_RATIO)
    a = Generator(**kw, generator=torch.Generator().manual_seed(5))
    b = Generator(**kw, generator=torch.Generator().manual_seed(5))
    c = Generator(**kw, generator=torch.Generator().manual_seed(6))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], atol=0, rtol=0)
    w = "node_layers.0.weight"
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    bound = 1 / np.sqrt(M_DIM)
    assert a.state_dict()[w].abs().max().item() <= bound

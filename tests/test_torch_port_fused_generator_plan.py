"""K9's Hopper route on the CPU: the shape rule, the launch plan and the
plain version by launch.

The kernels run on the card only (``tests/test_torch_port_card.py``); what
surrounds them is pure Python and is checked here: which shapes take the
route (:func:`fused_generator.hopper_route`), that the plan's grids, under
the kernels' partition rules, give every slab and every flat tail tile to
one warpgroup at ragged N and several batch sizes, the scratch it asks
for, and that the plain stages (:class:`fused_generator.PlainStages`), run
in place of the route's launches by ``route_by_launch`` (every
intermediate handed on in the stream dtype, the edge rows in one flat
[B N N, C] buffer), give the whole plain version's logits bit for bit.
The whole plain version is held against the Pallas kernel by
``tests/test_torch_port_fused_generator.py``; no JAX runs here.
"""

import numpy as np
import pytest
import torch

from druggen_tpu_torch.models import Generator
from druggen_tpu_torch.ops import fused_generator as fg

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,c,h,n,b_dim,taken", [
    (BF16, 128, 384, 45, 5, True),      # the published serving shape
    (BF16, 128, 384, 64, 5, True),      # N fills the slab tile
    (BF16, 128, 384, 1, 5, True),
    (BF16, 128, 384, 13, 7, True),      # the widest edge readout that is staged
    (BF16, 128, 256, 45, 5, True),      # mlp_ratio 2: staged
    (BF16, 128, 192, 9, 4, True),
    (BF16, 128, 384, 65, 5, False),     # N past the tile: the generic kernels
    (F32, 128, 384, 45, 5, False),      # the f32 twin
    (BF16, 128, 512, 45, 5, False),     # mlp_ratio 4: K1 streams its weights
    (BF16, 128, 200, 45, 5, False),     # a hidden not in 64-column chunks
    (BF16, 64, 128, 45, 5, False),      # other widths
    (BF16, 256, 768, 45, 5, False),
    (BF16, 128, 384, 45, 8, False),     # an edge readout too wide to stage
    (torch.float16, 128, 384, 45, 5, False),
])
def test_route_rule(dtype, c, h, n, b_dim, taken):
    assert fg.hopper_route(n, c, h, dtype, b_dim) is taken


@pytest.mark.parametrize("n", [9, 13, 45, 64])
@pytest.mark.parametrize("batch,num_sms", [(1, 132), (3, 132), (7, 5), (512, 132)])
def test_plan_covers_every_slab_and_row_once(n, batch, num_sms):
    """The plan's grids under the kernels' own partition rules (the
    attention: block ``blk`` takes the slabs ``[slabs * blk // grid,
    slabs * (blk + 1) // grid)``, ``blk::SlabRange``, its warpgroups every
    second of them; the tail: warpgroup ``wg`` of block ``blk`` the tiles
    ``blk * 2 + wg``, then every ``grid * 2``-th, ``ftile::tail_fwd_tiles``)
    give every slab and every flat tile to exactly one warpgroup, leave no
    block without work, and the valid rows cover every edge row once."""
    plan = fg.launch_plan(128, 384, batch, n, 1, num_sms)
    wgs = plan.warpgroups
    assert plan.slabs == batch * n and plan.rows == batch * n * n and wgs == 2
    assert plan.attn_grid == min(num_sms, plan.slabs) and plan.tail_grid <= num_sms
    seen = np.zeros(plan.slabs, np.int64)
    for blk in range(plan.attn_grid):
        begin = plan.slabs * blk // plan.attn_grid
        end = plan.slabs * (blk + 1) // plan.attn_grid
        assert end > begin
        for wg in range(wgs):
            seen[begin + wg:end:wgs] += 1
    assert (seen == 1).all()
    rows = np.zeros(plan.rows, np.int64)
    for slab in range(plan.slabs):      # a slab's valid rows: its N keys
        rows[slab * n:slab * n + n] += 1
    assert (rows == 1).all() and n <= fg.TILE_ROWS
    tiles = np.zeros(plan.tiles, np.int64)
    for blk in range(plan.tail_grid):
        assert blk * wgs < plan.tiles
        for wg in range(wgs):
            tiles[blk * wgs + wg::plan.tail_grid * wgs] += 1
    assert (tiles == 1).all()
    assert (plan.tiles - 1) * fg.TILE_ROWS < plan.rows <= plan.tiles * fg.TILE_ROWS


@pytest.mark.parametrize("batch,n,depth", [(512, 45, 1), (64, 13, 2), (5, 9, 3)])
def test_plan_scratch_and_launches(batch, n, depth):
    c = 128
    plan = fg.launch_plan(c, 384, batch, n, depth, 132)
    # bf16: x1, q, k, v, agg per atom; one flat buffer of edge rows (s, and
    # the rows between depths, written in place)
    assert plan.node_scratch_bytes == 5 * batch * n * c * 2
    assert plan.edge_scratch_bytes == batch * n * n * c * 2
    assert plan.device_launches == 3 * depth + 1
    assert plan.node_blocks == batch
    assert plan.tiles == -(-batch * n * n // 64)
    if (batch, n) == (512, 45):   # the serving shape: 0.25 GiB of edge scratch
        assert plan.edge_scratch_bytes == 265_420_800
        assert (plan.attn_grid, plan.tail_grid) == (132, 132)


def test_plan_rejects_what_it_does_not_take():
    for args in ((0, 384, 4, 9, 1), (128, 384, 4, 0, 1), (128, 384, 4, 9, 0),
                 (128, 384, -1, 9, 1)):
        with pytest.raises(ValueError):
            fg.launch_plan(*args, 132)


def _inputs(depth, n, seed, dim=16, heads=4, m_dim=12, b_dim=5, b=3):
    G = Generator(act="relu", vertexes=n, edges=b_dim, nodes=m_dim, dropout=0.0, dim=dim,
                  depth=depth, heads=heads, mlp_ratio=3,
                  generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    lab = np.triu(rng.integers(0, b_dim, (b, n, n)), 1)
    z_e = np.eye(b_dim, dtype=np.float32)[lab + lab.transpose(0, 2, 1)]
    z_n = np.eye(m_dim, dtype=np.float32)[rng.integers(0, m_dim, (b, n))]
    return fg.GeneratorWeights.of(G), torch.from_numpy(z_e), torch.from_numpy(z_n)


def _plain_passes(monkeypatch, gw, dt, heads):
    """The route's three launch functions replaced by their plain stages,
    reading and writing the same buffers in the stream dtype (the edge rows
    in one flat [B N N, C] buffer, written over s in place)."""
    st = fg.PlainStages(gw.weights, gw.depth, dt, "cpu", heads=heads)

    def node_pass(_, d, z_n, node, out_n):
        if d == gw.depth:
            out_n.copy_(st.node(d, x1=node[0], agg=node[4]))
            return
        outs = st.node(0, z_n) if d == 0 else st.node(d, x1=node[0], agg=node[4])
        for i, t in enumerate(outs):
            node[i] = t

    def edge_attention_pass(_, d, z_e, node, ys, heads):
        b, n = z_e.shape[:2]
        y = ys.reshape(b, n, n, -1) if d else None
        s, agg = st.edge_attention(d, node[1], node[2], node[3], y=y, z_e=z_e)
        ys.copy_(s.reshape(ys.shape))
        node[4] = agg

    def edge_tail_pass(_, d, ys, out_e):
        b, n = out_e.shape[:2]
        rows = st.edge_tail(d, ys.reshape(b, n, n, -1))
        dst = out_e if d == gw.depth - 1 else ys
        dst.copy_(rows.reshape(dst.shape))

    for name, fn in (("node_pass", node_pass), ("edge_attention_pass", edge_attention_pass),
                     ("edge_tail_pass", edge_tail_pass)):
        monkeypatch.setattr(fg, name, fn)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("n", [9, 13])
def test_stages_in_route_order_are_the_whole_plain_version(depth, dtype, n, monkeypatch):
    """route_by_launch with each launch replaced by its plain stage: every
    launch's output is its stage's bit for bit, and the logits are the whole
    plain version's."""
    gw, z_e, z_n = _inputs(depth, n, seed=depth * 10 + n)
    z_e, z_n = z_e.to(dtype), z_n.to(dtype)
    want = fg.fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=4)
    _plain_passes(monkeypatch, gw, dtype, heads=4)
    seen = []

    def check(label, got, ref):
        assert got.dtype == dtype and got.shape == ref.shape, label
        assert torch.equal(got.float(), ref), label
        seen.append(label.split(" ")[0])

    got = fg.route_by_launch(gw, z_e, z_n, check, heads=4)
    assert seen.count("attention") == 2 * depth and seen.count("tail") == depth
    assert seen.count("node") == 4 * depth + 1     # x1, q, k, v a depth; the node logits
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype and g_.shape == w_.shape
        assert torch.equal(g_, w_)


def test_stages_hand_on_stream_values():
    """Every stage's output is a stream-dtype value held in f32, so handing
    it on in bf16 (as the kernels store it) loses nothing."""
    gw, z_e, z_n = _inputs(2, 9, seed=3)
    z_e, z_n = z_e.to(BF16), z_n.to(BF16)
    st = fg.PlainStages(gw.weights, gw.depth, BF16, "cpu", heads=4)
    x1, q, k, v = st.node(0, z_n)
    s, agg = st.edge_attention(0, q, k, v, z_e=z_e)
    y = st.edge_tail(0, s)
    outs = (x1, q, k, v, s, agg, y, st.node(1, x1=x1, agg=agg)[0],
            st.edge_input(z_e))
    for t in outs:
        assert t.dtype == F32
        assert torch.equal(t, t.to(BF16).float())
    assert st.edge_tail(1, s).shape == (*z_e.shape[:3], gw.b_dim)
    assert st.node(2, x1=x1, agg=agg).shape == z_n.shape


def test_reference_rejects_depth_zero():
    gw, z_e, z_n = _inputs(1, 9, seed=4)
    with pytest.raises(ValueError, match="depth"):
        fg.fused_generator_logits_reference(gw.weights, 0, z_e, z_n, heads=4)


def test_packed_offsets_have_a_host_copy():
    """The route's launches take their parameters' addresses from host
    copies of the packed offsets: the same numbers as the device's."""
    gw, _, _ = _inputs(2, 9, seed=5)
    pk = gw.packed(BF16, "cpu")
    assert pk.woff_host.device.type == "cpu" and pk.voff_host.device.type == "cpu"
    assert torch.equal(pk.woff_host, pk.woff.cpu()) and torch.equal(pk.voff_host, pk.voff.cpu())
    # 4 input-MLP, 10 per depth and 2 readout matrices; 4 + 20 per depth + 2 vectors
    assert len(pk.woff_host) == 4 + 10 * 2 + 2 and len(pk.voff_host) == 4 + 20 * 2 + 2


def test_launches_check_their_buffers_before_any_pointer_is_passed():
    """The route's launch functions refuse a buffer that is not on the card,
    not contiguous, or of another shape or dtype, before they load a
    library."""
    gw, z_e, z_n = _inputs(1, 9, seed=6)
    b, n = z_e.shape[:2]
    node = torch.empty(5, b, n, gw.dim, dtype=BF16)
    ys = torch.empty(b * n * n, gw.dim, dtype=BF16)
    out_e = torch.empty(b, n, n, gw.b_dim, dtype=BF16)
    with pytest.raises(ValueError, match="cuda"):
        fg.edge_attention_pass(gw, 0, z_e.to(BF16), node, ys, heads=4)
    with pytest.raises(ValueError, match="cuda"):
        fg.edge_tail_pass(gw, 0, ys, out_e)
    with pytest.raises(ValueError, match="cuda"):
        fg.node_pass(gw, 0, z_n.to(BF16), node, torch.empty(b, n, gw.m_dim, dtype=BF16))
    with pytest.raises(ValueError, match="expected"):
        fg.edge_tail_pass(gw, 0, ys[:-1], out_e)

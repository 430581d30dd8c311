"""The bf16 K5/K6 launch plan (``ops/fused_attention.py::launch_plan``), on the CPU.

The plan is the Hopper kernels' geometry in plain arithmetic (the card test
``test_attention_launch_plan_matches_the_library`` holds it against the
libraries, whose shared memory is not recomputed in Python).  Here: which
shapes and types take the Hopper route (``hopper_route``, the wrapper's
shape rule) and that the JAX rule lets them reach it; that the graphs, the
slab tiles and the blocks' runs of slabs cover every edge row of a ragged
batch exactly once (N from 1 to 64, and batch 0); that K6's node pass
covers every dk/dv element once; that the wgrad row chunks cover the rows
and its tiles and partials cover dWe, dWoe, dbe and dboe; and the
training-shape plan and scratch.  No JAX, no compile.
"""

import pytest
import torch

from druggen_tpu_torch.ops.fused_attention import (
    GRADIENT_SOURCES,
    PAIR_THREADS,
    TILE_ROWS,
    WGRAD_ROWS,
    hopper_route,
    launch_plan,
    uses_kernel,
)

SMS = 132   # H100 SXM
# (batch, N): the training shape, ragged N from 1 to 64, more graphs than
# blocks and fewer, and no graph at all
BATCHES = [(512, 45), (3, 1), (5, 13), (2, 64), (1, 45), (7, 63), (200, 20), (4, 33),
           (0, 45)]


@pytest.mark.parametrize("n,d,dtype,hopper", [
    (45, 128, torch.bfloat16, True), (64, 128, torch.bfloat16, True),
    (1, 128, torch.bfloat16, True), (13, 128, torch.bfloat16, True),
    (65, 128, torch.bfloat16, False), (70, 128, torch.bfloat16, False),
    (45, 256, torch.bfloat16, False), (45, 512, torch.bfloat16, False),
    (45, 128, torch.float32, False), (13, 128, torch.float32, False),
    (45, 64, torch.bfloat16, False)])
def test_the_hopper_route_takes_bf16_d_128_and_n_at_most_64(n, d, dtype, hopper):
    """bf16 at D 128 and 1 <= N <= 64 runs on wgmma; f32, any other D and
    N > 64 take the CUDA-core kernels; the plan's geometry says the same."""
    assert hopper_route(n, d, dtype) is hopper
    assert launch_plan(d, 8, n, SMS).hopper is (d == 128 and n <= TILE_ROWS)


@pytest.mark.parametrize("n", [1, 13, 45, 64])
def test_the_jax_rule_lets_every_hopper_shape_reach_the_kernels(n):
    """The JAX routing rule (``uses_kernel``) sends every Hopper-route shape
    to the fused op, so the Hopper kernels are what the model runs there."""
    assert uses_kernel(n, 128, torch.bfloat16) and hopper_route(n, 128, torch.bfloat16)


@pytest.mark.parametrize("batch,n", BATCHES)
def test_graphs_and_slab_tiles_cover_every_row_once(batch, n):
    """Slab g = (b, i) belongs to graph g // N and its tile holds edge rows
    g N .. g N + N - 1 (the other 64 - N rows are padding); the blocks'
    contiguous runs of slabs cover every slab once, so every edge row is
    computed and stored exactly once, and each graph's N slabs are its own."""
    plan = launch_plan(128, batch, n, SMS)
    assert plan.tile_rows == TILE_ROWS and n <= plan.tile_rows
    slabs = []
    for block in range(plan.grid):
        begin, end = plan.slab_range(block)
        assert 0 <= begin <= end <= plan.slabs
        slabs += range(begin, end)
    assert slabs == list(range(plan.slabs))
    sizes = [plan.slab_range(x)[1] - plan.slab_range(x)[0] for x in range(plan.grid)]
    assert max(sizes) - min(sizes) <= 1            # balanced runs
    covered = [r for g in slabs for r in range(*plan.tile_rows_of(g))]
    assert covered == list(range(plan.rows))
    graphs = [plan.graph_of(g) for g in slabs]
    assert graphs == [b for b in range(batch) for _ in range(n)]
    assert plan.pad_share == pytest.approx(1 - n / TILE_ROWS)
    # the block's warpgroups split its run between them, once each
    for block in range(plan.grid):
        taken = sorted(g for w in range(plan.warpgroups) for g in plan.warpgroup_slabs(block, w))
        assert taken == list(range(*plan.slab_range(block)))


@pytest.mark.parametrize("batch,n", BATCHES)
def test_stats_and_node_passes_cover_every_element_once(batch, n):
    """K6's stats pass (thread t: one slab (b, i) and column pair of the
    softmax statistics) and node pass (thread t: one (b, j) and column pair
    of dk and dv, summed over the graph's query atoms): the threads cover
    every element once and the blocks cover the threads."""
    plan = launch_plan(128, batch, n, SMS)
    assert plan.pair_threads == batch * n * 64
    assert plan.pair_blocks * PAIR_THREADS >= plan.pair_threads
    assert (plan.pair_blocks - 1) * PAIR_THREADS < max(plan.pair_threads, 1)
    seen = set()
    for t in range(plan.pair_threads):
        b, j, c = plan.pair_item(t)
        assert 0 <= b < batch and 0 <= j < n and c % 2 == 0 and 0 <= c < 128
        seen.add((b, j, c))
    assert len(seen) == plan.pair_threads


@pytest.mark.parametrize("batch,n", BATCHES)
def test_wgrad_row_chunks_cover_the_rows_exactly(batch, n):
    plan = launch_plan(128, batch, n, SMS)
    assert plan.chunk_rows % WGRAD_ROWS == 0 and plan.chunks >= 1
    assert (plan.chunks - 1) * plan.chunk_rows < max(plan.rows, 1) <= max(
        plan.chunks * plan.chunk_rows, 1)
    covered = [r for c in range(plan.chunks) for r in range(*plan.chunk_rows_of(c))]
    assert covered == list(range(plan.rows))


@pytest.mark.parametrize("batch", [512, 8, 1])
def test_wgrad_tiles_and_partials_cover_the_four_gradients(batch):
    """The two wgrad blocks of a row chunk are dWe and dWoe (each one D x D
    tile); the column sums of de and ge give dbe and dboe; every parameter
    gradient has one source and the partials add up to the gradient buffer."""
    d = 128
    plan = launch_plan(d, batch, 45, SMS)
    assert [plan.wgrad_tile(t) for t in range(plan.wgrad_tiles)] == [("dwe", 0), ("dwoe", 0)]
    with pytest.raises(IndexError):
        plan.wgrad_tile(plan.wgrad_tiles)
    assert sorted(GRADIENT_SOURCES) == ["dbe", "dboe", "dwe", "dwoe"]
    assert sum(v == "wgrad" for v in GRADIENT_SOURCES.values()) == plan.wgrad_tiles
    w_partial = plan.wgrad_tiles * plan.chunks * d * d   # one D x D tile a (tile, chunk)
    v_partial = plan.chunks * 2 * d                      # dbe, dboe a chunk
    grads = 2 * d * d + 2 * d
    de_rows, stats = 2 * plan.rows * d, 3 * plan.slabs * d
    assert plan.scratch_bytes == (de_rows + stats + w_partial + v_partial + grads) * 4


def test_training_shape_plan_and_scratch():
    """512 graphs of 45 atoms at D 128: a block a SM over 23,040 slabs (30 %
    of the tiles' rows padding), two warpgroups a block; the stats and node
    passes 5,760 blocks each; the wgrad 2 tiles x 262 row chunks of 3,968 rows; K6's device
    scratch 1.13 GB, of it 1.06 GB of f32 rows (de, dbase), against the
    CUDA-core route's 0.53 GB of de."""
    plan = launch_plan(128, 512, 45, SMS)
    assert plan.hopper and plan.slabs == 23_040 and plan.rows == 1_036_800
    assert plan.grid == SMS and plan.warpgroups == 2 and plan.pair_blocks == 5_760
    assert (plan.wgrad_tiles, plan.chunks, plan.chunk_rows) == (2, 262, 3_968)
    assert plan.pad_share == pytest.approx(19 / 64)
    assert plan.scratch_bytes == 1_131_813_888


def test_plan_rejects_what_no_kernel_takes():
    for d, batch, n in ((0, 8, 45), (128, -1, 45), (128, 8, 0)):
        with pytest.raises(ValueError):
            launch_plan(d, batch, n, SMS)

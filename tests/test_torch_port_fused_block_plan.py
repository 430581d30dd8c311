"""The bf16 K7/K8 launch plan (``ops/fused_block.py::launch_plan``), on the CPU.

The plan is the kernels' geometry in plain arithmetic (the card test
``test_block_launch_plan_matches_the_library`` holds it against the
libraries, whose shared memory is not recomputed in Python).
Here: which shapes take the Hopper route, that the slab tiles and the
blocks' runs of slabs cover every edge row of a ragged batch exactly once,
that the wgrad tiles and the partial buffers cover all 12 parameter
gradients, and the scratch at the training shape.  No JAX, no compile.
"""

import pytest

from druggen_tpu_torch.ops.fused_block import (
    GRADIENT_SOURCES,
    PARAM_NAMES,
    TILE_ROWS,
    launch_plan,
)

SMS = 132   # H100 SXM
# (batch, N): the training shape, ragged N from 1 to 64, more graphs than
# blocks and fewer
BATCHES = [(512, 45), (3, 1), (5, 13), (2, 64), (1, 45), (7, 63), (200, 20), (0, 45)]


@pytest.mark.parametrize("c,h,n,hopper", [(128, 384, 45, True), (128, 384, 64, True),
                                          (128, 384, 1, True), (128, 128, 13, True),
                                          (128, 512, 45, True), (128, 384, 65, False),
                                          (256, 768, 13, False), (128, 320, 45, False),
                                          (384, 1152, 45, False)])
def test_the_hopper_route_takes_c_128_and_n_at_most_64(c, h, n, hopper):
    """C 128, H a multiple of 128, 1 <= N <= 64 run on wgmma; every other
    shape (and f32) takes the CUDA-core kernels."""
    assert launch_plan(c, h, 8, n, SMS).hopper is hopper


@pytest.mark.parametrize("batch,n", BATCHES)
def test_slab_tiles_cover_every_row_once(batch, n):
    """Slab g's tile holds edge rows g N .. g N + N - 1 (its other 64 - N
    rows are padding); the blocks' contiguous runs of slabs cover every slab
    once, so every edge row is computed and stored exactly once."""
    plan = launch_plan(128, 384, batch, n, SMS)
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
    assert plan.pad_share == pytest.approx(1 - n / TILE_ROWS)


@pytest.mark.parametrize("batch,n", BATCHES)
def test_wgrad_row_chunks_cover_the_rows_exactly(batch, n):
    plan = launch_plan(128, 384, batch, n, SMS)
    assert plan.chunk_rows % 64 == 0 and plan.chunks >= 1
    assert (plan.chunks - 1) * plan.chunk_rows < max(plan.rows, 1) <= max(
        plan.chunks * plan.chunk_rows, 1)


@pytest.mark.parametrize("c,h", [(128, 384), (128, 128), (128, 512), (128, 1024)])
def test_wgrad_tiles_and_partials_cover_the_twelve_gradients(c, h):
    """The wgrad blocks of a row chunk tile dWe, dWoe, dW1 and dW2^T (each C
    x 128) exactly once; every one of the 12 parameter gradients has one
    source; the element counts add up to the gradient buffer."""
    plan = launch_plan(c, h, 8, 45, SMS)
    cover = {"dwe": set(), "dwoe": set(), "dw1": set(), "dw2": set()}
    for tile in range(plan.wgrad_tiles):
        name, col = plan.wgrad_tile(tile)
        assert col not in cover[name]
        cover[name].add(col)
    assert cover == {"dwe": {0}, "dwoe": {0}, "dw1": set(range(0, h, 128)),
                     "dw2": set(range(0, h, 128))}
    with pytest.raises(IndexError):
        plan.wgrad_tile(plan.wgrad_tiles)
    assert sorted(GRADIENT_SOURCES) == sorted(f"d{p}" for p in PARAM_NAMES)
    sizes = {"dwe": c * c, "dwoe": c * c, "dw1": c * h, "dw2": h * c, "db1": h}
    weights = sum(sizes[k] for k in ("dwe", "dwoe", "dw1", "dw2"))
    col_sums = 3 * c + h         # dbe, dboe, db1, db2: a wgrad vector partial
    ln_sums = 4 * c              # dg4, db4, dg6, db6: a rows vector partial
    assert weights + col_sums + ln_sums == 2 * c * c + 2 * c * h + 7 * c + h
    assert sum(v.startswith("wgrad column") for v in GRADIENT_SOURCES.values()) == 4
    assert sum(v.startswith("rows") for v in GRADIENT_SOURCES.values()) == 4


def test_training_shape_plan_and_scratch():
    """512 graphs of 45 atoms at 128/384: one block of one warpgroup a SM
    over 23,040 slabs, 8 wgrad tiles x 33 row chunks; K8's device scratch 6.50 GB, of it 6.37 GB of f32 rows (t,
    xhat4, dr, dtt, de, dp, h, dhpre and LN4's 1 / std), against the 6.91 GB
    of rows the CUDA-core route allocates (e, t, u, xhat4, dr, dtt, de, h,
    dhpre and LN4's 1 / std)."""
    plan = launch_plan(128, 384, 512, 45, SMS)
    assert plan.hopper and plan.slabs == 23_040 and plan.rows == 1_036_800
    assert plan.grid == SMS
    assert (plan.wgrad_tiles, plan.chunks, plan.chunk_rows) == (8, 33, 31_424)
    assert plan.row_scratch_bytes == 1_036_800 * (6 * 128 + 2 * 384 + 1) * 4
    assert plan.scratch_bytes == 6_499_428_352
    cuda_core_rows = 1_036_800 * (7 * 128 + 2 * 384 + 1) * 4
    assert plan.row_scratch_bytes < cuda_core_rows

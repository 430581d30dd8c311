"""The bf16 K1/K2 launch plan (``ops/fused_mlp.py::launch_plan``), on the CPU.

The plan is plain arithmetic: the kernels compute the same shared memory as
compile-time constants and refuse a launch that disagrees (the card test
``test_launch_plan_matches_the_library`` holds the two together).  Here:
every width fits one SM's 232,448 bytes, the weights are staged or streamed
as the width allows, the widths the single pass does not take plan the split
path, the wgrad tiles cover the weight gradients, and the row chunks cover
the rows exactly.  No JAX, no compile.
"""

import pytest

from druggen_tpu_torch.ops.fused_mlp import SMEM_LIMIT, SPLIT_STAGES, launch_plan

SMS = 132   # H100 SXM
# the card tests' widths (the last three on the split path), then others a
# model could use
CARD_WIDTHS = [(64, 192), (96, 192), (128, 384), (128, 512), (256, 768),
               (100, 300), (264, 792), (512, 1536)]
WIDTHS = CARD_WIDTHS + [(8, 8), (160, 800), (192, 576), (256, 256), (128, 136),
                        (36, 100), (1024, 4096)]
SPLIT = [(100, 300), (264, 792), (512, 1536), (36, 100), (1024, 4096), (100, 384),
         (264, 384), (512, 2048)]
ROWS = [0, 1, 63, 64, 65, 127, 129, 8195, 50_000, 1_036_800, 1_036_801]


@pytest.mark.parametrize("c,h", WIDTHS)
def test_shared_memory_fits_one_sm(c, h):
    plan = launch_plan(c, h, 1_036_800, SMS)
    assert max(plan.fwd_smem, plan.rows_smem, plan.wgrad_smem) <= SMEM_LIMIT
    assert plan.cp % 64 == 0 and plan.hp % 64 == 0
    assert plan.cp - c < 64 and plan.hp - h < 64


@pytest.mark.parametrize("c,h,staged", [(64, 192, True), (96, 192, True), (128, 384, True),
                                        (128, 512, False), (256, 768, False),
                                        (256, 256, False), (8, 8, True)])
def test_weights_staged_where_they_fit(c, h, staged):
    """Staged when both padded bf16 weights fit beside the tile buffers,
    else streamed through a ring of at least one 64-column chunk a
    warpgroup."""
    plan = launch_plan(c, h, 1000, SMS)
    weights = 2 * plan.cp * plan.hp * 2
    assert plan.fwd_staged == plan.rows_staged == staged
    assert (weights <= plan.fwd_smem) == staged
    if staged:
        assert plan.fwd_ring == plan.rows_ring == 0
    else:
        assert plan.fwd_ring >= 1 and plan.rows_ring >= 1
        chunk = 2 * 64 * plan.cp * 2
        assert plan.fwd_smem >= plan.warpgroups * plan.fwd_ring * chunk


@pytest.mark.parametrize("c,h", WIDTHS)
def test_warpgroups_follow_the_accumulator(c, h):
    """Two consumer warpgroups of 64-row tiles while C padded to 64 is at
    most 128 (the C-wide accumulator takes C / 2 registers a thread), else
    one (and one on the split path, whose GEMM blocks are one warpgroup)."""
    plan = launch_plan(c, h, 1000, SMS)
    assert plan.tile_rows == 64
    assert plan.warpgroups == (2 if plan.cp <= 128 and not plan.split else 1)


def test_published_width_plan():
    """dim 128, mlp_ratio 3 at the training shape: the numbers the kernel
    sources' headers state."""
    plan = launch_plan(128, 384, 1_036_800, SMS)
    assert (plan.fwd_smem, plan.rows_smem, plan.wgrad_smem) == (230_416, 230_432, 197_656)
    assert plan.fwd_staged and plan.rows_staged
    assert (plan.warpgroups, plan.grid) == (2, SMS)
    # four warpgroups of 64 x 192 cover dW1 [128, 384] in one block: each
    # operand read once
    assert (plan.wgrad_warpgroups, plan.wgrad_tile_n, plan.wgrad_super_tiles) == (4, 192, 1)
    assert plan.wgrad_grid == (1, plan.chunks, 2)
    assert plan.chunks == 66 and plan.chunk_rows == 15_744


@pytest.mark.parametrize("c,h", WIDTHS)
def test_wgrad_tiles_cover_the_weight_gradient(c, h):
    plan = launch_plan(c, h, 1000, SMS)
    assert plan.wgrad_warpgroups in (1, 2, 4)
    assert plan.hp % plan.wgrad_tile_n == 0
    assert (plan.wgrad_super_tiles * plan.wgrad_warpgroups * 64 * plan.wgrad_tile_n
            == plan.cp * plan.hp)
    assert plan.wgrad_stages >= 2


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("c,h", [(128, 384), (256, 768), (100, 300), (512, 1536)])
def test_row_chunks_cover_the_rows(rows, c, h):
    """wgrad's row chunks are whole 64-row stages and cover the rows
    exactly: none empty, none past the end but the ragged last."""
    plan = launch_plan(c, h, rows, SMS)
    assert plan.chunk_rows > 0 and plan.chunk_rows % 64 == 0
    assert plan.chunks * plan.chunk_rows >= rows
    assert (plan.chunks - 1) * plan.chunk_rows < rows or plan.chunks == 0 == rows
    assert plan.chunks * plan.wgrad_super_tiles * 2 <= max(SMS, 2 * plan.wgrad_super_tiles)
    assert plan.tiles == -(-rows // 64)
    if plan.split:   # a block a 64-row tile, one vector partial a tile
        assert plan.grid == plan.vec_partials == plan.tiles
    else:
        assert plan.grid == min(SMS, -(-plan.tiles // plan.warpgroups))
        assert plan.vec_partials == plan.grid


def test_scratch_bytes_at_the_training_shape():
    """x, dm [rows, CP] and h, dh [rows, HP] in bf16 (2.1 GB at 128/384),
    the vector and weight partials and the gradients in f32."""
    plan = launch_plan(128, 384, 1_036_800, SMS)
    operands = 2 * 1_036_800 * (128 + 384) * 2
    partials = (plan.vec_partials * (5 * 128 + 384) + 2 * plan.chunks * 128 * 384
                + 2 * 128 * 384 + 5 * 128 + 384) * 4
    assert plan.scratch_bytes == operands + partials


@pytest.mark.parametrize("c,h", CARD_WIDTHS[:5] + [(8, 8), (160, 800), (128, 136)])
def test_single_pass_widths(c, h):
    """C a multiple of 8 with C padded to 64 at most 256: the single pass."""
    assert not launch_plan(c, h, 1000, SMS).split


@pytest.mark.parametrize("c,h", SPLIT)
def test_other_widths_take_the_split_path(c, h):
    """C not a multiple of 8, or C padded to 64 above 256: the split path,
    whose largest GEMM block (a 64-row x BN tile, BN the largest of 256, 192,
    128, 64 dividing the padded N) fits one SM; its scratch adds the f32
    residual sum [rows, CP] and the row statistics to K2's operands."""
    rows = 8195
    plan = launch_plan(c, h, rows, SMS)
    assert plan.split and not (plan.fwd_staged or plan.rows_staged)
    assert plan.fwd_ring == plan.rows_ring == SPLIT_STAGES

    def gemm(n):
        bn = next(b for b in (256, 192, 128, 64) if n % b == 0)
        return SPLIT_STAGES * (64 + bn) * 128 + SPLIT_STAGES * 8 + 1024
    assert plan.fwd_smem == plan.rows_smem == max(gemm(plan.cp), gemm(plan.hp)) <= SMEM_LIMIT
    assert plan.fwd_scratch_bytes == rows * ((plan.cp + plan.hp) * 2 + plan.cp * 4 + 8)
    partials = (plan.tiles * (5 * c + h) + 2 * plan.chunks * plan.cp * plan.hp
                + 2 * c * h + 5 * c + h) * 4
    assert plan.scratch_bytes == (2 * rows * (plan.cp + plan.hp) * 2 + partials
                                  + rows * (plan.cp * 4 + 8))


@pytest.mark.parametrize("c,h", [(0, 384), (128, 0), (-8, 24)])
def test_empty_widths_raise(c, h):
    with pytest.raises(ValueError):
        launch_plan(c, h, 1000, SMS)

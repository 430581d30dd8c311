"""The K3/K4 launch plan (``ops/fused_attention.py::v2_launch_plan``), on the CPU.

The plan is the v2 kernels' geometry in plain arithmetic (``csrc/attn_v2.cuh``
holds the same formula; the libraries refuse a launch whose shared memory
disagrees, and the card test ``test_attention_v2_launch_plan_matches_the_library``
holds the plan against their export).  Here, for every (N, D, dtype) that the
JAX routing rule (``uses_v2_kernel``) sends to the kernels at D 128, 256, 384
and 512: the plan's shared memory fits a block's 232,448 B with at least two
ring slots, and its blocks fit a SM together; a TMA box is at most 256 rows;
the keys a thread cover N; a work item is 128 channels (whole bf16 rows at D
128) up to 8 keys a thread and 64 above; and the blocks' runs of items cover
the B x D / width (graph, channel slice) items exactly once.  No JAX, no
compile.
"""

import pytest
import torch

from druggen_tpu_torch.ops.fused_attention import (
    SMEM_LIMIT,
    V2_BLOCK_RESERVE,
    V2_GROUPS,
    V2_MAX_STAGES,
    V2_REG_KPT,
    V2_SM_SMEM,
    uses_v2_kernel,
    v2_box_bytes,
    v2_launch_plan,
    v2_smem_bytes,
)

SMS = 132   # H100 SXM
WIDTHS = (128, 256, 384, 512)
DTYPES = (torch.bfloat16, torch.float32)


def _admitted(d, dtype):
    """Every N the JAX rule sends to the kernels at this D and dtype (it
    admits a prefix 1..N_max)."""
    ns = [n for n in range(1, 200) if uses_v2_kernel(n, d, dtype)]
    assert ns == list(range(1, len(ns) + 1))
    return ns


def test_the_largest_admitted_shapes():
    """The rule's largest N: 108 (bf16) and 89 (f32) at D 128, 76 and 62 at
    D 256; the plan takes N up to 112."""
    assert [len(_admitted(128, t)) for t in DTYPES] == [108, 89]
    assert [len(_admitted(256, t)) for t in DTYPES] == [76, 62]
    assert max(len(_admitted(d, t)) for d in WIDTHS for t in DTYPES) <= V2_GROUPS * 14


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_every_admitted_shape_fits_with_two_stages(kernel, d, dtype):
    for n in _admitted(d, dtype):
        plan = v2_launch_plan(kernel, 512, n, d, dtype, SMS)
        assert 2 <= plan.stages <= V2_MAX_STAGES, plan
        assert plan.smem_bytes <= SMEM_LIMIT, plan
        assert plan.blocks_per_sm * (plan.smem_bytes + V2_BLOCK_RESERVE) <= V2_SM_SMEM, plan
        assert n <= 256, plan   # a TMA box is N rows of one slice
        assert plan.width == (128 if plan.kpt <= V2_REG_KPT else 64)
        assert d % plan.width == 0
        # the slice's panels of 128-byte rows (64 bf16 or 32 f32 channels),
        # each 1 KiB aligned, hold the N rows
        panels = plan.width * (2 if dtype == torch.bfloat16 else 4) // 128
        assert v2_box_bytes(n, plan.bf16) == panels * -(-n * 128 // 1024) * 1024
        # the thread's keys g + 8 m, m < kpt, cover every key
        assert V2_GROUPS * plan.kpt >= n > V2_GROUPS * (plan.kpt - 2), plan
        # a ring slot more would not fit the block's share of the SM (or the
        # ring is at its most)
        share = (V2_SM_SMEM // plan.blocks_per_sm - V2_BLOCK_RESERVE
                 if plan.blocks_per_sm > 1 else SMEM_LIMIT)
        assert plan.smem_bytes <= share
        if plan.stages < V2_MAX_STAGES:
            assert v2_smem_bytes(kernel, n, plan.bf16, plan.stages + 1) > share, plan


@pytest.mark.parametrize("kernel,n,dtype,width,bps,stages,smem", [
    ("fwd", 45, torch.bfloat16, 128, 2, 7, 115_456),
    ("bwd", 45, torch.bfloat16, 128, 1, 8, 230_656),
    ("fwd", 45, torch.float32, 128, 2, 2, 100_608),
    ("bwd", 45, torch.float32, 128, 1, 3, 200_960),
    ("fwd", 50, torch.float32, 128, 1, 5, 204_544),
    ("bwd", 64, torch.bfloat16, 128, 1, 5, 203_008),
    ("bwd", 65, torch.bfloat16, 64, 1, 8, 175_360),
    ("bwd", 89, torch.float32, 64, 1, 3, 200_960),
    ("fwd", 108, torch.bfloat16, 64, 1, 8, 148_736),
])
def test_the_plan_at_named_shapes(kernel, n, dtype, width, bps, stages, smem):
    """At the training shape K3 runs two blocks a SM of 128-channel items
    (whole rows) and K4 one; where two ring slots do not fit half a SM, one
    block; above N 64, 64-channel items of 8 consumer warps."""
    plan = v2_launch_plan(kernel, 512, n, 128, dtype, SMS)
    assert (plan.width, plan.blocks_per_sm, plan.stages, plan.smem_bytes) == (
        width, bps, stages, smem)
    assert plan.grid == bps * SMS and plan.items == 512 * 128 // width


@pytest.mark.parametrize("batch,n,d", [(512, 45, 128), (1, 108, 128), (7, 13, 256),
                                       (3, 1, 384), (200, 20, 512), (1, 89, 128),
                                       (133, 45, 128), (0, 45, 128)])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_items_cover_every_graph_and_slice_once(batch, n, d, kernel):
    """The blocks' contiguous runs cover the B x D / width items exactly
    once, no block is empty, and item it is graph it // (D / width), channels
    width (it % (D / width)) on."""
    plan = v2_launch_plan(kernel, batch, n, d, torch.bfloat16, SMS)
    w = plan.width
    assert plan.items == batch * d // w
    seen = []
    for block in range(plan.grid):
        begin, end = plan.item_range(block)
        assert end > begin or plan.items == 0
        seen.extend(range(begin, end))
    assert seen == list(range(plan.items))
    slices = d // w
    pairs = {(it // slices, w * (it % slices)) for it in seen}
    assert pairs == {(b, c) for b in range(batch) for c in range(0, d, w)}
    assert plan.grid <= max(1, plan.blocks_per_sm * SMS)


@pytest.mark.parametrize("n,d", [(0, 128), (113, 128), (45, 96), (45, 64), (45, 0)])
def test_the_plan_refuses_what_the_kernels_do_not_take(n, d):
    with pytest.raises(ValueError):
        v2_launch_plan("fwd", 4, n, d, torch.bfloat16, SMS)
    with pytest.raises(ValueError):
        v2_launch_plan("both", 4, 45, 128, torch.bfloat16, SMS)

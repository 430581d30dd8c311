"""The three-piece bf16 split behind K7/K8's f32-accurate products, on the CPU.

``fused_block.split_bf16`` is the plain PyTorch emulation of the kernels'
``split3`` (``csrc/block_hopper.cuh``): x = a + (b + c) with a, b, c bf16.
Held with hypothesis: the pieces sum back to x bit for bit for every f32 x
with 2^-110 <= |x| < 2^128 (1 - 2^-9) (and for 0); below that range the
error is under 2^-133 (c falls into bf16's subnormals); from its top, where
bf16(x) rounds past bf16's largest value, the first piece is infinite.  The product of the split pieces with
a bf16-exact weight (``split_matmul``: three exact bf16 products summed in
f32, the tensor cores' route) matches the f32 product within K8's f32
parameter-gradient limit, TOL_BLOCK_PARAM_REL[f32] = 1e-5 relative.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from druggen_tpu_torch.ops.fused_block import split_bf16, split_matmul

BF16_MAX = float(torch.finfo(torch.bfloat16).max)
TOP = 2.0 ** 128 * (1 - 2.0 ** -9)     # bf16(x) rounds to infinity from here
NORMAL = st.floats(min_value=2.0 ** -110, max_value=TOP, width=32, exclude_max=True,
                   allow_subnormal=False)
TOL_BLOCK_PARAM_REL_F32 = 1e-5


def _sum_back(x):
    a, b, c = split_bf16(x)
    f32 = torch.float32
    return a.to(f32) + (b.to(f32) + c.to(f32))


@settings(max_examples=400, deadline=None)
@given(st.lists(NORMAL, min_size=1, max_size=64), st.lists(st.booleans(), min_size=64,
                                                           max_size=64))
def test_pieces_sum_back_bit_for_bit(mags, signs):
    x = torch.tensor([m if s else -m for m, s in zip(mags, signs)], dtype=torch.float32)
    assert torch.equal(_sum_back(x).view(torch.int32), x.view(torch.int32))


def test_edges_of_the_exact_range():
    """0 and the ends of the range are exact (bf16's largest value and the
    last f32 below the top among them); below 2^-110 the error stays under
    2^-133; from the top on, the split breaks."""
    x = torch.tensor([0.0, 2.0 ** -110, -(2.0 ** -110), 1.0 + 2.0 ** -23, BF16_MAX,
                      float(np.nextafter(np.float32(TOP), np.float32(0)))],
                     dtype=torch.float32)
    assert torch.equal(_sum_back(x), x)
    tiny = torch.tensor([2.0 ** -120 * (1 + 2.0 ** -23), 3e-38, 2.0 ** -126 * 1.2345],
                        dtype=torch.float32)
    assert ((_sum_back(tiny) - tiny).abs() < 2.0 ** -133).all()
    big = torch.tensor([TOP, 3.4e38], dtype=torch.float32)
    assert torch.isinf(split_bf16(big)[0].float()).all()


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([(16, 32, 8), (64, 128, 64), (5, 7, 3)]),
       st.sampled_from([1e-3, 1.0, 1e3]))
def test_split_product_matches_the_f32_product(seed, shape, scale):
    """x (f32) @ w (bf16-exact), as three bf16 pieces of x each multiplied
    exactly, against the f32 product and the float64 one."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, k)) * scale).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).bfloat16().float()
    got = split_matmul(x, w).double()
    exact = x.double() @ w.double()
    ref = (x @ w).double()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    assert rel(got, ref) <= TOL_BLOCK_PARAM_REL_F32
    assert rel(got, exact) <= 1e-6

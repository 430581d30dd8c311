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

K5/K6 multiply by the raw f32 weights, so both operands of an f32 x f32
product are split and the kernels run the six significant piece products
(``split_matmul6``).  Held against the float64 product at K5/K6's shapes
(D 128: edge rows x We / Woe, and the wgrad's sum over the rows) within the
bound of f32 summation plus the three products left out: |got - exact| <=
(K + 8) 2^-24 (|x| @ |w|) element by element, K the summed length.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from druggen_tpu_torch.ops.fused_block import split_bf16, split_matmul, split_matmul6

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


# K5/K6's f32 x f32 products at D 128: (rows, K, columns) of t Woe / de We^T
# over 2 graphs of 45 atoms, a ragged slab of 13 atoms, and the wgrad's
# eraw^T de over the same rows (K = the rows)
SIX_PIECE_SHAPES = [(2 * 45 * 45, 128, 128), (13 * 13, 128, 128), (128, 2 * 45 * 45, 128)]


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from(SIX_PIECE_SHAPES),
       st.sampled_from([1e-3, 1.0, 1e3]))
def test_six_piece_product_matches_float64(seed, shape, scale):
    """x @ w with both f32, as the six significant piece products, against
    the float64 product: element by element within (K + 8) 2^-24 (|x| @
    |w|), and within the f32 product's own distance from it, twice over."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, k)) * scale).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    got = split_matmul6(x, w).double()
    exact = x.double() @ w.double()
    bound = (k + 8) * 2.0 ** -24 * (x.double().abs() @ w.double().abs())
    assert ((got - exact).abs() <= bound).all()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    assert rel(got, exact) <= 2 * max(rel((x @ w).double(), exact), 2.0 ** -24)


def test_six_piece_product_needs_all_six():
    """Leaving out the smallest kept product (x piece 2 x w piece 0) moves
    the result past the bound for inputs whose third pieces are large: the
    model holds the kernels to all six."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    xs = [p_.float() for p_ in split_bf16(x)]
    ws = [p_.float() for p_ in split_bf16(w)]
    five = xs[1] @ ws[1] + xs[0] @ ws[2] + xs[1] @ ws[0] + xs[0] @ ws[1] + xs[0] @ ws[0]
    exact = x.double() @ w.double()
    err6 = (split_matmul6(x, w).double() - exact).abs().max().item()
    err5 = (five.double() - exact).abs().max().item()
    assert err5 > 4 * err6

"""The ReLU kink-flip witness that the card checks of K2 use
(``druggen_tpu_torch.ops.fused_mlp.witness_kink_flips``), on the CPU.

A kernel's ``ds`` is played by the plain version with planted derivative
flips, on rows that each have one unit set at the kink.  Flips of that unit
are found again, unit for unit; flips of the unit farthest from the kink,
and rows moved by anything but a flip, stay unexplained.  Row tolerances as
in the card checks: bf16 3e-2 + 2^-6 |ref|, f32 1e-4.  Imports no JAX.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from druggen_tpu_torch.ops import fused_mlp as port

torch.set_num_threads(1)

C, H, ROWS = 128, 384, 300     # the published widths: dim 128, mlp_ratio 3
TIES, TIE_UNIT = 12, 31


def _inputs(dtype, seed=0):
    """Random inputs in which each of the first ``TIES`` rows has one hidden
    unit (its own) set at the kink through ``b1``."""
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C, H)) / math.sqrt(C), rng.normal(size=(H,)) * 0.1,
         rng.normal(size=(H, C)) / math.sqrt(H), rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1)
    p = [torch.from_numpy(x.astype(np.float32)) for x in p]
    s = torch.from_numpy(rng.normal(size=(ROWS, C)).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.normal(size=(ROWS, C)).astype(np.float32)).to(dtype)
    h_pre = _h_pre(s, p)
    for r in range(TIES):
        p[3][TIE_UNIT * r] -= h_pre[r, TIE_UNIT * r]
    return s, p, dout


def _row_ok(dtype):
    if dtype == torch.bfloat16:
        return lambda a, b: ((a.float() - b.float()).abs()
                             <= 3e-2 + 2 ** -6 * b.float().abs()).all(-1)
    return lambda a, b: ((a.float() - b.float()).abs() <= 1e-4).all(-1)


def _h_pre(s, p):
    x = F.layer_norm(s.float(), (C,), p[0], p[1], 1e-5).to(s.dtype).float()
    return x @ p[2].to(s.dtype).float() + p[3]


def _planted(s, p, dout, order):
    """The plain ds with the unit at ``order`` (0: nearest the kink, -1:
    farthest) of each of the first ``TIES`` rows flipped where the flip is
    visible; the plain ds; those rows and units."""
    dtype = s.dtype
    rows = torch.arange(TIES)
    h_pre = _h_pre(s, p)[:TIES]
    units = h_pre.abs().argsort(-1)[:, order]
    dead = h_pre.gather(1, units[:, None])[:, 0] <= 0
    ref = port.fused_ln_mlp_ln_bwd_reference(s, *p, dout)[0]
    flipped = port.fused_ln_mlp_ln_bwd_reference(s, *p, dout,
                                                 relu_set=(rows, units, dead))[0]
    keep = torch.nonzero(~_row_ok(dtype)(flipped, ref)).flatten()
    ds = ref.clone()
    ds[keep] = flipped[keep]
    return ds, ref, keep, units[keep]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_witness_finds_planted_flips_at_the_kink(dtype):
    s, p, dout = _inputs(dtype)
    ds, ref, rows, units = _planted(s, p, dout, 0)
    assert len(rows) >= TIES // 2
    assert torch.equal(units, TIE_UNIT * rows)
    bad = torch.nonzero(~_row_ok(dtype)(ds, ref)).flatten()
    assert torch.equal(bad, rows)
    relu_set, unexplained = port.witness_kink_flips(s, p, dout, ds, bad,
                                                    _row_ok(dtype))
    assert len(unexplained) == 0
    f_rows, f_units, f_live = relu_set
    h_pre = _h_pre(s, p)
    moved = f_live != (h_pre[f_rows, f_units] > 0)
    assert torch.equal(f_rows[moved], rows) and torch.equal(f_units[moved], units)
    again = port.fused_ln_mlp_ln_bwd_reference(s, *p, dout, relu_set=relu_set)[0]
    assert torch.equal(again, ds)


@pytest.mark.parametrize("dtype,order", [(torch.bfloat16, -1),
                                         (torch.float32, -1),
                                         (torch.float32, 1)])
def test_witness_leaves_flips_out_of_reach_unexplained(dtype, order):
    """A flip of the unit with the largest |h_pre|, or in f32 of the
    second nearest (~1e-3 from the kink, beyond f32 rounding), is no
    rounding effect."""
    s, p, dout = _inputs(dtype, seed=1)
    ds, ref, rows, _ = _planted(s, p, dout, order)
    assert len(rows) >= TIES // 2
    relu_set, unexplained = port.witness_kink_flips(s, p, dout, ds, rows,
                                                    _row_ok(dtype))
    assert len(relu_set[0]) == 0 and torch.equal(unexplained, rows)


def test_witness_leaves_other_faults_unexplained():
    s, p, dout = _inputs(torch.bfloat16, seed=2)
    ref = port.fused_ln_mlp_ln_bwd_reference(s, *p, dout)[0]
    ds = ref.clone()
    rows = torch.tensor([3, 17, 200])
    ds[rows, 5] += 0.5
    relu_set, unexplained = port.witness_kink_flips(
        s, p, dout, ds, rows, _row_ok(torch.bfloat16))
    assert len(relu_set[0]) == 0 and torch.equal(unexplained, rows)

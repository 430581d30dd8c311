"""K1, the fused LN -> MLP -> residual -> LN edge tail, in the PyTorch port.

The port's plain version (what its wrapper runs for a CPU tensor) is held
against the JAX ``fused_ln_mlp_ln`` run through the Pallas interpreter, on
the same numpy inputs: f32 to 1e-5, bf16 (compared in f32) to 3e-2 (the
products round to bf16 at the same points but the f32 sums run in another
order, worth up to ~2 bf16 ulps at |y| <= 4).  The CUDA kernel itself is
compared with the plain version on the card (``test_torch_port_card.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from druggen_tpu.ops.fused_mlp import fused_ln_mlp_ln as jax_fused_ln_mlp_ln
from druggen_tpu_torch.ops import fused_mlp as port

torch.set_num_threads(1)

C, HID = 32, 96


def _inputs(rows, seed, c=C, hid=HID):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(rows, c)).astype(np.float32)
    params = (rng.normal(size=(c,)) * 0.5 + 1.0,
              rng.normal(size=(c,)) * 0.1,
              rng.normal(size=(c, hid)) / np.sqrt(c),
              rng.normal(size=(hid,)) * 0.1,
              rng.normal(size=(hid, c)) / np.sqrt(hid),
              rng.normal(size=(c,)) * 0.1,
              rng.normal(size=(c,)) * 0.5 + 1.0,
              rng.normal(size=(c,)) * 0.1)
    return s, [p.astype(np.float32) for p in params]


def _jax(s, params, dtype):
    out = jax_fused_ln_mlp_ln(jnp.asarray(s, dtype),
                              *[jnp.asarray(p) for p in params],
                              interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(s, params, dtype):
    out = port.fused_ln_mlp_ln(torch.from_numpy(s).to(dtype),
                               *[torch.from_numpy(p) for p in params])
    assert out.dtype == dtype
    return out.float().numpy()


# 243 = 3 graphs of 9 atoms squared (a ragged Pallas tile); 300 spans tiles
@pytest.mark.parametrize("rows", [243, 300, 512])
def test_plain_matches_pallas_f32(rows):
    s, p = _inputs(rows, seed=rows)
    np.testing.assert_allclose(_port(s, p, torch.float32),
                               _jax(s, p, jnp.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows", [243, 300])
def test_plain_matches_pallas_bf16(rows):
    s, p = _inputs(rows, seed=rows + 1)
    s = np.asarray(torch.from_numpy(s).bfloat16().float())   # bf16-exact
    np.testing.assert_allclose(_port(s, p, torch.bfloat16),
                               _jax(s, p, jnp.bfloat16), atol=3e-2, rtol=0)


def test_plain_keeps_leading_axes():
    s, p = _inputs(3 * 9 * 9, seed=7)
    s4 = torch.from_numpy(s).reshape(3, 9, 9, C)
    out = port.fused_ln_mlp_ln(s4, *[torch.from_numpy(x) for x in p])
    assert out.shape == s4.shape
    np.testing.assert_array_equal(out.reshape(-1, C).numpy(),
                                  _port(s, p, torch.float32))


def test_wrapper_refuses_other_devices():
    """Only a CPU tensor takes the plain version; anything else that is not
    CUDA raises instead of falling back."""
    s, p = _inputs(16, seed=3)
    meta = torch.empty(16, C, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        port.fused_ln_mlp_ln(meta, *[torch.from_numpy(x) for x in p])


def test_launch_counter_counts_only_kernel_launches():
    s, p = _inputs(16, seed=4)
    before = port.fused_ln_mlp_ln.launches
    port.fused_ln_mlp_ln(torch.from_numpy(s), *[torch.from_numpy(x) for x in p])
    assert port.fused_ln_mlp_ln.launches == before


def test_serving_shape_bound():
    """The bound chip_smoke.py reports for K1 at the serving shape: 512
    graphs x 45^2 edge rows, C 128, H 384, bf16 -> 0.206 ms of tensor-core
    work (203.9 GFLOP at 989 TFLOP/s) against 0.159 ms of bytes."""
    import chip_smoke

    ms, by = chip_smoke.tail_bound(512 * 45 * 45, torch.bfloat16)
    assert by == "operations"
    assert ms == pytest.approx(2 * 2 * 1_036_800 * 128 * 384 / 989e12 * 1e3)
    assert ms == pytest.approx(0.2061, abs=1e-4)

"""The port's train step in bf16 with the gradient penalty in f32
(``gp_f32``), against the JAX package's step on the CPU.

Same procedure as ``test_torch_port_train_step.py`` with the plain
Generator on both sides, held loosely: XLA and PyTorch round bf16
intermediates at other points (XLA keeps a fusion's intermediates in f32,
PyTorch rounds after every op).  The losses agree to 2e-2 relative.  Each
model's parameter change over the 3 steps, by relative norm error: Adam's
update is near sign(gradient) per element, so an element whose gradient is
near zero may step the other way; G is held at 0.35 (0.24 read on the CPU),
D at 0.2 (0.11).  The AdamW moments by relative norm error: G to 0.2 (mu
0.05, nu 0.13), D to 5e-2 (0.02, 0.01).  A model left unchanged reads 1 on
its change, and two planted faults read past the limits (tested below):
the port fed half of each batch twice over (G change 0.74, G moments 0.41
and 0.50, D change 0.82); the port's gradient penalty left out (D change
1.2, D moments 0.99 and 1.0; it reaches G only through the updated critic,
which 3 steps do not show).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_port_train_step import (
    B,
    jax_step,
    port_setup,
    run_and_compare,
    step_readings,
)

torch.set_num_threads(1)

BF16_TOL = {"loss": 2e-2, "update": {"g": 0.35, "d": 0.2},
            "moment": {"g": 0.2, "d": 5e-2}}


@pytest.fixture(scope="module")
def jax_bf16():
    return jax_step(dtype=jnp.bfloat16, gp_f32=True)


def _setup(parts):
    setup = port_setup(parts, dtype=jnp.bfloat16, gp_f32=True, g_fused=False)
    assert setup[3].gp_cast == torch.float32
    return setup


def test_bf16_with_f32_gradient_penalty_matches_jax(jax_bf16):
    run_and_compare(_setup(jax_bf16), jnp.bfloat16, BF16_TOL)


def _half_batch(*batch):
    return tuple(np.concatenate([v[:B // 2], v[:B // 2]]) for v in batch)


@pytest.mark.parametrize("fault", ["half_batch", "no_penalty"])
def test_bf16_limits_catch_a_planted_fault(jax_bf16, fault):
    setup = _setup(jax_bf16)
    if fault == "no_penalty":
        setup[3].lambda_gp = 0.0
    r = step_readings(setup, jnp.bfloat16,
                      port_batch=_half_batch if fault == "half_batch" else None)
    caught = ["d"] if fault == "no_penalty" else ["g", "d"]
    for name in caught:
        assert r[name]["update"] > BF16_TOL["update"][name], (name, r[name])
        assert max(r[name]["mu"], r[name]["nu"]) > BF16_TOL["moment"][name], (name, r[name])

"""The port's train step with the fused critic at critic depth 2, against
the JAX package's step on the CPU (f32).

The critic's first-order passes (D-step real and fake, G-step fake) run the
fused edge tail (K1 forward, K2 backward; their plain versions on the CPU)
in every block but the last, whose edge stream is dead and skipped; the
gradient-penalty pass stays on the plain critic.  The JAX step runs the
same critic on XLA: its fused critic is identical math
(``train/step.py:163-169``).  Same procedure and f32 tolerances as
``test_torch_port_train_step.py``.
"""

import jax.numpy as jnp
import torch

from druggen_tpu_torch.ops import fused_mlp
from test_torch_port_train_step import F32_TOL, jax_step, port_setup, run_and_compare

torch.set_num_threads(1)


def test_fused_critic_at_depth_two_matches_jax(monkeypatch):
    setup = port_setup(jax_step(ddepth=2), fused_critic=True)
    calls = []
    orig = fused_mlp.FusedLnMlpLn.apply
    monkeypatch.setattr(fused_mlp.FusedLnMlpLn, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    run_and_compare(setup, jnp.float32, F32_TOL)
    # a step: the Generator's tail (depth 1) + the critic's first block in
    # the real, fake and G-step passes
    assert len(calls) == 3 * (1 + 3)

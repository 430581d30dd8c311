"""WGAN-GP objectives (port of ``druggen_tpu/train/losses.py``).

- :func:`gradient_penalty` — eps-interpolation on both node and edge inputs,
  per-sample input gradients of the critic through
  ``torch.autograd.grad(..., create_graph=True)``, concatenated 2-norm in
  f32 with ``+1e-12``, mean squared deviation from 1 (reference
  ``loss.py:4-49``).
- :func:`discriminator_loss` — ``E[D(fake)] - E[D(real)] + λ·GP`` with the
  generator outputs detached (``loss.py:52-72``).
- :func:`generator_loss` — ``-E[D(fake)]`` (``loss.py:75-85``).

The critic gradient trick of the JAX version holds here too: D outputs
``[B, 1]`` with per-sample independence, so the gradient of ``sum(D(x))``
with respect to the input is the per-sample gradient.  The interpolation
noise comes from the caller (a ``torch.Generator`` draw in the train step,
or the JAX draws in the tests).  The reverse-over-forward variant
(``gp_mode="fwdrev"``) is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

# Critic signature: (edge [B,N,N,b], node [B,N,m]) -> [B,1]
CriticFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# Generator signature: (edge, node) -> (node_h, edge_h, node_logits, edge_logits)
GeneratorFn = Callable[[torch.Tensor, torch.Tensor], tuple]


def draw_gp_noise(batch: int, dtype, device, generator: torch.Generator | None):
    """``eps_node`` [B,1,1] and ``eps_edge`` [B,1,1,1], uniform in [0, 1)
    (JAX ``losses.py:48-50``)."""
    eps_node = torch.rand((batch, 1, 1), generator=generator, device=device,
                          dtype=dtype)
    eps_edge = torch.rand((batch, 1, 1, 1), generator=generator,
                          device=device, dtype=dtype)
    return eps_node, eps_edge


def gradient_penalty(critic: CriticFn, real_node, real_edge, fake_node,
                     fake_edge, eps_node, eps_edge, cast_dtype=None):
    """Reference ``gradient_penalty`` (loss.py:4-49).

    ``cast_dtype``: cast the interpolation points to this dtype *before*
    differentiation (the gp_f32 path), so the input gradients come back in
    that dtype and the whole chain runs in it."""
    b = real_node.shape[0]
    int_node = eps_node * real_node + (1.0 - eps_node) * fake_node
    int_edge = eps_edge * real_edge + (1.0 - eps_edge) * fake_edge
    if cast_dtype is not None:
        int_node = int_node.to(cast_dtype)
        int_edge = int_edge.to(cast_dtype)
    # the interpolants are constants of the penalty (JAX stops their
    # gradient through the detached fakes)
    int_node = int_node.detach().requires_grad_()
    int_edge = int_edge.detach().requires_grad_()
    g_node, g_edge = torch.autograd.grad(critic(int_edge, int_node).sum(),
                                         (int_node, int_edge),
                                         create_graph=True)
    # norm/penalty reduction in f32 regardless of the compute dtype
    grads = torch.cat([g_node.reshape(b, -1), g_edge.reshape(b, -1)],
                      dim=1).float()
    norms = torch.sqrt((grads * grads).sum(dim=1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def discriminator_loss(generator: GeneratorFn, critic: CriticFn,
                       drug_edge, drug_node, mol_edge, mol_node,
                       lambda_gp: float, eps_node, eps_edge,
                       gp_mode: str = "revrev",
                       critic_gp: CriticFn | None = None, gp_cast=None):
    """Reference ``discriminator_loss`` (loss.py:52-72): the critic sees the
    real (drug) graphs and the generator's *logit* outputs, with G frozen.

    ``critic_gp``: critic for the gradient-penalty pass (defaults to
    ``critic``).  The real/fake passes are differentiated once, so
    ``critic`` may use first-order-only fused kernels; the GP pass is
    differentiated twice and must be the plain critic."""
    if gp_mode != "revrev":
        raise NotImplementedError(
            f"gp_mode={gp_mode!r} (the reverse-over-forward penalty) is not "
            "ported yet (ROADMAP queue A)")
    logits_real = critic(drug_edge, drug_node)
    _, _, node_logits, edge_logits = generator(mol_edge, mol_node)
    fake_node = node_logits.detach()
    fake_edge = edge_logits.detach()
    logits_fake = critic(fake_edge, fake_node)
    gp = gradient_penalty(critic_gp or critic, drug_node, drug_edge,
                          fake_node, fake_edge, eps_node, eps_edge,
                          cast_dtype=gp_cast)
    return logits_fake.mean() - logits_real.mean() + lambda_gp * gp


def generator_loss(generator: GeneratorFn, critic: CriticFn, mol_edge,
                   mol_node):
    """Reference ``generator_loss`` (loss.py:75-85).  Returns (loss,
    generator outputs) so the caller can reuse the samples for logging."""
    outs = generator(mol_edge, mol_node)
    _, _, node_logits, edge_logits = outs
    return -critic(edge_logits, node_logits).mean(), outs

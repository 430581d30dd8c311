"""WGAN-GP objectives (port of ``druggen_tpu/train/losses.py``).

- :func:`gradient_penalty` — eps-interpolation on both node and edge inputs,
  per-sample input gradients of the critic through
  ``torch.autograd.grad(..., create_graph=True)``, concatenated 2-norm in
  f32 with ``+1e-12``, mean squared deviation from 1 (reference
  ``loss.py:4-49``).
- :func:`gradient_penalty_fwdrev` — the same value and parameter gradients
  as reverse-over-forward (JAX ``losses.py:71-137``): a first-order input
  gradient pass, then a JVP of the critic that reverse mode differentiates.
- :func:`discriminator_loss` — ``E[D(fake)] - E[D(real)] + λ·GP`` with the
  generator outputs detached (``loss.py:52-72``).
- :func:`generator_loss` — ``-E[D(fake)]`` (``loss.py:75-85``).

The critic gradient trick of the JAX version holds here too: D outputs
``[B, 1]`` with per-sample independence, so the gradient of ``sum(D(x))``
with respect to the input is the per-sample gradient.  The interpolation
noise comes from the caller (a ``torch.Generator`` draw in the train step,
or the JAX draws in the tests).
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


def gradient_penalty_fwdrev(critic: CriticFn, real_node, real_edge,
                            fake_node, fake_edge, eps_node, eps_edge,
                            critic_jvp: CriticFn | None = None):
    """Same value and parameter gradients as :func:`gradient_penalty`,
    restructured as reverse-over-forward (JAX ``losses.py:71-137``).

    With ``g(θ) = ∇ₓD(x̂; θ)`` and ``GP = f(g)``, ``∇θ GP = ∇θ[uᵀ g(θ)]``
    for the constant ``u = f'(g)``, and ``uᵀ∇ₓD`` is the derivative of D
    along ``u``: a JVP.  So the inner input-gradient pass is differentiated
    once and never again (``critic`` may run the first-order fused kernels),
    and reverse mode sees only the JVP of ``critic_jvp`` (default
    ``critic``), taken with ``torch.func.jvp`` on the live parameters.  The
    exact penalty value is spliced back in as ``s - s.detach() + GP``.

    ``critic_jvp`` is forward-differentiated, then reverse-differentiated:
    it must be the plain critic with its LayerNorms in ``forward_mode``
    (:func:`..models.layers.numerics`); a fused op there raises."""
    b = real_node.shape[0]
    # the interpolation points are constants of the penalty
    int_node = (eps_node * real_node + (1.0 - eps_node) * fake_node).detach()
    int_edge = (eps_edge * real_edge + (1.0 - eps_edge) * fake_edge).detach()

    # first-order inner pass: g = ∇ₓD(x̂), not differentiated further
    inner_node = int_node.detach().requires_grad_()
    inner_edge = int_edge.detach().requires_grad_()
    g_node, g_edge = torch.autograd.grad(critic(inner_edge, inner_node).sum(),
                                         (inner_node, inner_edge))
    # f32 reduction (see gradient_penalty)
    sq = (g_node.reshape(b, -1).float().square().sum(dim=1)
          + g_edge.reshape(b, -1).float().square().sum(dim=1))
    norms = torch.sqrt(sq + 1e-12)
    gp_value = ((norms - 1.0) ** 2).mean()

    # u = f'(g): d/dg of mean_b((‖g_b‖-1)²) = 2(‖g_b‖-1)/(B·‖g_b‖) · g_b
    coef = 2.0 * (norms - 1.0) / (b * norms)
    u_node = (coef[:, None, None] * g_node).to(int_node.dtype)
    u_edge = (coef[:, None, None, None] * g_edge).to(int_edge.dtype)

    # s(θ) = uᵀ∇ₓD(x̂; θ) as a JVP; reverse mode over it reaches θ
    jvp_critic = critic_jvp or critic
    _, s = torch.func.jvp(lambda n, e: jvp_critic(e, n).sum(),
                          (int_node, int_edge), (u_node, u_edge))
    return s - s.detach() + gp_value.detach()


def discriminator_loss(generator: GeneratorFn, critic: CriticFn,
                       drug_edge, drug_node, mol_edge, mol_node,
                       lambda_gp: float, eps_node, eps_edge,
                       gp_mode: str = "revrev",
                       critic_gp: CriticFn | None = None,
                       critic_jvp: CriticFn | None = None, gp_cast=None):
    """Reference ``discriminator_loss`` (loss.py:52-72): the critic sees the
    real (drug) graphs and the generator's *logit* outputs, with G frozen.

    ``gp_mode``: ``"revrev"`` (:func:`gradient_penalty`, the reference's
    double backward) or ``"fwdrev"`` (:func:`gradient_penalty_fwdrev`, the
    same gradients).  ``critic_gp``: critic for the gradient-penalty pass
    (defaults to ``critic``).  The real/fake passes are differentiated once,
    so ``critic`` may use first-order-only fused kernels; under revrev the
    GP pass is differentiated twice and must be the plain critic, under
    fwdrev it is the inner first-order pass and ``critic_jvp`` the plain
    JVP critic.  ``gp_cast`` (revrev only): the dtype the interpolants are
    cast to before differentiation."""
    if gp_mode not in ("revrev", "fwdrev"):
        raise ValueError(f"gp_mode must be 'revrev' or 'fwdrev', got {gp_mode!r}")
    logits_real = critic(drug_edge, drug_node)
    _, _, node_logits, edge_logits = generator(mol_edge, mol_node)
    fake_node = node_logits.detach()
    fake_edge = edge_logits.detach()
    logits_fake = critic(fake_edge, fake_node)
    if gp_mode == "fwdrev":
        gp = gradient_penalty_fwdrev(critic_gp or critic, drug_node,
                                     drug_edge, fake_node, fake_edge,
                                     eps_node, eps_edge, critic_jvp=critic_jvp)
    else:
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

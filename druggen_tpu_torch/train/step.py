"""One WGAN-GP training iteration (port of ``druggen_tpu/train/step.py``
``make_train_step`` :131-339).

The reference's hot path (``train.py:302-397``, SURVEY.md §3.1): the
Generator forward, the critic on the real, fake and interpolated graphs,
the gradient penalty's double backward, then the D and G AdamW updates.
D is updated first and G trains against the *updated* critic, as the
reference's ``d_optimizer.step(); ... g_optimizer.step()`` order has it.

One step runs eagerly on the device and returns the losses and logits as
device tensors: nothing in it waits for the host.

Numerics, per pass, on the same ``Parameter`` objects
(:func:`druggen_tpu_torch.models.numerics`):

- the Generator in the compute dtype, with its fused edge tail (K1 forward,
  K2 backward) when ``g_fused`` and its fused edge attention (K5 forward, K6
  backward) when ``g_pallas`` (JAX: only G is built with ``use_pallas``; the
  critic never, its penalty pass is differentiated twice); ``g_fused="block"``
  runs each block's whole edge stream through the megablock (K7 forward, K8
  backward) where the block's rule allows it (not with ``g_pallas``: then
  K5/K6 and the fused tail, as in JAX ``layers.py:274-277``);
- the critic's first-order passes (D-step real and fake, G-step fake) with
  the fused tail when ``fused_critic``, the megablock when
  ``fused_critic="block"`` (JAX ``step.py:207-214``);
- the gradient-penalty pass on the plain critic (it is differentiated
  twice), in f32 with the interpolants cast before differentiation when
  ``gp_f32`` (JAX :185-186, :236-260);
- ``f32_stats``: softmax in f32, the fused tails, the megablock and the fused
  attention off (JAX :170-181).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from druggen_tpu_torch.models.layers import numerics
from druggen_tpu_torch.train.losses import (
    discriminator_loss,
    draw_gp_noise,
    generator_loss,
)


def _fused_mode(value):
    """``fused_mlp`` of a pass: ``"block"`` or a bool."""
    if value == "block":
        return "block"
    if value not in (True, False, None):
        raise ValueError(f"fused mode must be True, False or 'block', got {value!r}")
    return bool(value)


def _grads(loss, params):
    # parameters the loss does not reach (the critic's skipped last-block
    # edge tail) get zeros, as jax.grad gives them
    return torch.autograd.grad(loss, params, allow_unused=True,
                               materialize_grads=True)


class TrainStep:
    """``TrainStep(G, D, g_opt, d_opt, *, lambda_gp, m_dim, b_dim, ...)``.

    ``step(x_labels [B,N], a_labels [B,N,N], drug_x_labels, drug_a_labels,
    eps=None)`` runs one iteration on ``G``'s device and returns
    ``{"d_loss", "g_loss", "node_logits", "edge_logits"}`` (device tensors,
    detached).  ``eps`` = ``(eps_node [B,1,1], eps_edge [B,1,1,1])`` is the
    gradient-penalty noise; it is drawn from ``generator`` when None.  For
    the NoTarget submodel the drug inputs are ignored and the critic sees the
    ChEMBL graphs themselves (reference train.py:340-345)."""

    def __init__(self, G, D, g_opt, d_opt, *, lambda_gp: float, m_dim: int,
                 b_dim: int, submodel: str = "DrugGEN",
                 compute_dtype=torch.float32, g_fused: bool | str = False,
                 node_mode: str = "labels", gp_mode: str = "revrev",
                 share_fake="auto", fused_critic: bool | str = False,
                 gp_f32: bool = False, f32_stats: bool = False,
                 g_pallas: bool = False,
                 generator: torch.Generator | None = None):
        if node_mode != "labels":
            raise NotImplementedError("node_mode='dense' (--features) is not "
                                      "ported yet (ROADMAP queue A)")
        if gp_mode != "revrev":
            raise NotImplementedError(f"gp_mode={gp_mode!r} is not ported yet "
                                      "(ROADMAP queue A)")
        self.G, self.D, self.g_opt, self.d_opt = G, D, g_opt, d_opt
        self.lambda_gp, self.m_dim, self.b_dim = lambda_gp, m_dim, b_dim
        self.submodel = submodel
        self.compute_dtype = compute_dtype
        dt = None if compute_dtype == torch.float32 else compute_dtype
        lowp = compute_dtype != torch.float32
        f32_stats = bool(f32_stats and lowp)
        self.g_numerics = dict(dtype=dt, fused_mlp=False if f32_stats else _fused_mode(g_fused),
                               f32_stats=f32_stats,
                               use_pallas=bool(g_pallas) and not f32_stats)
        self.d_first = dict(dtype=dt,
                            fused_mlp=False if f32_stats else _fused_mode(fused_critic),
                            f32_stats=f32_stats, use_pallas=False)
        gp32 = bool(gp_f32 and lowp)
        self.d_gp = dict(dtype=None if gp32 else dt, fused_mlp=False,
                         f32_stats=f32_stats, use_pallas=False)
        self.gp_cast = torch.float32 if gp32 else None
        g_dropout = _dropout_rate(G)
        if share_fake == "auto":
            share_fake = g_dropout == 0.0
        elif share_fake and g_dropout > 0.0:
            raise ValueError(
                "share_fake=True with generator dropout > 0 changes training "
                "semantics (the reference redraws dropout masks on the G-step "
                "forward). Use share_fake='auto' or set dropout=0.")
        self.share_fake = bool(share_fake)
        self.generator = generator
        self.g_params = list(G.parameters())
        self.d_params = list(D.parameters())

    # -- model passes under their numerics ---------------------------------
    def _generate(self, e, n):
        with numerics(self.G, **self.g_numerics):
            return self.G(e, n)

    def _critic(self, e, n):
        with numerics(self.D, **self.d_first):
            return self.D(e, n)

    def _critic_gp(self, e, n):
        with numerics(self.D, **self.d_gp):
            return self.D(e, n)

    def one_hot(self, labels, width):
        dev = next(self.G.parameters()).device
        labels = torch.as_tensor(labels).to(dev, non_blocking=True).long()
        return F.one_hot(labels, width).to(self.compute_dtype)

    # ----------------------------------------------------------------------
    def __call__(self, x_labels, a_labels, drug_x_labels, drug_a_labels,
                 eps=None) -> dict:
        self.G.train()
        self.D.train()
        x = self.one_hot(x_labels, self.m_dim)
        a = self.one_hot(a_labels, self.b_dim)
        if self.submodel == "NoTarget":
            disc_x, disc_a = x, a
        else:
            disc_x = self.one_hot(drug_x_labels, self.m_dim)
            disc_a = self.one_hot(drug_a_labels, self.b_dim)
        if eps is None:
            eps = draw_gp_noise(x.shape[0], disc_x.dtype, x.device,
                                self.generator)

        if self.share_fake:
            # one G forward whose graph is kept for the G step; its detached
            # logits feed the D step
            outs = self._generate(a, x)
            generator_for_d = lambda _e, _n: outs  # noqa: E731
        else:
            def generator_for_d(e, n):
                with torch.no_grad():
                    return self._generate(e, n)

        # ---- D update (reference train.py:352-368)
        d_loss = discriminator_loss(generator_for_d, self._critic, disc_a,
                                    disc_x, a, x, self.lambda_gp, *eps,
                                    critic_gp=self._critic_gp,
                                    gp_cast=self.gp_cast)
        self.d_opt.step(_grads(d_loss, self.d_params))

        # ---- G update against the updated critic (train.py:370-384); the
        # critic pass sends gradients to the logits only
        if self.share_fake:
            node_logits, edge_logits = outs[2], outs[3]
            g_loss = -self._critic(edge_logits, node_logits).mean()
        else:
            g_loss, outs = generator_loss(self._generate, self._critic, a, x)
            node_logits, edge_logits = outs[2], outs[3]
        self.g_opt.step(_grads(g_loss, self.g_params))
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "node_logits": node_logits.detach(),
                "edge_logits": edge_logits.detach()}


def _dropout_rate(model) -> float:
    rates = [m.p for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    return max(rates, default=0.0)

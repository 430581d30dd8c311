"""One WGAN-GP training iteration (port of ``druggen_tpu/train/step.py``
``make_train_step`` :131-339 and ``make_split_train_step`` :342-472).

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
- the gradient-penalty pass: under ``gp_mode="revrev"`` on the plain critic
  (it is differentiated twice), in f32 with the interpolants cast before
  differentiation when ``gp_f32`` (JAX :185-186, :236-260).  Under
  ``gp_mode="fwdrev"`` (JAX :224-229, :288-301) its inner input-gradient
  pass is first-order: the critic's first-order passes' routing (K1/K2 or
  K7/K8), or the f32 plain critic when ``gp_f32``, with the cast at the
  critic's input so that the input gradient comes back in the compute dtype
  (JAX :244-250); its JVP pass is the plain critic in the compute dtype with
  its LayerNorms in ``forward_mode``.  With critic dropout the two passes
  draw the same masks: the JVP pass starts from the random state the inner
  pass started from, as JAX feeds both ``k_ddrop``;
- ``f32_stats``: softmax in f32, the fused tails, the megablock and the fused
  attention off (JAX :170-181).

``split=True`` is JAX ``make_split_train_step``: a D step (:meth:`d_step`,
the Generator's fake made under ``no_grad``) and then a G step
(:meth:`g_step`, a fresh Generator forward) with nothing shared between
them; under fwdrev both penalty passes take the penalty critic's routing, as
JAX's split step does.  ``node_mode="dense"`` (``--features``): the node
inputs arrive as float blocks ``[B, N, m_dim]`` in place of labels.
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


def _rng_state(device):
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_rng_state(device, state) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


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
                 g_pallas: bool = False, split: bool = False,
                 generator: torch.Generator | None = None):
        if node_mode not in ("labels", "dense"):
            raise ValueError(f"node_mode must be 'labels' or 'dense', got {node_mode!r}")
        if gp_mode not in ("revrev", "fwdrev"):
            raise ValueError(f"gp_mode must be 'revrev' or 'fwdrev', got {gp_mode!r}")
        self.G, self.D, self.g_opt, self.d_opt = G, D, g_opt, d_opt
        self.lambda_gp, self.m_dim, self.b_dim = lambda_gp, m_dim, b_dim
        self.submodel = submodel
        self.node_mode, self.gp_mode, self.split = node_mode, gp_mode, bool(split)
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
        # fwdrev: the inner pass and the JVP pass (module docstring); the
        # split step keeps both on the penalty critic (JAX :400-423)
        plain = dict(dtype=dt, fused_mlp=False, f32_stats=f32_stats, use_pallas=False)
        if self.split:
            self.d_inner = self.d_gp
            self.d_jvp = dict(self.d_gp, forward_mode=True)
            jvp_cast = self.gp_cast
        else:
            self.d_inner = self.d_gp if gp32 else self.d_first
            self.d_jvp = dict(plain, forward_mode=True)
            jvp_cast = None
        self._critic = self._critic_as(self.d_first)
        # revrev casts the interpolants itself (gradient_penalty cast_dtype)
        self._critic_gp = self._critic_as(self.d_gp)
        self._critic_inner = self._critic_as(self.d_inner, self.gp_cast)
        self._critic_jvp = self._critic_as(self.d_jvp, jvp_cast)
        g_dropout = _dropout_rate(G)
        self._d_dropout = _dropout_rate(D) > 0.0
        if self.split:
            share_fake = False
        elif share_fake == "auto":
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

    def _critic_as(self, kw: dict, cast=None):
        """The critic under the numerics ``kw``, its inputs cast to ``cast``
        at its boundary when given."""
        def critic(e, n):
            if cast is not None:
                e, n = e.to(cast), n.to(cast)
            with numerics(self.D, **kw):
                return self.D(e, n)
        return critic

    def _penalty_critics(self, device) -> dict:
        """``discriminator_loss``'s penalty critics for this step's mode."""
        if self.gp_mode == "revrev":
            return {"critic_gp": self._critic_gp, "gp_cast": self.gp_cast}
        if not self._d_dropout:
            return {"critic_gp": self._critic_inner, "critic_jvp": self._critic_jvp}
        start = {}

        def inner(e, n):
            start["rng"] = _rng_state(device)
            return self._critic_inner(e, n)

        def jvp(e, n):
            _set_rng_state(device, start["rng"])
            return self._critic_jvp(e, n)
        return {"critic_gp": inner, "critic_jvp": jvp}

    def one_hot(self, labels, width):
        dev = next(self.G.parameters()).device
        labels = torch.as_tensor(labels).to(dev, non_blocking=True).long()
        return F.one_hot(labels, width).to(self.compute_dtype)

    def nodes(self, x):
        """Node inputs: one-hot labels, or ``--features``' dense blocks."""
        if self.node_mode == "dense":
            dev = next(self.G.parameters()).device
            return torch.as_tensor(x).to(dev, non_blocking=True).to(self.compute_dtype)
        return self.one_hot(x, self.m_dim)

    def _inputs(self, x_labels, a_labels, drug_x_labels, drug_a_labels):
        x = self.nodes(x_labels)
        a = self.one_hot(a_labels, self.b_dim)
        if self.submodel == "NoTarget":
            return x, a, x, a
        return x, a, self.nodes(drug_x_labels), self.one_hot(drug_a_labels, self.b_dim)

    # ----------------------------------------------------------------------
    def _d_update(self, x, a, disc_x, disc_a, eps, generator_for_d):
        # reference train.py:352-368
        if eps is None:
            eps = draw_gp_noise(x.shape[0], disc_x.dtype, x.device,
                                self.generator)
        d_loss = discriminator_loss(generator_for_d, self._critic, disc_a,
                                    disc_x, a, x, self.lambda_gp, *eps,
                                    gp_mode=self.gp_mode,
                                    **self._penalty_critics(x.device))
        self.d_opt.step(_grads(d_loss, self.d_params))
        return d_loss

    def d_step(self, x_labels, a_labels, drug_x_labels, drug_a_labels,
               eps=None):
        """The split step's D update (JAX ``make_split_train_step``
        ``d_step``): the fake from a Generator forward under ``no_grad``.
        Returns ``d_loss`` (a device tensor, detached)."""
        self.G.train()
        self.D.train()
        inputs = self._inputs(x_labels, a_labels, drug_x_labels, drug_a_labels)

        def generator_for_d(e, n):
            with torch.no_grad():
                return self._generate(e, n)

        return self._d_update(*inputs, eps, generator_for_d).detach()

    def g_step(self, x_labels, a_labels) -> dict:
        """The split step's G update (JAX ``g_step``) against the critic as
        it stands: a fresh Generator forward.  Returns ``{"g_loss",
        "node_logits", "edge_logits"}``."""
        self.G.train()
        self.D.train()
        x, a = self.nodes(x_labels), self.one_hot(a_labels, self.b_dim)
        # reference train.py:370-384; the critic pass sends gradients to the
        # logits only
        g_loss, outs = generator_loss(self._generate, self._critic, a, x)
        self.g_opt.step(_grads(g_loss, self.g_params))
        return {"g_loss": g_loss.detach(), "node_logits": outs[2].detach(),
                "edge_logits": outs[3].detach()}

    def __call__(self, x_labels, a_labels, drug_x_labels, drug_a_labels,
                 eps=None) -> dict:
        if not self.share_fake:
            d_loss = self.d_step(x_labels, a_labels, drug_x_labels,
                                 drug_a_labels, eps)
            return {"d_loss": d_loss, **self.g_step(x_labels, a_labels)}
        self.G.train()
        self.D.train()
        x, a, disc_x, disc_a = self._inputs(x_labels, a_labels, drug_x_labels,
                                            drug_a_labels)
        # one G forward whose graph is kept for the G step; its detached
        # logits feed the D step
        outs = self._generate(a, x)
        d_loss = self._d_update(x, a, disc_x, disc_a, eps,
                                lambda _e, _n: outs)
        # G update against the updated critic (train.py:370-384)
        node_logits, edge_logits = outs[2], outs[3]
        g_loss = -self._critic(edge_logits, node_logits).mean()
        self.g_opt.step(_grads(g_loss, self.g_params))
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "node_logits": node_logits.detach(),
                "edge_logits": edge_logits.detach()}


def _dropout_rate(model) -> float:
    rates = [m.p for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    return max(rates, default=0.0)

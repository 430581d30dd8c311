"""AdamW behind the all-finite guard (port of ``druggen_tpu/train/step.py``
``make_optimizers`` :39-59 and ``apply_if_all_finite`` :68-128).

Functional AdamW in optax's order (``optax.adamw`` = ``scale_by_adam`` ->
``add_decayed_weights`` -> ``scale_by_learning_rate``), with torch's default
decoupled weight decay applied to every parameter (reference
``train.py:213-214``).  The guard commits the new parameters, moments and
count only if the gradients, the updates and the new moments are all finite,
and counts the skipped steps (``notfinite_count`` consecutive,
``total_notfinite`` lifetime), as the JAX ``AllFiniteState`` does.

A module's parameters become views of one flat f32 buffer
(:func:`flatten_parameters_`), so a step is a handful of kernels over that
buffer: one ``isfinite`` reduction per checked tensor, and the commit is a
``torch.where`` on the device.  Nothing waits for the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


def flatten_parameters_(module: nn.Module) -> torch.Tensor:
    """Move ``module``'s parameters into one contiguous f32 buffer and make
    each ``Parameter`` a view of it (the ``Parameter`` objects stay the
    same).  Call after the module is on its device; returns the buffer."""
    params = list(module.parameters())
    if not params:
        raise ValueError("module has no parameters")
    dev = params[0].device
    flat = torch.cat([p.detach().reshape(-1).to(torch.float32) for p in params])
    offset = 0
    for p in params:
        if p.device != dev:
            raise ValueError("all parameters must be on one device")
        n = p.numel()
        p.data = flat[offset:offset + n].view_as(p)
        offset += n
    return flat


@dataclasses.dataclass
class AdamWState:
    """Device tensors: ``count`` (int32, committed steps), ``mu`` and
    ``nu`` (flat f32, the parameter order), the guard's ``notfinite_count``
    and ``total_notfinite`` (int32)."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    notfinite_count: torch.Tensor
    total_notfinite: torch.Tensor


class AdamW:
    """``AdamW(module, lr, b1, b2, weight_decay, guard=True)``.

    ``step(grads)`` takes one gradient per parameter of ``module`` (in
    ``module.parameters()`` order) and updates the parameters in place.
    ``grad_hook`` (None by default), a function of the flat f32 gradient,
    runs first: the parallel modes sum the gradients over their ranks there
    (:func:`..parallel.mesh.gradient_hook`), before the guard decides."""

    def __init__(self, module: nn.Module, lr: float, b1: float = 0.9,
                 b2: float = 0.999, weight_decay: float = 0.01,
                 eps: float = 1e-8, guard: bool = True):
        self.names = [name for name, _ in module.named_parameters()]
        self.params = list(module.parameters())
        self.flat = flatten_parameters_(module)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.weight_decay, self.eps, self.guard = weight_decay, eps, guard
        self.grad_hook = None
        dev = self.flat.device
        self._b1 = torch.tensor(b1, dtype=torch.float32, device=dev)
        self._b2 = torch.tensor(b2, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        self.state = AdamWState(zero.clone(), torch.zeros_like(self.flat),
                                torch.zeros_like(self.flat), zero.clone(),
                                zero.clone())

    def _flat(self, sd: dict) -> torch.Tensor:
        return torch.cat([torch.as_tensor(sd[n]).reshape(-1) for n in self.names]
                         ).to(self.flat)

    def _unflat(self, flat: torch.Tensor) -> dict:
        out, offset = {}, 0
        for name, p in zip(self.names, self.params):
            out[name] = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return out

    def load_state(self, count, mu: dict, nu: dict, notfinite_count=0,
                   total_notfinite=0) -> None:
        """Set the optimizer state; ``mu`` and ``nu`` are state_dicts of the
        module (e.g. from :func:`..interop.weights.gan_state_to_port`)."""
        dev = self.flat.device

        def i32(v):
            return torch.tensor(np.asarray(v), dtype=torch.int32).reshape(()).to(dev)

        self.state = AdamWState(i32(count), self._flat(mu), self._flat(nu),
                                i32(notfinite_count), i32(total_notfinite))

    def moments(self) -> tuple[dict, dict]:
        """``(mu, nu)`` as state_dicts of the module (views of the state)."""
        return self._unflat(self.state.mu), self._unflat(self.state.nu)

    def flat_grads(self, grads) -> torch.Tensor:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} "
                             "parameters")
        return torch.cat([g.reshape(-1).to(torch.float32) for g in grads])

    @torch.no_grad()
    def step(self, grads) -> None:
        g = self.flat_grads(grads)
        if self.grad_hook is not None:
            g = self.grad_hook(g)
        st = self.state
        count = st.count + 1
        # scale_by_adam: moments, bias correction, eps outside the sqrt
        mu = (1.0 - self.b1) * g + self.b1 * st.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * st.nu
        countf = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self._b1, countf)
        bc2 = 1.0 - torch.pow(self._b2, countf)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        # add_decayed_weights, then scale_by_learning_rate
        upd = -self.lr * (upd + self.weight_decay * self.flat)
        if not self.guard:
            self.flat.add_(upd)
            st.count, st.mu, st.nu = count, mu, nu
            return
        ok = (torch.isfinite(g).all() & torch.isfinite(upd).all()
              & torch.isfinite(mu).all() & torch.isfinite(nu).all())
        self.flat.copy_(torch.where(ok, self.flat + upd, self.flat))
        st.mu = torch.where(ok, mu, st.mu)
        st.nu = torch.where(ok, nu, st.nu)
        st.count = torch.where(ok, count, st.count)
        st.notfinite_count = torch.where(ok, 0, st.notfinite_count + 1).to(torch.int32)
        st.total_notfinite = (st.total_notfinite + (~ok).to(torch.int32))


def make_optimizers(cfg, G: nn.Module, D: nn.Module) -> tuple[AdamW, AdamW]:
    """AdamW x2 (reference train.py:213-214), each behind the all-finite
    guard unless ``cfg.nonfinite_guard`` is off."""
    guard = getattr(cfg, "nonfinite_guard", True)
    g_opt = AdamW(G, cfg.g_lr, cfg.beta1, cfg.beta2, cfg.adam_weight_decay,
                  guard=guard)
    d_opt = AdamW(D, cfg.d_lr, cfg.beta1, cfg.beta2, cfg.adam_weight_decay,
                  guard=guard)
    return g_opt, d_opt

"""The port's reverse-over-forward gradient penalty (``gp_mode="fwdrev"``)
on the CPU.

- The penalty against JAX ``gradient_penalty_fwdrev`` under
  ``jax.value_and_grad`` (one small jit, no train-step compile), at the
  interop sizes (``tests/test_torch_interop.py:40-41``: critic depth 2): f32
  value to rtol 1e-5, every critic parameter's gradient to a relative norm
  error of 1e-4.  The port's JVP pass runs its LayerNorms from primitives
  (``numerics(forward_mode=True)``, held against ``F.layer_norm`` below);
  with torch's ``F.layer_norm`` there the gradients are off (1.4 relative at
  critic depth 2 on torch 2.13), which this comparison catches.
- Three steps of the port's fwdrev step against its revrev step from the
  same state, under the limits of JAX's own ``tests/test_train_step.py:
  242-275`` (losses rtol 1e-5 for D, 1e-4 for G; D parameters atol 1e-6 +
  rtol 1e-5): critic depth 2, with critic dropout (the two penalty passes
  draw the same masks), through the fused tail (K1/K2) and through the
  megablock (K7/K8), whose inner pass a spy sees go through the op (its
  plain version here); in bf16 under ``test_torch_port_train_bf16.py``'s
  limits.
- A fused op reached inside a forward-mode pass raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.train.losses import gradient_penalty_fwdrev as jax_gp_fwdrev
from druggen_tpu_torch.config import TrainConfig
from druggen_tpu_torch.interop.weights import (
    flax_discriminator_to_torch,
    torch_discriminator_to_flax,
)
from druggen_tpu_torch.models import Discriminator, Generator, numerics
from druggen_tpu_torch.ops import fused_attention as fa
from druggen_tpu_torch.ops import fused_block as fb
from druggen_tpu_torch.ops import fused_generator as fg
from druggen_tpu_torch.ops import fused_mlp as fm
from druggen_tpu_torch.train.losses import gradient_penalty_fwdrev
from druggen_tpu_torch.train.optim import make_optimizers
from druggen_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)

# the interop sizes (tests/test_torch_interop.py:40-41)
DIM, HEADS, DEPTH, MLP_RATIO = 32, 4, 2, 3
B, N, M_DIM, B_DIM = 3, 9, 8, 5
BF16_TOL = {"loss": 2e-2, "update": {"g": 0.35, "d": 0.2},
            "moment": {"g": 0.2, "d": 5e-2}}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def penalty_case():
    """A critic at the interop sizes (the port's initialisation, carried into
    the JAX critic), the interpolation end points and the JAX fwdrev
    penalty with its gradients."""
    rng = np.random.default_rng(0)
    real_n = jax.nn.one_hot(rng.integers(0, M_DIM, (B, N)), M_DIM)
    a = rng.integers(0, B_DIM, (B, N, N))
    real_e = jax.nn.one_hot(np.triu(a, 1) + np.triu(a, 1).transpose(0, 2, 1), B_DIM)
    fake_n = jnp.asarray(rng.normal(size=(B, N, M_DIM)).astype(np.float32))
    fake_e = jnp.asarray(rng.normal(size=(B, N, N, B_DIM)).astype(np.float32))
    jd = JaxD(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=DEPTH, heads=HEADS, mlp_ratio=MLP_RATIO)
    D = Discriminator("relu", N, B_DIM, M_DIM, 0.0, DIM, DEPTH, HEADS, MLP_RATIO,
                      generator=torch.Generator().manual_seed(1))
    variables = torch_discriminator_to_flax(D.state_dict())
    key = jax.random.PRNGKey(2)

    @jax.jit
    def value_and_grad(v):
        return jax.value_and_grad(lambda p: jax_gp_fwdrev(
            lambda e, n: jd.apply(p, e, n), real_n, real_e, fake_n, fake_e, key))(v)

    value, grads = jax.device_get(value_and_grad(variables))
    # the eps draws of the JAX penalty (losses.py:101-103)
    k_node, k_edge = jax.random.split(key)
    eps = (jax.random.uniform(k_node, (B, 1, 1)), jax.random.uniform(k_edge, (B, 1, 1, 1)))
    t = lambda v: torch.from_numpy(np.array(v, np.float32))  # noqa: E731
    return {"D": D, "inputs": [t(v) for v in (real_n, real_e, fake_n, fake_e, *eps)],
            "value": float(value), "grads": flax_discriminator_to_torch(grads)}


def _port_penalty(case, forward_mode: bool):
    D = case["D"]

    def critic(e, n):
        return D(e, n)

    def critic_jvp(e, n):
        with numerics(D, forward_mode=forward_mode):
            return D(e, n)

    gp = gradient_penalty_fwdrev(critic, *case["inputs"], critic_jvp=critic_jvp)
    names, params = zip(*D.named_parameters())
    grads = torch.autograd.grad(gp, params, allow_unused=True, materialize_grads=True)
    return gp.item(), {k: g.numpy() for k, g in zip(names, grads)}


def test_fwdrev_penalty_matches_jax(penalty_case):
    value, grads = _port_penalty(penalty_case, forward_mode=True)
    np.testing.assert_allclose(value, penalty_case["value"], rtol=1e-5)
    want = penalty_case["grads"]
    assert sorted(grads) == sorted(want)
    errs = {k: _rel(grads[k], np.asarray(want[k])) for k in want}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_forward_mode_layer_norm_equals_layer_norm(dtype):
    """The JVP pass's LayerNorm (primitives) computes torch's: the value and
    the reverse-mode gradients of input and parameters."""
    from druggen_tpu_torch.models import LayerNorm

    gen = torch.Generator().manual_seed(5)
    ln = LayerNorm(16, dtype)
    with torch.no_grad():
        ln.weight.copy_(torch.randn(16, generator=gen))
        ln.bias.copy_(torch.randn(16, generator=gen))
    x = (torch.randn(6, 16, generator=gen) * 3 + 1).requires_grad_()
    ct = torch.randn(6, 16, generator=gen)
    outs = []
    for mode in (False, True):
        ln.forward_mode = mode
        y = ln(x)
        outs.append((y.float(), *torch.autograd.grad(y, (x, ln.weight, ln.bias),
                                                      ct.to(y.dtype))))
    tol = 1e-5 if dtype is None else 1e-2
    for a, b in zip(*outs):
        torch.testing.assert_close(b.float(), a.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------- the step

def _batches(n_steps, seed=0):
    rng = np.random.default_rng(seed)

    def sym(r):
        return np.triu(r, 1) + np.triu(r, 1).transpose(0, 2, 1)
    return [(rng.integers(0, M_DIM, (B, N)), sym(rng.integers(0, B_DIM, (B, N, N))),
             rng.integers(0, M_DIM, (B, N)), sym(rng.integers(0, B_DIM, (B, N, N))))
            for _ in range(n_steps)]


def _step(gp_mode, dtype=torch.float32, fused=False, ddropout=0.0, gp_f32=False):
    """Fresh models (the same seeds every call) and the port's step."""
    tdt = None if dtype == torch.float32 else dtype
    G = Generator("relu", N, B_DIM, M_DIM, 0.0, DIM, 1, HEADS, MLP_RATIO, dtype=tdt,
                  fused_mlp=fused, generator=torch.Generator().manual_seed(3))
    D = Discriminator("relu", N, B_DIM, M_DIM, ddropout, DIM, DEPTH, HEADS, MLP_RATIO,
                      dtype=tdt, generator=torch.Generator().manual_seed(4))
    cfg = TrainConfig(raw_file="x", drug_raw_file="y", batch_size=B, max_atom=N,
                      dim=DIM, heads=HEADS, mlp_ratio=MLP_RATIO, ddepth=DEPTH)
    g_opt, d_opt = make_optimizers(cfg, G, D)
    return TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM, b_dim=B_DIM,
                     compute_dtype=dtype, g_fused=fused, fused_critic=fused,
                     gp_mode=gp_mode, gp_f32=gp_f32)


def _three_steps(step):
    losses = []
    start = [torch.cat([p.detach().flatten() for p in m.parameters()])
             for m in (step.G, step.D)]
    for i, batch in enumerate(_batches(3)):
        noise = torch.Generator().manual_seed(i)
        eps = (torch.rand((B, 1, 1), generator=noise).to(step.compute_dtype),
               torch.rand((B, 1, 1, 1), generator=noise).to(step.compute_dtype))
        torch.manual_seed(100 + i)          # the dropout masks
        out = step(*batch, eps=eps)
        losses.append((out["d_loss"].float().item(), out["g_loss"].float().item()))
    params = [torch.cat([p.detach().flatten() for p in m.parameters()])
              for m in (step.G, step.D)]
    opts = (step.g_opt, step.d_opt)
    return {"losses": np.array(losses), "start": start, "params": params,
            "mu": [o.state.mu.clone() for o in opts],
            "nu": [o.state.nu.clone() for o in opts]}


class _Spy:
    """Counts the calls of a fused op's forward and backward (on the CPU
    their plain versions)."""

    def __init__(self, monkeypatch, module, fwd: str, bwd: str):
        self.calls = {"fwd": 0, "bwd": 0}
        for kind, name in (("fwd", fwd), ("bwd", bwd)):
            inner = getattr(module, name)

            def counted(*args, _inner=inner, _kind=kind, **kw):
                self.calls[_kind] += 1
                return _inner(*args, **kw)
            monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fused", [False, True, "block"])
def test_fwdrev_step_equals_revrev(monkeypatch, fused):
    """Critic depth 2 (the LayerNorm trap shows there); ``fused``: G and
    the critic's first-order passes on the fused tail (K1/K2) or the
    megablock (K7/K8).  Under fwdrev the penalty's inner pass goes through
    the op too: 4 first-order critic passes a step in place of 3."""
    spy = None
    if fused == "block":
        spy = _Spy(monkeypatch, fb, "fused_block_fwd", "fused_block_bwd")
        per_pass = DEPTH              # the last block's megablock runs too
    elif fused:
        spy = _Spy(monkeypatch, fm, "fused_ln_mlp_ln", "fused_ln_mlp_ln_bwd")
        per_pass = DEPTH - 1          # the last block's edge tail is skipped
    runs = {}
    for mode in ("revrev", "fwdrev"):
        if spy:
            spy.calls.update(fwd=0, bwd=0)
        runs[mode] = _three_steps(_step(mode, fused=fused))
        if spy:
            passes = 4 if mode == "fwdrev" else 3
            want = 3 * (1 + passes * per_pass)      # G depth 1, 3 steps
            assert spy.calls == {"fwd": want, "bwd": want}, (mode, spy.calls)
    rev, fwd = runs["revrev"], runs["fwdrev"]
    np.testing.assert_allclose(fwd["losses"][:, 0], rev["losses"][:, 0], rtol=1e-5)
    np.testing.assert_allclose(fwd["losses"][:, 1], rev["losses"][:, 1], rtol=1e-4)
    np.testing.assert_allclose(fwd["params"][1].numpy(), rev["params"][1].numpy(),
                               atol=1e-6, rtol=1e-5)
    assert not torch.equal(fwd["params"][1], fwd["start"][1])


def test_fwdrev_step_with_critic_dropout_equals_revrev():
    """The inner pass and the JVP pass draw the same dropout masks, and
    revrev's penalty pass draws those masks too: the steps agree."""
    rev = _three_steps(_step("revrev", ddropout=0.2))
    fwd = _three_steps(_step("fwdrev", ddropout=0.2))
    np.testing.assert_allclose(fwd["losses"][:, 0], rev["losses"][:, 0], rtol=1e-5)
    np.testing.assert_allclose(fwd["params"][1].numpy(), rev["params"][1].numpy(),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("gp_f32", [False, True])
def test_fwdrev_step_equals_revrev_in_bf16(gp_f32):
    """bf16 (the published numerics; ``gp_f32``: tier 1's f32 penalty
    pass, under fwdrev the inner pass in f32 and the JVP pass in bf16),
    under the limits ``test_torch_port_train_bf16.py`` holds the port's
    bf16 step to against JAX's."""
    rev = _three_steps(_step("revrev", dtype=torch.bfloat16, gp_f32=gp_f32))
    fwd = _three_steps(_step("fwdrev", dtype=torch.bfloat16, gp_f32=gp_f32))
    loss = np.abs(fwd["losses"] - rev["losses"]) / (1 + np.abs(rev["losses"]))
    assert loss.max() <= BF16_TOL["loss"], loss
    for i, name in enumerate("gd"):
        update = _rel((fwd["params"][i] - fwd["start"][i]).numpy(),
                      (rev["params"][i] - rev["start"][i]).numpy())
        assert update <= BF16_TOL["update"][name], (name, update)
        for what in ("mu", "nu"):
            err = _rel(fwd[what][i].numpy(), rev[what][i].numpy())
            assert err <= BF16_TOL["moment"][name], (name, what, err)


# ------------------------------------------------- no fused op in a JVP pass

def _k1(x):
    c = x.shape[-1]
    w = torch.ones(c)
    return fm.FusedLnMlpLn.apply(x, w, w * 0, torch.eye(c), w * 0, torch.eye(c), w * 0,
                                 w, w * 0)


def _k5(x):
    b, n, _, c = x.shape
    q = x[:, :, 0].reshape(b, n, 2, c // 2)
    w = torch.eye(c)
    return fa.edge_modulated_attention_proj(q, q, q, x, w, w[0], w, w[0])[0]


def _k3(x):
    b, n, _, c = x.shape
    q = x[:, :, 0].reshape(b, n, 2, c // 2)
    return fa.edge_modulated_attention(q, q, q, x.reshape(b, n, n, 2, c // 2))[0]


def _k7(x):
    c = x.shape[-1]
    q = x[:, :, 0]
    w, v = torch.eye(c), torch.ones(c)
    return fb.fused_block_edge_stream(q, q, q, x, w, v, w, v, v, v, w, v, w, v, v, v,
                                      heads=2)[0]


def _k9(x):
    G = Generator("relu", x.shape[1], x.shape[-1], 3, 0.0, 8, 1, 2, 2)
    z_n = torch.zeros(x.shape[0], x.shape[1], 3)
    return fg.fused_generator_logits(G, x, z_n, heads=2)[1]


@pytest.mark.parametrize("op", [_k1, _k5, _k3, _k7, _k9], ids=["K1", "K5", "K3", "K7", "K9"])
def test_fused_op_in_a_jvp_pass_raises(op):
    x = torch.randn(2, 4, 4, 8)
    op(x)                                   # first order: runs (plain version)
    with pytest.raises(RuntimeError, match="forward-mode"):
        torch.func.jvp(op, (x,), (torch.ones_like(x),))
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(x, torch.ones_like(x))
        with pytest.raises(RuntimeError, match="forward-mode"):
            op(dual)


def test_fused_critic_as_the_jvp_critic_raises(penalty_case):
    """A critic routed through the fused tail, handed to the penalty as its
    JVP critic, raises; it does not run the tail's plain version."""
    D = penalty_case["D"]

    def fused(e, n):
        with numerics(D, fused_mlp=True, forward_mode=True):
            return D(e, n)

    with pytest.raises(RuntimeError, match="forward-mode"):
        gradient_penalty_fwdrev(D, *penalty_case["inputs"], critic_jvp=fused)

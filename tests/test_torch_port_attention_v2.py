"""K3/K4, the v2 edge attention op (no projections), in the PyTorch port.

The port's plain versions of the forward and backward kernels (what its
wrappers run for a CPU tensor) are held against the JAX package's Pallas
kernels (``_fwd_pallas``, ``_bwd_pallas``) run through the interpreter on
the same numpy inputs, at the JAX attention tests' size (B 2, N 9, D 128,
8 heads: the routing rule sends a width that is not a multiple of 128 to
the jnp path).  Tolerances, compared in f32, those of the K5/K6 file: f32
1e-5 (the same operations, f32 sums in another order); bf16 atol 1e-2 +
rtol 2^-7 (a sum in another order can round to the neighbouring bf16
value).  The op's gradients through :class:`EdgeAttention` against
``jax.grad`` through the JAX ``custom_vjp`` (f32, 1e-4 + 1e-5 relative: the
softmax backward's sums over 9 keys); first order only; the routing rule
against the one the JAX op takes, observed under ``jax.eval_shape``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.ops import fused_attention as jax_fa
from druggen_tpu_torch.ops import fused_attention as port

torch.set_num_threads(1)

B, N, D, HEADS = 2, 9, 128, 8
DK = D // HEADS
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, n=N):
    """q, k, v [B, N, D], e [B, N, N, D], then the cotangents ge, gn."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, n, D), (B, n, D), (B, n, D), (B, n, n, D), (B, n, n, D), (B, n, D))]


@functools.cache
def _pallas_run(name):
    """One interpreted Pallas forward and backward on numpy inputs."""
    _, jdt = DTYPES[name]
    arrs = [jnp.asarray(x, jdt) for x in _inputs(0)]
    return jax_fa._fwd_pallas(*arrs[:4], DK, True), jax_fa._bwd_pallas(*arrs, DK, True)


def _close(got, want, tdt, name):
    assert got.dtype == tdt, name
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape, name
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7, err_msg=name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_fwd_matches_pallas(name):
    tdt, _ = DTYPES[name]
    want, _ = _pallas_run(name)
    got = port.edge_attention_v2_fwd(*[torch.from_numpy(x).to(tdt) for x in _inputs(0)[:4]],
                                     HEADS)
    for label, g, w in zip(("edge_pre", "node_agg"), got, want):
        _close(g, w, tdt, label)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_bwd_matches_pallas(name):
    tdt, _ = DTYPES[name]
    _, want = _pallas_run(name)
    got = port.edge_attention_v2_bwd(*[torch.from_numpy(x).to(tdt) for x in _inputs(0)], HEADS)
    for label, g, w in zip(("dq", "dk", "dv", "de"), got, want):
        _close(g, w, tdt, label)


def test_op_gradients_match_jax(monkeypatch):
    """``edge_modulated_attention`` through :class:`EdgeAttention` (its
    plain versions here) against ``jax.grad`` through the JAX op's
    ``custom_vjp`` in the interpreter: outputs and the four input gradients
    of a loss of both outputs, f32."""
    q, k, v, e, wo, wn = _inputs(1)
    shaped = [q.reshape(B, N, HEADS, DK), k.reshape(B, N, HEADS, DK),
              v.reshape(B, N, HEADS, DK), e.reshape(B, N, N, HEADS, DK)]

    def loss(*args):
        ep, na = jax_fa.edge_modulated_attention(*args, interpret=True)
        return jnp.sum(ep * wo) + jnp.sum(na * wn)

    want_out = jax_fa.edge_modulated_attention(*[jnp.asarray(x) for x in shaped],
                                               interpret=True)
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*[jnp.asarray(x) for x in shaped])
    calls = []
    orig = port.EdgeAttention.apply
    monkeypatch.setattr(port.EdgeAttention, "apply", lambda *a: calls.append(1) or orig(*a))
    leaves = [torch.from_numpy(x).requires_grad_() for x in shaped]
    ep, na = port.edge_modulated_attention(*leaves)
    assert calls == [1]
    for g, w in zip((ep, na), want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    ((ep * torch.from_numpy(wo)).sum() + (na * torch.from_numpy(wn)).sum()).backward()
    for label, leaf, w in zip("qkve", leaves, want):
        assert leaf.grad.shape == w.shape, label
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5,
                                   err_msg=label)


def test_backward_is_first_order_only():
    leaves = [torch.from_numpy(x).requires_grad_() for x in _inputs(2)[:4]]
    ep, _ = port.EdgeAttention.apply(*leaves, HEADS)
    (gq,) = torch.autograd.grad(ep.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[3])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_routing_rule_matches_jax(dtype, monkeypatch):
    """Over a grid of (N, D): the port's rule sends a shape to K3/K4 exactly
    when the JAX op takes its Pallas custom_vjp (12 MiB, against the v3
    op's 10)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    taken = []

    def fake_op(n, h, dk, interpret, dtype_name):
        taken.append(True)
        return lambda q3, k3, v3, e4: (e4, q3)

    monkeypatch.setattr(jax_fa, "_make_op", fake_op)
    sent = differs_from_v3 = 0
    for n in (7, 9, 40, 45, 46, 49, 50, 55, 56, 62, 63, 70, 71, 78, 79, 110, 111):
        for d in (32, 64, 96, 128, 256, 384, 512, 1024):
            taken.clear()
            spec = jax.ShapeDtypeStruct
            jax.eval_shape(lambda *a: jax_fa.edge_modulated_attention(*a, interpret=True),
                           spec((1, n, 8, d // 8), jdt), spec((1, n, 8, d // 8), jdt),
                           spec((1, n, 8, d // 8), jdt), spec((1, n, n, 8, d // 8), jdt))
            assert port.uses_v2_kernel(n, d, dtype) == bool(taken), (n, d)
            sent += bool(taken)
            differs_from_v3 += port.uses_v2_kernel(n, d, dtype) != port.uses_kernel(n, d, dtype)
    assert sent > 0 and differs_from_v3 > 0


def test_op_takes_the_reference_where_the_rule_says():
    """D 32 goes to ``reference_attention``, differentiable to any order,
    and matches the JAX op's jnp path."""
    q, k, v, e = (x[..., :32] for x in _inputs(3)[:4])
    shaped = [q.reshape(B, N, 4, 8), k.reshape(B, N, 4, 8), v.reshape(B, N, 4, 8),
              e.reshape(B, N, N, 4, 8)]
    got = port.edge_modulated_attention(*[torch.from_numpy(np.ascontiguousarray(x))
                                          for x in shaped])
    want = jax_fa.edge_modulated_attention(*[jnp.asarray(x) for x in shaped], interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)

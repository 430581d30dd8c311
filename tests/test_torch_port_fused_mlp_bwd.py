"""K2 (the backward of ``fused_ln_mlp_ln``) of the PyTorch port against the
JAX package, on the CPU.

The port's plain version of K2 is held against the Pallas ``_bwd_kernel``
run in interpret mode and against ``jax.vjp`` of the JAX fused op, on the
same numpy inputs; the port's autograd Function (K1 forward, K2 backward,
which take their plain versions on a CPU tensor) against autograd of the
plain forward.

Tolerances: f32, ``ds`` atol 1e-5, and each parameter gradient (a sum over
the rows, in another order) atol 1e-5 + rtol 1e-5.  bf16, compared in f32:
``ds`` atol 3e-2 + rtol 2^-6 (the same bf16 rounding points, with f32 sums
in another order: a value may round to the neighbouring bf16 number, one ulp
is 2^-6 below |ds| = 4 and 2^-5 up to 8, and a flip of a rounded ``dm`` or
``dh`` on the way moves ``ds`` by a few of its ulps) and each gradient by
relative norm error 1e-2 (its bf16 operands may each round the other way).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.ops import fused_mlp as jax_fused
from druggen_tpu_torch.ops import fused_mlp as port

torch.set_num_threads(1)

C, H, ROWS = 128, 384, 200
NAMES = ("ds", "dg1", "dbl1", "dw1", "db1", "dw2", "db2", "dg2", "dbl2")


def _inputs(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C, H)) / math.sqrt(C), rng.normal(size=(H,)) * 0.1,
         rng.normal(size=(H, C)) / math.sqrt(H), rng.normal(size=(C,)) * 0.1,
         rng.normal(size=(C,)) * 0.5 + 1.0, rng.normal(size=(C,)) * 0.1)
    p = [x.astype(np.float32) for x in p]
    s = rng.normal(size=(rows, C)).astype(np.float32)
    dout = rng.normal(size=(rows, C)).astype(np.float32)
    return s, p, dout


def _assert_grads_close(got, ref, bf16):
    for name, g, r in zip(NAMES, got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert g.shape == r.shape, name
        if bf16 and name == "ds":
            np.testing.assert_allclose(g, r, atol=3e-2, rtol=2 ** -6, err_msg=name)
        elif bf16:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= 1e-2, (name, rel)
        elif name == "ds":
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)


def _port_bwd(s, p, dout, dtype):
    t = [torch.from_numpy(x) for x in p]
    out = port.fused_ln_mlp_ln_bwd_reference(
        torch.from_numpy(s).to(dtype), *t, torch.from_numpy(dout).to(dtype))
    assert out[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in out[1:])
    return [g.float().numpy() for g in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(dtype):
    s, p, dout = _inputs(0)
    jdt = jnp.dtype(dtype)
    ref = jax_fused._bwd_pallas(jnp.asarray(s, jdt), *map(jnp.asarray, p),
                                jnp.asarray(dout, jdt), interpret=True)
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    got = _port_bwd(s, p, dout, getattr(torch, dtype))
    _assert_grads_close(got, ref, dtype == "bfloat16")


def test_plain_bwd_matches_jax_vjp_of_the_fused_op():
    """The JAX op's custom_vjp (leading axes kept) in f32."""
    s, p, dout = _inputs(1, rows=2 * 5 * 5)
    s4, d4 = s.reshape(2, 5, 5, C), dout.reshape(2, 5, 5, C)
    _, vjp = jax.vjp(lambda *a: jax_fused.fused_ln_mlp_ln(*a, interpret=True),
                     jnp.asarray(s4), *map(jnp.asarray, p))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(d4))]
    t = [torch.from_numpy(x) for x in p]
    got = port.fused_ln_mlp_ln_bwd_reference(torch.from_numpy(s4), *t,
                                             torch.from_numpy(d4))
    assert got[0].shape == s4.shape
    _assert_grads_close([g.numpy() for g in got], ref, bf16=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_autograd_of_the_plain_forward(dtype):
    """On the CPU the Function runs the plain K1 forward and the plain K2
    backward; autograd through the plain forward gives the same gradients
    (bf16: autograd rounds its cotangents at the casts, K2 at its own
    points, hence the bf16 tolerance)."""
    s, p, dout = _inputs(2, rows=3 * 4 * 4)
    grads = []
    for fn in (port.FusedLnMlpLn.apply, port.fused_ln_mlp_ln_reference):
        leaves = [torch.from_numpy(s.reshape(3, 4, 4, C)).to(dtype).requires_grad_()]
        leaves += [torch.from_numpy(x).requires_grad_() for x in p]
        out = fn(*leaves)
        assert out.dtype == dtype and out.shape == leaves[0].shape
        g = torch.autograd.grad(out, leaves, torch.from_numpy(dout).reshape(
            out.shape).to(dtype))
        grads.append([x.float().numpy() for x in g])
    _assert_grads_close(grads[0], grads[1], dtype == torch.bfloat16)


def test_autograd_function_is_first_order_only():
    s, p, _ = _inputs(3, rows=16)
    leaves = [torch.from_numpy(s).requires_grad_()]
    leaves += [torch.from_numpy(x).requires_grad_() for x in p]
    out = port.FusedLnMlpLn.apply(*leaves)
    (gs,) = torch.autograd.grad(out.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gs.sum(), leaves[3])


def test_cpu_tensors_take_the_plain_versions():
    s, p, dout = _inputs(4, rows=8)
    t = [torch.from_numpy(x) for x in p]
    before = (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches)
    got = port.fused_ln_mlp_ln_bwd(torch.from_numpy(s), *t, torch.from_numpy(dout))
    ref = port.fused_ln_mlp_ln_bwd_reference(torch.from_numpy(s), *t,
                                             torch.from_numpy(dout))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (port.fused_ln_mlp_ln.launches, port.fused_ln_mlp_ln_bwd.launches) == before

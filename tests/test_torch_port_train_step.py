"""The port's WGAN-GP losses, optimizer and train step against the JAX
package, on the CPU (f32).

One JAX ``GANState`` (``init_state``) is converted to the port
(``interop.weights.gan_state_to_port``); both packages then take the same
steps on the same numpy batches, with the JAX gradient-penalty noise handed
to the port.  The port's Generator runs its fused edge tail (on the CPU the
plain versions of K1 and K2, which ``test_torch_port_fused_mlp_bwd.py``
holds against the Pallas kernels in interpret mode); the JAX step runs the
same op on XLA, which keeps its compile time to seconds.  Tolerances (f32,
sums in another order): losses rtol 1e-5; parameters atol 1e-6 (a step
moves them by ~lr = 1e-5) and each model's change over the 3 steps by
relative norm error 1e-3 (2.2e-4 measured for the critic's, on the CPU; a
model left unchanged reads 1); AdamW moments by relative norm error 1e-3
(the critic's gradients come through the gradient penalty's double
backward, whose second-order terms cancel: single elements of mu differ by
up to 1e-4 relative).

The port's ``--fused_block`` step (the megablock on G and on the critic's
first-order passes; on the CPU the plain versions of K7 and K8, which
``test_torch_port_fused_block.py`` holds against the Pallas kernels) is held
against the same JAX f32 step under the same limits: JAX's own
``fused_critic="block"`` step computes the same function, but compiling its
interpreted Pallas kernels takes ~70 s on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from druggen_tpu.config import TrainConfig
from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.train.losses import discriminator_loss as jax_d_loss
from druggen_tpu.train.losses import gradient_penalty as jax_gp
from druggen_tpu.train.step import apply_if_all_finite, init_state
from druggen_tpu.train.step import make_optimizers as jax_make_optimizers
from druggen_tpu.train.step import make_train_step
from druggen_tpu_torch.interop.weights import gan_state_to_port, to_torch_tensors
from druggen_tpu_torch.models import Discriminator, Generator
from druggen_tpu_torch.train.losses import discriminator_loss, gradient_penalty
from druggen_tpu_torch.train.optim import AdamW, make_optimizers
from druggen_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)

B, N, M_DIM, B_DIM, DIM, HEADS = 4, 7, 5, 4, 16, 4


def _cfg(**kw):
    return TrainConfig(raw_file="x.smi", drug_raw_file="y.smi", batch_size=B,
                       max_atom=N, dim=DIM, heads=HEADS, mlp_ratio=2, **kw)


def _batches(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        def sym(r):
            return np.triu(r, 1) + np.triu(r, 1).transpose(0, 2, 1)
        out.append((rng.integers(0, M_DIM, (B, N)),
                    sym(rng.integers(0, B_DIM, (B, N, N))),
                    rng.integers(0, M_DIM, (B, N)),
                    sym(rng.integers(0, B_DIM, (B, N, N)))))
    return out


def _jax_gp_noise(key, step, dtype):
    """The eps draws of the JAX step (train/step.py:260-261,
    losses.py:48-50) for the port."""
    k_gp = jax.random.split(jax.random.fold_in(key, step), 5)[0]
    k_node, k_edge = jax.random.split(k_gp)
    en = jax.random.uniform(k_node, (B, 1, 1), dtype)
    ee = jax.random.uniform(k_edge, (B, 1, 1, 1), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return (torch.from_numpy(np.array(en.astype(jnp.float32))).to(tdt),
            torch.from_numpy(np.array(ee.astype(jnp.float32))).to(tdt))


def jax_step(submodel="DrugGEN", share_fake="auto", ddepth=1,
             dtype=jnp.float32, gp_f32=False):
    """JAX models, optimizers and the jitted step (compiled at first call)."""
    jdt = None if dtype == jnp.float32 else dtype
    jg = JaxG(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2, dtype=jdt)
    jd = JaxD(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=ddepth, heads=HEADS, mlp_ratio=2, dtype=jdt)
    g_opt, d_opt = jax_make_optimizers(_cfg(ddepth=ddepth))
    step = make_train_step(jg, jd, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM,
                           b_dim=B_DIM, submodel=submodel, donate=False,
                           compute_dtype=dtype, share_fake=share_fake,
                           gp_f32=gp_f32)
    return jg, jd, g_opt, d_opt, step


@pytest.fixture(scope="module")
def jax_f32():
    return jax_step()


def port_setup(jax_parts, submodel="DrugGEN", share_fake="auto",
               fused_critic=False, dtype=jnp.float32, gp_f32=False,
               g_fused=True):
    """A fresh JAX ``GANState`` and the port's models, optimizers and step
    converted from it."""
    jg, jd, g_opt, d_opt, step = jax_parts
    ddepth = jd.depth
    cfg = _cfg(ddepth=ddepth)
    tdt = None if dtype == jnp.float32 else torch.bfloat16
    state = init_state(jg, jd, g_opt, d_opt, jax.random.PRNGKey(0), N, M_DIM,
                       B_DIM)
    port = gan_state_to_port(jax.device_get(state))
    G = Generator("relu", N, B_DIM, M_DIM, 0.0, DIM, 1, HEADS, 2, dtype=tdt,
                  fused_mlp=g_fused)
    D = Discriminator("relu", N, B_DIM, M_DIM, 0.0, DIM, ddepth, HEADS, 2,
                      dtype=tdt)
    G.load_state_dict(to_torch_tensors(port["g"]))
    D.load_state_dict(to_torch_tensors(port["d"]))
    pg_opt, pd_opt = make_optimizers(cfg, G, D)
    for opt, name in ((pg_opt, "g_opt"), (pd_opt, "d_opt")):
        st = port[name]
        opt.load_state(st["count"], to_torch_tensors(st["mu"]),
                       to_torch_tensors(st["nu"]), st["notfinite_count"],
                       st["total_notfinite"])
    pstep = TrainStep(G, D, pg_opt, pd_opt, lambda_gp=10.0, m_dim=M_DIM,
                      b_dim=B_DIM, submodel=submodel,
                      compute_dtype=torch.float32 if tdt is None else tdt,
                      g_fused=g_fused, share_fake=share_fake,
                      fused_critic=fused_critic, gp_f32=gp_f32)
    return state, step, (G, D, pg_opt, pd_opt), pstep


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def step_readings(setup, dtype, drug_is_mol=False, port_batch=None):
    """Three steps in both packages, and how far the port ends from JAX:
    ``loss``, the largest |port - jax| / (1 + |jax|) of a step's loss; for
    each model (``"g"``, ``"d"``) ``param`` (largest absolute difference),
    ``update`` (relative norm error of the 3-step parameter change),
    ``mu`` and ``nu`` (relative norm errors), ``count`` and ``skipped``
    (the port's and JAX's).  ``drug_is_mol``: feed the JAX step the mol
    batch as its drug batch (what its NoTarget routing does).
    ``port_batch``: a function the port's batch goes through (to plant a
    fault)."""
    state, step, (G, D, g_opt, d_opt), pstep = setup
    start = gan_state_to_port(jax.device_get(state))
    key = jax.random.PRNGKey(42)
    loss = 0.0
    for i, (x, a, dx, da) in enumerate(_batches(3)):
        eps = _jax_gp_noise(key, i, dtype)
        jx, ja = (x, a) if drug_is_mol else (dx, da)
        state, m, _ = step(state, key, x, a, jx, ja)
        batch = (x, a, dx, da) if port_batch is None else port_batch(x, a, dx, da)
        out = pstep(*batch, eps=eps)
        for name in ("d_loss", "g_loss"):
            ref = float(m[name])
            loss = max(loss, abs(out[name].float().item() - ref) / (1 + abs(ref)))
    ref = gan_state_to_port(jax.device_get(state))

    def flat(tree, keys):
        return np.concatenate([np.asarray(tree[k], np.float32).ravel() for k in keys])

    readings = {"loss": loss}
    for model, opt, name in ((G, g_opt, "g"), (D, d_opt, "d")):
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        mu, nu = ({k: v.numpy() for k, v in m.items()} for m in opt.moments())
        rst = ref[f"{name}_opt"]
        before = flat(start[name], sd)
        readings[name] = {
            "param": np.abs(flat(sd, sd) - flat(ref[name], sd)).max(),
            "update": _rel(flat(sd, sd) - before, flat(ref[name], sd) - before),
            "mu": _rel(flat(mu, sd), flat(rst["mu"], sd)),
            "nu": _rel(flat(nu, sd), flat(rst["nu"], sd)),
            "count": (int(opt.state.count), int(rst["count"])),
            "skipped": (int(opt.state.total_notfinite), int(rst["total_notfinite"])),
        }
    return readings


def run_and_compare(setup, dtype, tol, drug_is_mol=False):
    """:func:`step_readings` held to ``tol``: ``loss``, ``param`` (optional),
    ``update`` and ``moment`` (mu and nu); ``update`` and ``moment`` may be
    ``{"g": ..., "d": ...}``."""
    r = step_readings(setup, dtype, drug_is_mol)
    assert r["loss"] <= tol["loss"], r["loss"]
    for name in ("g", "d"):
        got = r[name]
        assert got["count"] == (3, 3) and got["skipped"] == (0, 0), (name, got)
        if "param" in tol:
            assert got["param"] <= tol["param"], (name, got)
        for key, reads in (("update", ("update",)), ("moment", ("mu", "nu"))):
            limit = tol[key][name] if isinstance(tol[key], dict) else tol[key]
            assert max(got[k] for k in reads) <= limit, (name, got)


F32_TOL = {"loss": 1e-5, "param": 1e-6, "update": 1e-3, "moment": 1e-3}


@pytest.mark.parametrize("submodel,share_fake", [("DrugGEN", "auto"),
                                                 ("NoTarget", False)])
def test_three_steps_match_jax(jax_f32, submodel, share_fake):
    """DrugGEN with one shared G forward, and NoTarget with two G forwards
    (share_fake off), against the JAX DrugGEN step with share_fake on: the
    JAX step's sharing is bit-identical to its two forwards
    (tests/test_train_step.py), and its NoTarget routing feeds the critic
    the mol batch, which the test hands it as the drug batch."""
    run_and_compare(port_setup(jax_f32, submodel, share_fake), jnp.float32,
                    F32_TOL, drug_is_mol=submodel == "NoTarget")


def test_fused_block_steps_match_jax(jax_f32, monkeypatch):
    """``--fused_block``: G and the critic's first-order passes in
    ``fused_mlp="block"`` mode (4 megablock forwards and 4 backwards a step
    at depth 1), the gradient-penalty pass plain."""
    from druggen_tpu_torch.ops import fused_block

    calls = []
    fwd = fused_block.fused_block_fwd
    monkeypatch.setattr(fused_block, "fused_block_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    run_and_compare(port_setup(jax_f32, g_fused="block", fused_critic="block"),
                    jnp.float32, F32_TOL)
    assert len(calls) == 4 * 3


def test_gradient_penalty_and_discriminator_loss_match_jax(jax_f32):
    """The gradient penalty and the D loss of one step, fed the JAX eps (the
    critic's gradients are compared through the step test's updates)."""
    _, _, (G, D, _, _), pstep = port_setup(jax_f32)
    x, a, dx, da = _batches(1, seed=5)[0]
    jd = JaxD(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2)
    jg = JaxG(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2)
    from druggen_tpu_torch.interop.weights import (
        torch_discriminator_to_flax,
        torch_generator_to_flax,
    )
    dvars = jax.tree_util.tree_map(jnp.asarray, torch_discriminator_to_flax(D.state_dict()))
    gvars = jax.tree_util.tree_map(jnp.asarray, torch_generator_to_flax(G.state_dict()))
    oh = lambda v, w: jax.nn.one_hot(v, w, dtype=jnp.float32)  # noqa: E731
    xj, aj, dxj, daj = oh(x, M_DIM), oh(a, B_DIM), oh(dx, M_DIM), oh(da, B_DIM)
    key = jax.random.PRNGKey(7)

    def critic(p):
        return lambda e, n: jd.apply(p, e, n)

    @jax.jit
    def losses(p):
        fake = jg.apply(gvars, aj, xj)
        gp = jax_gp(critic(p), dxj, daj, fake[2], fake[3], key)
        return fake, gp, jax_d_loss(lambda e, n: jg.apply(gvars, e, n),
                                    critic(p), daj, dxj, aj, xj, 10.0, key)

    fake, ref_gp, ref_loss = losses(dvars)
    k_node, k_edge = jax.random.split(key)
    eps = (torch.from_numpy(np.array(jax.random.uniform(k_node, (B, 1, 1)))),
           torch.from_numpy(np.array(jax.random.uniform(k_edge, (B, 1, 1, 1)))))

    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    got_gp = gradient_penalty(D, t(dxj), t(daj), t(fake[2]), t(fake[3]), *eps)
    np.testing.assert_allclose(got_gp.item(), float(ref_gp), rtol=1e-5)
    got_loss = discriminator_loss(lambda e, n: G(e, n), D, t(daj), t(dxj),
                                  t(aj), t(xj), 10.0, *eps)
    np.testing.assert_allclose(got_loss.item(), float(ref_loss), rtol=1e-5)


def test_adamw_and_guard_match_optax():
    """AdamW in optax's order with the all-finite guard, over 3 finite steps
    and one non-finite step (skipped: params, moments and count untouched,
    the counters bumped)."""
    rng = np.random.default_rng(0)
    model = torch.nn.Linear(6, 3)
    params = {"w": rng.normal(size=(3, 6)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(params["w"]))
        model.bias.copy_(torch.from_numpy(params["b"]))
    opt = AdamW(model, lr=1e-3, weight_decay=0.01)
    tx = apply_if_all_finite(optax.adamw(1e-3, b1=0.9, b2=0.999,
                                         weight_decay=0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    for i in range(4):
        g = {"w": rng.normal(size=(3, 6)).astype(np.float32),
             "b": rng.normal(size=(3,)).astype(np.float32)}
        if i == 2:
            g["b"][1] = np.nan
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        before = (opt.flat.clone(), opt.state.mu.clone(), int(opt.state.count))
        opt.step([torch.from_numpy(g["w"]), torch.from_numpy(g["b"])])
        if i == 2:
            assert torch.equal(opt.flat, before[0])
            assert torch.equal(opt.state.mu, before[1])
            assert int(opt.state.count) == before[2]
            assert int(opt.state.notfinite_count) == 1
        np.testing.assert_allclose(model.weight.detach().numpy(), jp["w"],
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(model.bias.detach().numpy(), jp["b"],
                                   atol=1e-7, rtol=1e-6)
    assert int(opt.state.count) == int(st.inner_state[0].count) == 3
    assert int(opt.state.notfinite_count) == int(st.notfinite_count) == 0
    assert int(opt.state.total_notfinite) == int(st.total_notfinite) == 1
    mu, _ = opt.moments()
    np.testing.assert_allclose(mu["weight"].numpy(),
                               np.asarray(st.inner_state[0].mu["w"]), rtol=1e-6,
                               atol=1e-8)


def test_forced_nonfinite_step_leaves_the_critic_untouched(jax_f32):
    """A NaN gradient-penalty noise makes the D loss NaN: the guard skips the
    D update (params, moments, count untouched; counters bumped) and the G
    update still commits."""
    _, _, (G, D, g_opt, d_opt), pstep = port_setup(jax_f32)
    x, a, dx, da = _batches(1, seed=3)[0]
    d_before = (d_opt.flat.clone(), d_opt.state.mu.clone(), d_opt.state.nu.clone())
    g_before = g_opt.flat.clone()
    nan = (torch.full((B, 1, 1), float("nan")), torch.full((B, 1, 1, 1), float("nan")))
    out = pstep(x, a, dx, da, eps=nan)
    assert not np.isfinite(out["d_loss"].item())
    assert torch.equal(d_opt.flat, d_before[0])
    assert torch.equal(d_opt.state.mu, d_before[1])
    assert torch.equal(d_opt.state.nu, d_before[2])
    assert int(d_opt.state.count) == 0
    assert int(d_opt.state.notfinite_count) == 1 == int(d_opt.state.total_notfinite)
    assert int(g_opt.state.count) == 1 and int(g_opt.state.total_notfinite) == 0
    assert not torch.equal(g_opt.flat, g_before)

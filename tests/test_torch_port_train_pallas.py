"""The port's train step with ``use_pallas`` (the Generator's attention
through K5/K6; their plain versions on the CPU) against the JAX package's
``make_train_step`` with a ``use_pallas`` Generator (the Pallas kernels in
the interpreter), f32.

Sizes are the smallest that reach the fused attention (dim 128, 8 heads,
N 9, batch 2: the routing rule sends a width that is not a multiple of 128
to the plain composite); one JAX compile serves the test.  Both packages
start from one JAX ``GANState`` and take two steps on the same numpy
batches with the JAX gradient-penalty noise.  The critic is built without
``use_pallas`` in both (it is differentiated twice).  The JAX Generator
runs its edge tail on XLA and the port's through K1/K2's plain versions:
the same f32 math.  Tolerances as ``test_torch_port_train_step.py`` (f32,
sums in another order): losses 1e-5, parameters 1e-6 absolute, each
model's two-step change and AdamW moments 1e-3 by relative norm.
"""

import numpy as np
import torch

import jax

from druggen_tpu.config import TrainConfig
from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.train.step import init_state
from druggen_tpu.train.step import make_optimizers as jax_make_optimizers
from druggen_tpu.train.step import make_train_step
from druggen_tpu_torch.interop.weights import gan_state_to_port, to_torch_tensors
from druggen_tpu_torch.models import Discriminator, Generator, GraphMHA
from druggen_tpu_torch.ops import fused_attention
from druggen_tpu_torch.train.optim import make_optimizers
from druggen_tpu_torch.train.step import TrainStep
from test_torch_port_train_step import F32_TOL, _rel

torch.set_num_threads(1)

B, N, M_DIM, B_DIM, DIM, HEADS, STEPS = 2, 9, 5, 4, 128, 8, 2


def _batches(seed=0):
    rng = np.random.default_rng(seed)

    def sym(r):
        return np.triu(r, 1) + np.triu(r, 1).transpose(0, 2, 1)

    return [(rng.integers(0, M_DIM, (B, N)), sym(rng.integers(0, B_DIM, (B, N, N))),
             rng.integers(0, M_DIM, (B, N)), sym(rng.integers(0, B_DIM, (B, N, N))))
            for _ in range(STEPS)]


def _gp_noise(key, step):
    """The eps draws of the JAX step (train/step.py:260-261) for the port."""
    k_node, k_edge = jax.random.split(jax.random.split(jax.random.fold_in(key, step), 5)[0])
    return (torch.from_numpy(np.array(jax.random.uniform(k_node, (B, 1, 1)))),
            torch.from_numpy(np.array(jax.random.uniform(k_edge, (B, 1, 1, 1)))))


def test_use_pallas_steps_match_jax(monkeypatch):
    kw = dict(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2)
    cfg = TrainConfig(raw_file="x.smi", drug_raw_file="y.smi", batch_size=B,
                      max_atom=N, dim=DIM, heads=HEADS, mlp_ratio=2)
    jg, jd = JaxG(use_pallas=True, **kw), JaxD(use_pallas=False, **kw)
    g_opt, d_opt = jax_make_optimizers(cfg)
    jstep = make_train_step(jg, jd, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM,
                            b_dim=B_DIM, donate=False)
    state = init_state(jg, jd, g_opt, d_opt, jax.random.PRNGKey(0), N, M_DIM, B_DIM)
    start = gan_state_to_port(jax.device_get(state))

    G = Generator(fused_mlp=True, use_pallas=True, **kw)
    D = Discriminator(**kw)
    G.load_state_dict(to_torch_tensors(start["g"]))
    D.load_state_dict(to_torch_tensors(start["d"]))
    pg_opt, pd_opt = make_optimizers(cfg, G, D)
    for opt, name in ((pg_opt, "g_opt"), (pd_opt, "d_opt")):
        st = start[name]
        opt.load_state(st["count"], to_torch_tensors(st["mu"]), to_torch_tensors(st["nu"]),
                       st["notfinite_count"], st["total_notfinite"])
    pstep = TrainStep(G, D, pg_opt, pd_opt, lambda_gp=10.0, m_dim=M_DIM, b_dim=B_DIM,
                      g_fused=True, g_pallas=True)
    assert not any(m.use_pallas for m in D.modules() if isinstance(m, GraphMHA))

    calls = []
    fwd = fused_attention.edge_attention_fwd
    monkeypatch.setattr(fused_attention, "edge_attention_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    key = jax.random.PRNGKey(42)
    loss = 0.0
    for i, (x, a, dx, da) in enumerate(_batches()):
        state, m, _ = jstep(state, key, x, a, dx, da)
        out = pstep(x, a, dx, da, eps=_gp_noise(key, i))
        for name in ("d_loss", "g_loss"):
            ref = float(m[name])
            loss = max(loss, abs(out[name].item() - ref) / (1 + abs(ref)))
    # one Generator forward a step (kept for the G update, share_fake)
    assert len(calls) == STEPS
    assert loss <= F32_TOL["loss"], loss

    ref = gan_state_to_port(jax.device_get(state))

    def flat(tree, keys):
        return np.concatenate([np.asarray(tree[k], np.float32).ravel() for k in keys])

    for model, opt, name in ((G, pg_opt, "g"), (D, pd_opt, "d")):
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        mu, nu = ({k: v.numpy() for k, v in t.items()} for t in opt.moments())
        rst = ref[f"{name}_opt"]
        before = flat(start[name], sd)
        now, want = flat(sd, sd), flat(ref[name], sd)
        assert np.abs(now - want).max() <= F32_TOL["param"], name
        assert _rel(now - before, want - before) <= F32_TOL["update"], name
        assert _rel(flat(mu, sd), flat(rst["mu"], sd)) <= F32_TOL["moment"], name
        assert _rel(flat(nu, sd), flat(rst["nu"], sd)) <= F32_TOL["moment"], name
        assert int(opt.state.count) == int(rst["count"]) == STEPS

"""``--features`` in the port: one dense-node training step against JAX
``make_train_step(node_mode="dense")``, f32 on the CPU.

The node inputs are float blocks ``[B, N, m_dim + 54]`` (one-hot atom types
and the 54 extra features, ``data/dataset.py:88-106``) in place of labels,
for the Generator and for the critic's real side.  Both packages take one
step from one state on the same numpy blocks with the JAX penalty noise.
The state is the port's own initialisation carried into a JAX
``GANState`` (its structure from ``jax.eval_shape`` of ``init_state``),
which spares the eager JAX initialisation; the JAX step's compile is this
file's one.  Limits of
``test_torch_port_train_step.py`` (f32, sums in another order): losses rtol
1e-5, parameters atol 1e-6, each model's change and AdamW moments by
relative norm error 1e-3.
"""

import numpy as np
import torch

import jax
from flax import serialization

from druggen_tpu.config import TrainConfig as JaxTrainConfig
from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.train.step import init_state
from druggen_tpu.train.step import make_optimizers as jax_make_optimizers
from druggen_tpu.train.step import make_train_step
from druggen_tpu_torch.config import TrainConfig
from druggen_tpu_torch.interop.weights import gan_state_to_port, port_to_gan_state
from druggen_tpu_torch.models import Discriminator, Generator
from druggen_tpu_torch.train.optim import make_optimizers
from druggen_tpu_torch.train.step import TrainStep
from test_torch_port_train_step import _jax_gp_noise

torch.set_num_threads(1)

B, N, B_DIM, DIM, HEADS = 4, 7, 4, 16, 4
M_DIM = 5 + 54


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_dense_node_step_matches_jax():
    kw = dict(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0, dim=DIM,
              depth=1, heads=HEADS, mlp_ratio=2)
    jg, jd = JaxG(**kw), JaxD(**kw)
    g_opt, d_opt = jax_make_optimizers(JaxTrainConfig(raw_file="x", drug_raw_file="y"))
    step = make_train_step(jg, jd, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM,
                           b_dim=B_DIM, node_mode="dense", donate=False)

    G = Generator("relu", N, B_DIM, M_DIM, 0.0, DIM, 1, HEADS, 2)
    D = Discriminator("relu", N, B_DIM, M_DIM, 0.0, DIM, 1, HEADS, 2)
    cfg = TrainConfig(raw_file="x", drug_raw_file="y", batch_size=B, max_atom=N, dim=DIM,
                      heads=HEADS, mlp_ratio=2)
    pg_opt, pd_opt = make_optimizers(cfg, G, D)
    pstep = TrainStep(G, D, pg_opt, pd_opt, lambda_gp=10.0, m_dim=M_DIM, b_dim=B_DIM,
                      node_mode="dense")

    def numpy(sd):
        return {k: v.detach().numpy().copy() for k, v in sd.items()}

    def opt_state(o):
        mu, nu = o.moments()
        return {"count": o.state.count.numpy(), "mu": numpy(mu), "nu": numpy(nu),
                "notfinite_count": o.state.notfinite_count.numpy(),
                "total_notfinite": o.state.total_notfinite.numpy()}
    start = {"g": numpy(G.state_dict()), "d": numpy(D.state_dict()),
             "g_opt": opt_state(pg_opt), "d_opt": opt_state(pd_opt), "step": 0}
    template = jax.eval_shape(lambda: init_state(jg, jd, g_opt, d_opt, jax.random.PRNGKey(0),
                                                 N, M_DIM, B_DIM))
    state = serialization.from_state_dict(template, port_to_gan_state(start))

    rng = np.random.default_rng(0)

    def sym(r):
        return (np.triu(r, 1) + np.triu(r, 1).transpose(0, 2, 1)).astype(np.int8)
    # dense blocks: a one-hot prefix and 0/1 features, as the dataset gives
    x, dx = (np.concatenate([np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, N))],
                             rng.integers(0, 2, (B, N, 54)).astype(np.float32)], -1)
             for _ in range(2))
    a, da = sym(rng.integers(0, B_DIM, (B, N, N))), sym(rng.integers(0, B_DIM, (B, N, N)))
    key = jax.random.PRNGKey(42)
    state, metrics, (node_logits, _) = step(state, key, x, a, dx, da)
    out = pstep(x, a, dx, da, eps=_jax_gp_noise(key, 0, np.float32))

    for name in ("d_loss", "g_loss"):
        np.testing.assert_allclose(out[name].item(), float(metrics[name]), rtol=1e-5)
    assert out["node_logits"].shape == (B, N, M_DIM)
    np.testing.assert_allclose(out["node_logits"].numpy(), np.asarray(node_logits),
                               atol=1e-5, rtol=1e-5)
    ref = gan_state_to_port(jax.device_get(state))
    for model, opt, name in ((G, pg_opt, "g"), (D, pd_opt, "d")):
        sd = {k: v.numpy() for k, v in model.state_dict().items()}

        def flat(tree):
            return np.concatenate([np.asarray(tree[k], np.float32).ravel() for k in sd])
        assert np.abs(flat(sd) - flat(ref[name])).max() <= 1e-6, name
        before = flat(start[name])
        assert _rel(flat(sd) - before, flat(ref[name]) - before) <= 1e-3, name
        mu, nu = ({k: v.numpy() for k, v in m.items()} for m in opt.moments())
        rst = ref[f"{name}_opt"]
        assert _rel(flat(mu), flat(rst["mu"])) <= 1e-3, name
        assert _rel(flat(nu), flat(rst["nu"])) <= 1e-3, name
        assert int(opt.state.count) == int(rst["count"]) == 1

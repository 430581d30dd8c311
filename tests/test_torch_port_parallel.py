"""The port's parallel modes on the CPU: four gloo ranks, one group for the
file (``parallel_worker.every_check``, ~10 s), held against the JAX package
and against the port's single-device step.

- Meshes are laid out host-major, row-major; each rank takes its rows of
  its host's batch.
- ``edge_partitioned_attention`` at 2x2 and 1x4 equals JAX's on the 8
  virtual devices (values and the gradients of its sum-of-squares loss).
- The inflation witness: the first and the second gradients of replicated
  functions through ``gather_node_rows`` and ``distributed_edge_transpose``
  at k = 2 and 4 equal the unsharded ones; the same first gradient through a
  gather whose backward sums comes out k times too large.
- Three SGD steps of the data-parallel step (4 ranks; also with the
  megablock, the reverse-over-forward penalty and the split step), the
  edge-partitioned step (2x2 and 1x4 at N 8, and N 9 padded to 12 at 1x4)
  and the tensor-parallel step (2x2; with the megablock; 1x4 with the fused
  attention) equal the single-device ``TrainStep`` from the
  same state on the same data and noise: losses rtol 1e-5 / atol 1e-6,
  logits and every parameter rtol 1e-4 / atol 1e-6
  (``tests/test_edge_partition_full.py:86-105``'s limits for JAX).
- Each of those on both transports: the native collectives, and the
  broadcast/all_reduce route that gloo takes for CUDA tensors.
- ``pad_vertices`` and the tensor-parallel rules equal JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from druggen_tpu.data import dataset as jax_dataset
from druggen_tpu.data.corpus import DRUGLIKE_SMILES
from druggen_tpu.chem import vocab as jax_vocab
from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.parallel import edge_partition as jax_ep
from druggen_tpu.parallel import tensor_parallel as jax_tp
from druggen_tpu.train.step import GANState, init_state
from druggen_tpu_torch.interop.weights import (
    flax_discriminator_to_torch,
    flax_generator_to_torch,
    torch_discriminator_to_flax,
    torch_generator_to_flax,
)
from druggen_tpu_torch.chem import vocab
from druggen_tpu_torch.data import dataset
from druggen_tpu_torch.parallel import mesh as pmesh
from druggen_tpu_torch.parallel import tensor_parallel as tp
from druggen_tpu_torch.models import Discriminator, Generator

import parallel_worker as worker

torch.set_num_threads(1)

TRANSPORTS = ("auto", "broadcast")
STEP_CASES = ("dp", "dp fused_block fwdrev split", "edge 2x2", "edge 1x4",
              "edge 1x4 N 9 -> 12", "tp 2x2", "tp 2x2 fused_block", "tp 1x4 use_pallas")


JAX_KEY, JAX_B = 3, 4


def _jax_eps():
    """The JAX sharded step's penalty noise at step 0 (its key split,
    ``edge_partition.py:152-158``), for the global batch."""
    k_gp = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(JAX_KEY), 0), 5)[0]
    k_node, k_edge = jax.random.split(k_gp)
    return (np.asarray(jax.random.uniform(k_node, (JAX_B, 1, 1), jnp.float32)),
            np.asarray(jax.random.uniform(k_edge, (JAX_B, 1, 1, 1), jnp.float32)))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The results of every check on each of the 4 ranks."""
    return worker.spawn(4, "every_check", tmp_path_factory.mktemp("group"), _jax_eps())


def _expected_layout(rank, shape, hosts):
    names, sizes = list(shape), [shape[n] for n in shape]
    coords = dict(zip(names, np.unravel_index(rank, sizes)))
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    lines = {}
    for d, name in enumerate(names):
        index = [coords[n] if i != d else slice(None) for i, n in enumerate(names)]
        lines[name] = tuple(int(r) for r in grid[tuple(index)])
    dp = shape["data"] // hosts
    local = coords["data"] % dp
    rows = list(range(local * 8 // dp, (local + 1) * 8 // dp))
    return ({k: int(v) for k, v in coords.items()}, (rank // (4 // hosts), hosts),
            lines, [4 * r for r in rows])


@pytest.mark.parametrize("which,hosts", [("layout", 1), ("host_layout", 2)])
def test_meshes_are_host_major(group, which, hosts):
    for rank, res in enumerate(group):
        for key, got in res[which].items():
            shape = dict(key)
            if rank >= int(np.prod(list(shape.values()))):
                assert got is None
                continue
            coords, host, lines, rows = _expected_layout(rank, shape, hosts)
            assert got["coords"] == coords and got["hosts"] == host
            assert got["lines"] == lines and got["rows"] == rows, (key, rank, got)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("dp,k", [(2, 2), (1, 4)])
def test_edge_partitioned_attention_matches_jax(group, dp, k, transport):
    q, kk, v, e = (jnp.asarray(t.numpy()) for t in worker._global_qkve())
    dk = worker.DIM // worker.HEADS
    mesh = jax_ep.make_edge_mesh(dp, k, devices=jax.devices()[:4])
    blocks = jax_ep.shard_inputs(mesh, q, kk, v, e)
    ep_j, na_j = jax.jit(lambda *a: jax_ep.edge_partitioned_attention(mesh, *a, dk))(*blocks)
    loss_j, grads_j = jax_ep.make_sharded_loss_grad(mesh, dk)(*blocks)
    for res in group:
        got = res[("attention", transport)][(dp, k)]
        np.testing.assert_allclose(got["edge_pre"], np.asarray(ep_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["node_agg"], np.asarray(na_j), rtol=1e-5, atol=1e-5)
        # and the port's own unsharded reference
        np.testing.assert_allclose(got["edge_pre"], got["unsharded"][0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["node_agg"], got["unsharded"][1], rtol=1e-5, atol=1e-5)
        assert got["loss"] == pytest.approx(float(loss_j), rel=1e-5)
        for g, gj in zip(got["grads"], grads_j):
            np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("k", [2, 4])
def test_inflation_witness(group, k, transport):
    for res in group:
        got = res[("witness", transport)]
        for name in ("f", "h"):
            first, second = got[(k, name)]
            assert first < 1e-6 and second < 1e-6, (name, first, second)
        # a gather whose backward sums the cotangents: k-fold
        assert got[(k, "plain")] == pytest.approx(k, rel=1e-6)


@pytest.mark.parametrize("case,transport", [(c, "auto") for c in STEP_CASES]
                         + [(c, "broadcast") for c in worker.BROADCAST_CASES])
def test_sharded_steps_match_single_device(group, case, transport):
    res = group[0][("steps", transport)][case]
    assert len(res["losses"]) == 6 and len(res["logits"]) == 6
    for key, got, want in res["losses"]:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
    for key, got, want in res["logits"]:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=key)
    for name, got, want in res["params"]:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("to", [25, 28])
@pytest.mark.parametrize("features", [False, True])
def test_pad_vertices_matches_jax(to, features):
    jv = jax_vocab.build_vocab(DRUGLIKE_SMILES[:12], max_atom=25)
    pv = vocab.build_vocab(DRUGLIKE_SMILES[:12], max_atom=25)
    jd = jax_dataset.featurize_smiles(DRUGLIKE_SMILES[:12], jv, 25, use_native=False,
                                      features=features)
    pd = dataset.featurize_smiles(DRUGLIKE_SMILES[:12], pv, 25, use_native=False,
                                  features=features)
    jp, pp = jax_dataset.pad_vertices(jd, to), dataset.pad_vertices(pd, to)
    for name in ("x", "a", "f"):
        a, b = getattr(jp, name), getattr(pp, name)
        assert (a is None) == (b is None) == (name == "f" and not features)
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert pp.x.shape[1] == to and pp.smiles == jp.smiles
    with pytest.raises(ValueError, match="cannot pad"):
        dataset.pad_vertices(pd, 24)


def _port_name(path: str) -> str:
    """A flax parameter path of the Generator/Discriminator -> the port's
    state-dict name."""
    parts = path.split("/")
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[parts[-1]]
    mods = parts[:-1]
    if mods[0] == "trunk":
        mods = mods[1:]
    top = {"node_fc1": "node_layers.0", "node_fc2": "node_layers.2",
           "edge_fc1": "edge_layers.0", "edge_fc2": "edge_layers.2",
           "mlp_fc1": "node_mlp.0", "mlp_fc2": "node_mlp.2", "mlp_fc3": "node_mlp.4",
           "mlp_fc4": "node_mlp.6"}
    if mods[0] in top:
        return f"{top[mods[0]]}.{leaf}"
    if mods[0] == "encoder":
        i = int(mods[1].split("_")[1])
        return ".".join(["TransformerEncoder.Encoder_Blocks", str(i), *mods[2:], leaf])
    return ".".join([*mods, leaf])


@pytest.mark.parametrize("tp_size", [2, 3])
@pytest.mark.parametrize("which", ["G", "D"])
def test_tensor_parallel_rules_match_jax(which, tp_size):
    """Each parameter's split dimension equals the one JAX's
    ``tp_param_shardings`` gives the same parameter (its kernel [in, out]
    is the torch weight transposed); 3 divides no split dimension at dim
    16, so everything stays whole, as in JAX."""
    kw = dict(act="relu", vertexes=8, edges=4, nodes=5, dropout=0.0, dim=16, depth=2,
              heads=4, mlp_ratio=2)
    jax_model, port = (JaxG, Generator) if which == "G" else (JaxD, Discriminator)
    params = jax.eval_shape(lambda: jax_model(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 8, 5))))
    mesh = jax_tp.make_dp_tp_mesh(1, tp_size, devices=jax.devices()[:tp_size])
    flat = jax.tree_util.tree_flatten_with_path(jax_tp.tp_param_shardings(mesh, params))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = {}
    for path_tuple, sharding in flat:
        path = "/".join(str(getattr(p, "key", p)) for p in path_tuple[1:])
        dims = [i for i, s in enumerate(tuple(sharding.spec)) if s == "model"]
        ndim = len(shapes[path_tuple].shape)
        # flax kernel [in, out] -> torch weight [out, in]
        want[_port_name(path)] = (None if not dims
                                  else 1 - dims[0] if ndim == 2 else 0)
    model = port(**kw)
    got = tp.tp_param_shardings(model, tp_size)
    # a layer whose weight stays whole keeps its bias whole too
    for name, d in want.items():
        if name.endswith(".bias") and want[name[:-4] + "weight"] is None:
            want[name] = None
    assert got == want
    assert any(v is not None for v in got.values()) == (tp_size == 2)


def test_one_rank_world():
    """Without a group: one rank, meshes larger than it raise (JAX
    ``mesh.py:45-46``), and one-rank collectives are identities."""
    assert pmesh.world() == (0, 1)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pmesh.make_mesh(2)
    mesh = pmesh.make_mesh(0)
    assert mesh.shape == {"data": 1} and mesh.member
    x = torch.arange(6.0).reshape(1, 2, 3)
    axis = mesh.axis("data")
    assert pmesh.all_gather(x, axis, 1) is x and pmesh.all_reduce(x, axis) is x
    assert torch.equal(pmesh.edge_transpose(x[..., None], axis), x[..., None].transpose(1, 2))


def test_sharded_step_matches_jax(group):
    """One step of JAX's ``make_sharded_train_step`` (optax SGD, mesh 2x2 on
    4 of the virtual devices, B 4, N 8, dim 16, depth 1) from the port's
    initial weights equals the port's sharded step with the same noise:
    losses rtol 1e-5 / atol 1e-6, logits and parameters rtol 1e-4 /
    atol 1e-6.  The JAX state is the port's weights in the structure of
    ``jax.eval_shape(init_state)`` (no eager JAX initialisation)."""
    kw = dict(act="relu", vertexes=8, edges=worker.B_DIM, nodes=worker.M_DIM,
              dropout=0.0, dim=worker.DIM, depth=1, heads=worker.HEADS, mlp_ratio=2)
    jg, jd = JaxG(**kw), JaxD(**kw)
    opt = optax.sgd(1e-2)
    template = jax.eval_shape(lambda: init_state(jg, jd, opt, opt, jax.random.PRNGKey(0),
                                                 8, worker.M_DIM, worker.B_DIM))
    G, D = worker._models(8)

    def numpy(sd):
        return {k: v.detach().numpy() for k, v in sd.items()}
    state = GANState(
        serialization.from_state_dict(template.g_params,
                                      torch_generator_to_flax(numpy(G.state_dict()))),
        serialization.from_state_dict(template.d_params,
                                      torch_discriminator_to_flax(numpy(D.state_dict()))),
        jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype), template.g_opt_state),
        jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype), template.d_opt_state),
        jnp.zeros((), jnp.int32))
    mesh = jax_ep.make_edge_mesh(2, 2, devices=jax.devices()[:4])
    step = jax_ep.make_sharded_train_step(jg, jd, opt, opt, mesh, lambda_gp=10.0,
                                          m_dim=worker.M_DIM, b_dim=worker.B_DIM,
                                          donate=False)
    x, a, dx, da = worker._batches(8, b=JAX_B, steps=1)[0]
    new, metrics, (nl, el) = step(state, jax.random.PRNGKey(JAX_KEY),
                                  *jax_ep.shard_train_inputs(mesh, x, a, dx, da))
    ours = group[0]["jax_step"]
    for rank, res in enumerate(group):
        losses = res["jax_step"] if rank else ours["losses"]
        for got, key in zip(losses, ("d_loss", "g_loss")):
            np.testing.assert_allclose(got, float(metrics[key]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["logits"][0], np.asarray(nl), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours["logits"][1], np.asarray(el), rtol=1e-4, atol=1e-6)
    new = jax.device_get(new)
    for key, to_port in (("g", flax_generator_to_torch), ("d", flax_discriminator_to_torch)):
        want = to_port(getattr(new, f"{key}_params"))
        assert set(want) == set(ours[key])
        for name, w in want.items():
            np.testing.assert_allclose(ours[key][name], w, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_dryrun_multichip_runs_its_four_phases(capfd):
    """``entry.dryrun_multichip(8)`` starts 8 gloo ranks on the CPU and runs
    the data-parallel, edge-partitioned (2x4), tensor-parallel (2x4) and
    two-host edge-partitioned steps (the last held to the one-host one)."""
    from druggen_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, timeout=400)
    out = capfd.readouterr().out
    for label in ("ok (", "edge-partitioned ok", "tensor-parallel ok",
                  "multihost x mesh_node (2 simulated hosts) ok"):
        assert f"dryrun_multichip(8): {label}" in out, out

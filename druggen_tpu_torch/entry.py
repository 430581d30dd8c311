"""Entry points of the port (twins of ``__graft_entry__.py``'s ``entry``,
:15-42, and ``dryrun_multichip``, :45-216).

:func:`entry` returns a forward step on the flagship model, the DrugGEN
Generator at its default config (dim 128, depth 1, 8 heads, mlp_ratio 3,
the ChEMBL vocabulary, N 45), with example arguments: its parameters and a
batch of 8 random one-hot graphs, on the device (``cuda`` unless the
caller asks for the CPU).  ``fn(params, z_e, z_n)`` -> ``(node_logits,
edge_logits)``, as the JAX function returns them; the parameters are the
Generator's state_dict, applied with ``torch.func.functional_call``.

:func:`dryrun_multichip` runs one step of each parallel mode at tiny
shapes: ``python -m druggen_tpu_torch.entry 8`` starts 8 gloo ranks on the
CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args) for a single-device Generator forward."""
    from druggen_tpu_torch.chem.vocab import CHEMBL_VOCAB
    from druggen_tpu_torch.infer.engine import resolve_device
    from druggen_tpu_torch.models import Generator

    device = resolve_device(device)
    vocab = CHEMBL_VOCAB
    vertexes, m_dim, b_dim = 45, vocab.m_dim, vocab.b_dim
    model = Generator(act="relu", vertexes=vertexes, edges=b_dim,
                      nodes=m_dim, dropout=0.0, dim=128, depth=1, heads=8,
                      mlp_ratio=3).to(device).eval()
    gen = torch.Generator().manual_seed(0)
    batch = 8
    z_e = F.one_hot(torch.randint(0, b_dim, (batch, vertexes, vertexes),
                                  generator=gen), b_dim).float().to(device)
    z_n = F.one_hot(torch.randint(0, m_dim, (batch, vertexes), generator=gen),
                    m_dim).float().to(device)
    params = dict(model.state_dict())

    def forward(params, z_e, z_n):
        _, _, node_logits, edge_logits = torch.func.functional_call(
            model, params, (z_e, z_n))
        return node_logits, edge_logits

    return forward, (params, z_e, z_n)


def _dryrun_models(vertexes: int, m_dim: int, b_dim: int, dim: int, heads: int):
    from druggen_tpu_torch.models import Discriminator, Generator

    kw = dict(act="relu", vertexes=vertexes, edges=b_dim, nodes=m_dim, dropout=0.0,
              dim=dim, depth=1, heads=heads, mlp_ratio=2)
    return (Generator(generator=torch.Generator().manual_seed(0), **kw),
            Discriminator(generator=torch.Generator().manual_seed(1), **kw))


def _dryrun(n_devices: int, device) -> None:
    """The four phases of :func:`dryrun_multichip` on this rank."""
    import os

    import numpy as np

    from druggen_tpu_torch.config import TrainConfig
    from druggen_tpu_torch.parallel import edge_partition as ep
    from druggen_tpu_torch.parallel import mesh as pmesh
    from druggen_tpu_torch.parallel import tensor_parallel as tp
    from druggen_tpu_torch.train.optim import make_optimizers
    from druggen_tpu_torch.train.step import TrainStep

    device = torch.device(device)
    rank, _ = pmesh.world()
    vertexes, m_dim, b_dim, dim, heads = 9, 5, 4, 16, 4
    batch = 2 * n_devices
    cfg = TrainConfig(raw_file="x", drug_raw_file="y", batch_size=batch,
                      max_atom=vertexes, dim=dim, heads=heads, mlp_ratio=2)

    def report(label, mesh, out):
        d_loss, g_loss = (float(pmesh.all_reduce(out[k].float().reshape(1), mesh.whole))
                          / mesh.size for k in ("d_loss", "g_loss"))
        if not (np.isfinite(d_loss) and np.isfinite(g_loss)):
            raise AssertionError(f"dryrun_multichip({n_devices}): {label} losses "
                                 f"{d_loss}, {g_loss}")
        if rank == 0:
            print(f"dryrun_multichip({n_devices}): {label}ok (d_loss={d_loss:+.4f}, "
                  f"g_loss={g_loss:+.4f}, mesh={mesh.shape})", flush=True)
        return d_loss, g_loss

    def replicated_step(mesh, G, D):
        g_opt, d_opt = make_optimizers(cfg, G.to(device), D.to(device))
        data = mesh.axis("data")
        for o in (g_opt, d_opt):
            o.grad_hook = pmesh.gradient_hook(data, divide=data.size)
        step = TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=m_dim, b_dim=b_dim,
                         generator=torch.Generator(device).manual_seed(1),
                         noise_rows=(data.index, data.size))
        return step, g_opt

    rng = np.random.default_rng(0)
    x = rng.integers(0, m_dim, (batch, vertexes)).astype(np.int8)
    a0 = np.triu(rng.integers(0, b_dim, (batch, vertexes, vertexes)), 1)
    a = (a0 + a0.transpose(0, 2, 1)).astype(np.int8)
    dx = rng.integers(0, m_dim, (batch, vertexes)).astype(np.int8)
    da0 = np.triu(rng.integers(0, b_dim, (batch, vertexes, vertexes)), 1)
    da = (da0 + da0.transpose(0, 2, 1)).astype(np.int8)

    # ---- phase 1: one data-parallel step
    mesh = pmesh.make_mesh(n_devices)
    if mesh.member:
        step, g_opt = replicated_step(mesh, *_dryrun_models(vertexes, m_dim, b_dim,
                                                            dim, heads))
        report("", mesh, step(*pmesh.shard_batch(mesh, x, a, dx, da)))
        if int(g_opt.state.count) != 1:
            raise AssertionError("the data-parallel step did not update")

    # ---- phase 2: the edge-partitioned step on ('data', 'node')
    node_k = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    if node_k == 1:
        return
    dp = n_devices // node_k
    vert2, b2 = 8, 2 * dp
    x2 = rng.integers(0, m_dim, (b2, vert2)).astype(np.int8)
    a2 = rng.integers(0, b_dim, (b2, vert2, vert2)).astype(np.int8)
    a2 = np.minimum(a2, a2.transpose(0, 2, 1))

    def edge_step(mesh, *arrays):
        G, D = (m.to(device) for m in _dryrun_models(vert2, m_dim, b_dim, dim, heads))
        g_opt, d_opt = make_optimizers(cfg, G, D)
        step = ep.ShardedTrainStep(G, D, g_opt, d_opt, mesh, lambda_gp=10.0,
                                   m_dim=m_dim, b_dim=b_dim,
                                   generator=torch.Generator(device).manual_seed(1))
        return step(*ep.shard_train_inputs(mesh, *arrays))

    emesh = ep.make_edge_mesh(dp, node_k)
    if emesh.member:
        losses2 = report("edge-partitioned ", emesh, edge_step(emesh, x2, a2, x2, a2))

    # ---- phase 3: the tensor-parallel (column/row) step on ('data', 'model')
    tmesh = tp.make_dp_tp_mesh(dp, node_k)
    if tmesh.member:
        G, D = _dryrun_models(vertexes, m_dim, b_dim, dim, heads)
        tp.shard_gan_state_tp(tmesh, G, D)
        step, _ = replicated_step(tmesh, G, D)
        report("tensor-parallel ", tmesh, step(*pmesh.shard_batch(tmesh, x, a, dx, da)))

    # ---- phase 4: two simulated hosts x mesh_node: each host feeds its half
    # of the batch (host-major 'data' rows), the step equals phase 2's
    if dp % 2:
        return
    os.environ["LOCAL_WORLD_SIZE"] = str(n_devices // 2)
    try:
        hmesh = ep.make_edge_mesh(dp, node_k)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    if hmesh.member:
        half = b2 // 2
        mine = slice(0, half) if hmesh.host_id == 0 else slice(half, b2)
        losses4 = report(f"multihost x mesh_node ({hmesh.num_hosts} simulated hosts) ",
                         hmesh, edge_step(hmesh, x2[mine], a2[mine], x2[mine], a2[mine]))
        if not np.allclose(losses4, losses2, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"host-fed step {losses4} != phase 2's {losses2}")


def _dryrun_rank(n_devices: int) -> None:
    torch.set_num_threads(1)
    _dryrun(n_devices, "cpu")


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout: float = 600.0) -> None:
    """One step of each parallel mode on ``n_devices`` ranks at tiny shapes
    (twin of ``__graft_entry__.py:45-216``): data-parallel; edge-partitioned
    with a 'node' axis of 4 or 2 and 8 vertices; tensor-parallel; and two
    simulated hosts feeding the edge-partitioned step their halves of the
    batch (its losses held to the one-host step's).  Inside a process group
    the caller started, it runs there on ``device`` (the first
    ``n_devices`` ranks); without one it starts ``n_devices`` gloo ranks on
    the CPU, joined within ``timeout`` seconds."""
    import torch.distributed as dist

    from druggen_tpu_torch.parallel.mesh import spawn

    if dist.is_available() and dist.is_initialized():
        _dryrun(n_devices, device)
        return
    spawn(_dryrun_rank, n_devices, n_devices, timeout=timeout)


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

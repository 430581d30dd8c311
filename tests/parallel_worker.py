"""Process groups of the port's parallel tests, on the CPU under gloo.

:func:`spawn` starts ``world`` ranks (``parallel.mesh.spawn``: a
``file://`` rendezvous in a fresh temporary directory, so that test workers
never share a port), runs one job of :data:`JOBS` on each and returns the
ranks' results; a rank that fails or a group that outlives ``timeout``
fails the test.  The jobs import torch and the port only (no JAX): the tests
hold their results against JAX in the parent.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from druggen_tpu_torch.models import Discriminator, Generator
from druggen_tpu_torch.parallel import edge_partition as ep
from druggen_tpu_torch.parallel import mesh as pmesh
from druggen_tpu_torch.parallel import tensor_parallel as tpm
from druggen_tpu_torch.train.optim import AdamW
from druggen_tpu_torch.train.step import TrainStep

M_DIM, B_DIM, DIM, HEADS = 5, 4, 16, 4


def _job(job, out, env, args):
    os.environ.update(env)
    torch.set_num_threads(1)
    result = JOBS[job](*args)
    with open(os.path.join(out, f"rank{pmesh.world()[0]}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(world: int, job: str, tmp_path, *args, env=None, timeout: float = 400.0):
    """Run ``JOBS[job](*args)`` on ``world`` gloo ranks
    (:func:`druggen_tpu_torch.parallel.mesh.spawn`); their results in rank
    order."""
    out = os.path.join(str(tmp_path), f"{job}_out")
    os.makedirs(out, exist_ok=True)
    pmesh.spawn(_job, world, job, out, env or {}, args, timeout=timeout)
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

LAYOUTS = ({"data": 2, "node": 2}, {"data": 1, "node": 4}, {"data": 4},
           {"data": 2, "model": 2}, {"data": 2})


def layout(shapes=LAYOUTS):
    """Coordinates, axis lines and the rows a rank takes."""
    out = {}
    for shape in shapes:
        mesh = pmesh.Mesh(shape)
        key = tuple(shape.items())
        if not mesh.member:
            out[key] = None
            continue
        batch = np.arange(8 * 4).reshape(8, 4)
        out[key] = {"coords": mesh.coords, "hosts": (mesh.host_id, mesh.num_hosts),
                    "lines": {n: a.ranks for n, a in mesh.axes.items()},
                    "rows": pmesh.shard_batch(mesh, batch)[0][:, 0].tolist()}
    return out


def _global_qkve(seed=0, b=8, n=8, d=16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, n, d), (b, n, d), (b, n, d), (b, n, n, d)))


def attention(transport: str):
    """The edge-partitioned attention and its gradients at 2x2 and 1x4, whole
    on every rank."""
    pmesh.TRANSPORT = transport
    out = {}
    q, k, v, e = _global_qkve()
    for dp, k_node in ((2, 2), (1, 4)):
        mesh = ep.make_edge_mesh(dp, k_node)
        blocks = ep.shard_inputs(mesh, q, k, v, e)
        edge_pre, node_agg = ep.edge_partitioned_attention(mesh, *blocks, DIM // HEADS)
        loss, grads = ep.make_sharded_loss_grad(mesh, DIM // HEADS)(*blocks)
        specs = (ep.NODE_ROWS,) * 3 + (ep.EDGE_ROWS,)
        out[(dp, k_node)] = {
            "unsharded": [t.numpy() for t in ep.reference_unsharded(
                q, k, v, e, DIM // HEADS)],
            "edge_pre": pmesh.unshard(mesh, edge_pre.detach(), ep.EDGE_ROWS).numpy(),
            "node_agg": pmesh.unshard(mesh, node_agg.detach(), ep.NODE_ROWS).numpy(),
            "loss": float(loss),
            "grads": [pmesh.unshard(mesh, g, s).numpy() for g, s in zip(grads, specs)]}
    return out


def _witness_fns(node, data):
    """Two replicated functions of node-sharded blocks, through the gather
    and the distributed transpose: ``f(x)`` of ``x [b, n, D]`` and ``h(e)``
    of ``e [b, n, N, D]``; with ``node`` None, their unsharded forms."""
    from druggen_tpu_torch.models.layers import distributed_edge_transpose as dt
    from druggen_tpu_torch.models.layers import gather_node_rows, psum

    def total(t):
        return t if node is None else psum(t, data)

    def f(x):
        full = x if node is None else gather_node_rows(x, node)
        return total((torch.tanh(full) ** 3).sum() + (full.sum(1) ** 2).sum())

    def h(e):
        sym = (e + (e.transpose(1, 2) if node is None else dt(e, node))) / 2
        s = torch.sin(sym).sum(2)                     # [b, n, D], varying
        full = s if node is None else gather_node_rows(s, node)
        return total((full ** 2).sum() * 0.5 + (full.sum(1) ** 3).sum())
    return f, h


def _first_second(fn, x):
    x = x.detach().requires_grad_()
    g1, = torch.autograd.grad(fn(x), x, create_graph=True)
    g2, = torch.autograd.grad((g1 * g1 * torch.cos(x)).sum(), x)
    return g1.detach(), g2


def witness(transport: str):
    """First and second gradients through gather_node_rows and
    distributed_edge_transpose at k = 2 and 4, next to the unsharded ones;
    and the same first gradient through a gather whose backward sums (the
    plain gather's rule), which a replicated value inflates k-fold."""
    from druggen_tpu_torch.models.layers import gather_node_rows, pvary

    pmesh.TRANSPORT = transport
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 8, 6)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(4, 8, 8, 6)).astype(np.float32))
    f0, h0 = _witness_fns(None, None)
    want = {"f": _first_second(f0, x), "h": _first_second(h0, e)}
    out = {}
    for k in (2, 4):
        mesh = ep.make_edge_mesh(4 // k, k)
        node, data = mesh.axis("node"), mesh.axis("data")
        f, h = _witness_fns(node, data)
        for name, fn, t, spec in (("f", f, x, ep.NODE_ROWS), ("h", h, e, ep.EDGE_ROWS)):
            got = _first_second(fn, pmesh.shard(mesh, t, spec))
            wanted = [pmesh.shard(mesh, w, spec) for w in want[name]]
            out[(k, name)] = [float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(got, wanted)]
        # the plain gather's rule on a replicated value
        xl = pmesh.shard(mesh, x, ep.NODE_ROWS).detach().requires_grad_()
        full = pvary(gather_node_rows(xl, node), node)
        g, = torch.autograd.grad((torch.tanh(full) ** 3).sum(), xl)
        ref = pmesh.shard(mesh, torch.autograd.grad(
            (torch.tanh(x.requires_grad_()) ** 3).sum(), x)[0], ep.NODE_ROWS)
        out[(k, "plain")] = float((g / ref).median())
    return out


class SGD(AdamW):
    """Plain SGD on AdamW's flat buffer (the trajectory tests' optimizer:
    an update proportional to the gradient keeps sums in another order
    from flipping Adam's first, sign-like update)."""

    def step(self, grads) -> None:
        g = self.flat_grads(grads)
        if self.grad_hook is not None:
            g = self.grad_hook(g)
        with torch.no_grad():
            self.flat.sub_(self.lr * g)


def _models(n, depth=1, seed=0):
    kw = dict(act="relu", vertexes=n, edges=B_DIM, nodes=M_DIM, dropout=0.0, dim=DIM,
              depth=depth, heads=HEADS, mlp_ratio=2)
    return (Generator(generator=torch.Generator().manual_seed(seed), **kw),
            Discriminator(generator=torch.Generator().manual_seed(seed + 1), **kw))


def _batches(n, b=8, steps=3, n_pad=None):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        pair = []
        for _ in range(2):
            x = rng.integers(0, M_DIM, (b, n)).astype(np.int8)
            a = np.triu(rng.integers(0, B_DIM, (b, n, n)), 1)
            a = (a + a.transpose(0, 2, 1)).astype(np.int8)
            if n_pad:
                x = np.pad(x, ((0, 0), (0, n_pad - n)))
                a = np.pad(a, ((0, 0), (0, n_pad - n), (0, n_pad - n)))
            pair += [x, a]
        out.append(pair)
    return out


def _single(n, batches, depth, options, lr=1e-2):
    G, D = _models(n, depth)
    g_opt, d_opt = SGD(G, lr), SGD(D, lr)
    gen = torch.Generator()
    step = TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM, b_dim=B_DIM,
                     generator=gen, **options)
    outs = []
    for i, (x, a, dx, da) in enumerate(batches):
        gen.manual_seed(100 + i)
        outs.append(step(x, a, dx, da))
    return G, D, outs


def steps(transport: str = "auto", only=None):
    """3 SGD steps of each parallel mode against the single-device
    TrainStep from the same state on the same data and noise."""
    pmesh.TRANSPORT = transport
    rank, world = pmesh.world()
    results = {}
    tails = {"g_fused": True, "fused_critic": True}
    blocks = {"g_fused": "block", "fused_critic": "block"}
    cases = (("dp", {"data": world}, 8, None, 1, tails),
             ("dp fused_block fwdrev split", {"data": world}, 8, None, 1,
              {**blocks, "gp_mode": "fwdrev", "split": True}),
             ("edge 2x2", {"data": 2, "node": 2}, 8, None, 2, {"g_fused": True}),
             ("edge 1x4", {"data": 1, "node": 4}, 8, None, 1, {"g_fused": True}),
             ("edge 1x4 N 9 -> 12", {"data": 1, "node": 4}, 9, 12, 1, {"g_fused": True}),
             ("tp 2x2", {"data": 2, "model": 2}, 8, None, 2, tails),
             ("tp 2x2 fused_block", {"data": 2, "model": 2}, 8, None, 1, blocks),
             ("tp 1x4 use_pallas", {"data": 1, "model": 4}, 8, None, 1,
              {**tails, "g_pallas": True}))
    for label, shape, n, n_pad, depth, options in cases:
        if only is not None and label not in only:
            continue
        width = n_pad or n
        batches = _batches(n, n_pad=n_pad)
        G, D = _models(width, depth)
        mesh = pmesh.Mesh(shape)
        if "model" in shape:
            tpm.shard_gan_state_tp(mesh, G, D)
        g_opt, d_opt = SGD(G, 1e-2), SGD(D, 1e-2)
        gen = torch.Generator()
        if "node" in shape:
            step = ep.ShardedTrainStep(G, D, g_opt, d_opt, mesh, lambda_gp=10.0,
                                       m_dim=M_DIM, b_dim=B_DIM, generator=gen, **options)
            local, specs = ((lambda *t: ep.shard_train_inputs(mesh, *t)),
                            (ep.NODE_ROWS, ep.EDGE_ROWS))
        else:
            data = mesh.axis("data")
            step = TrainStep(G, D, g_opt, d_opt, lambda_gp=10.0, m_dim=M_DIM, b_dim=B_DIM,
                             generator=gen, noise_rows=(data.index, data.size), **options)
            for o in (g_opt, d_opt):
                o.grad_hook = pmesh.gradient_hook(data, divide=data.size)
            local, specs = ((lambda *t: pmesh.shard_batch(mesh, *t)),
                            (("data", None, None), ("data", None, None, None)))
        losses, logits = [], []
        G1, D1, ref = _single(width, batches, depth, options)
        for i, batch in enumerate(batches):
            gen.manual_seed(100 + i)
            out = step(*local(*batch))
            for key in ("d_loss", "g_loss"):
                got = pmesh.all_reduce(out[key].reshape(1), mesh.whole) / mesh.size
                losses.append((key, float(got), float(ref[i][key])))
            for key, spec in zip(("node_logits", "edge_logits"), specs):
                logits.append((key, pmesh.unshard(mesh, out[key], spec).numpy(),
                               ref[i][key].numpy()))
        params = []
        for tag, model, single in (("G", G, G1), ("D", D, D1)):
            whole = tpm.gather_state_dict(model, model.state_dict())
            params += [(f"{tag}.{name}", whole[name].numpy(), t.numpy())
                       for name, t in single.state_dict().items()]
        results[label] = {"losses": losses, "logits": logits, "params": params}
    return results if rank == 0 else None


def jax_step(eps):
    """One SGD step of the edge-partitioned step at 2x2 (B 4, N 8, depth 1)
    with the given global penalty noise: the global losses, and on rank 0
    the whole logits and parameters."""
    batch = _batches(8, b=4, steps=1)[0]
    G, D = _models(8)
    mesh = ep.make_edge_mesh(2, 2)
    g_opt, d_opt = SGD(G, 1e-2), SGD(D, 1e-2)
    step = ep.ShardedTrainStep(G, D, g_opt, d_opt, mesh, lambda_gp=10.0, m_dim=M_DIM,
                               b_dim=B_DIM)
    out = step(*ep.shard_train_inputs(mesh, *batch),
               eps=tuple(torch.from_numpy(t) for t in eps))
    res = {"losses": [float(out[k]) for k in ("d_loss", "g_loss")],
           "logits": [pmesh.unshard(mesh, out[k], spec).numpy() for k, spec in
                      (("node_logits", ep.NODE_ROWS), ("edge_logits", ep.EDGE_ROWS))],
           "g": {k: v.numpy() for k, v in G.state_dict().items()},
           "d": {k: v.numpy() for k, v in D.state_dict().items()}}
    return res if pmesh.world()[0] == 0 else res["losses"]


def trainer(argv, modes, root):
    """The port's Trainer on each mode's flags (2 steps, the cadence at
    step 2), then a second Trainer resuming it for 2 more; each rank with
    its own output directories."""
    from druggen_tpu_torch.config import parse_train_args
    from druggen_tpu_torch.train.trainer import Trainer

    rank, _ = pmesh.world()
    out = {}
    for label, flags in modes.items():
        base = os.path.join(root, label.replace(" ", "_"), f"rank{rank}")
        dirs = ["--model_save_dir", os.path.join(base, "m"), "--log_dir",
                os.path.join(base, "l"), "--sample_dir", os.path.join(base, "s")]
        tr = Trainer(parse_train_args(argv + flags + dirs)).train()
        first = {"step": tr.step, "vertexes": tr.vertexes, "mesh": tr.mesh.shape,
                 "model_dir": tr.model_dir}
        if tr.writer:
            first["losses"] = [(r["d_loss"], r["g_loss"]) for r in
                               map(__import__("json").loads, open(tr.logger.jsonl_path))
                               if "d_loss" in r]
        again = Trainer(parse_train_args(argv + flags + dirs + [
            "--epoch", "2", "--resume", "--resume_directory", tr.model_dir]))
        resumed_at = again.step
        again.train()
        out[label] = {"first": first, "resumed_at": resumed_at, "step": again.step,
                      "resumed_dir": again.model_dir,
                      "written": {d: sorted(os.listdir(d)) if os.path.isdir(d) else None
                                  for d in (tr.model_dir, again.model_dir)}}
    return out


def host_layout():
    """The same meshes with two hosts of two ranks (LOCAL_WORLD_SIZE 2)."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        return layout(LAYOUTS[:1] + LAYOUTS[2:4])
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


def every_check(eps):
    """This file's group: every job above, on both transports."""
    return {"layout": layout(), "host_layout": host_layout(), "jax_step": jax_step(eps),
            **{(job.__name__, transport): job(transport)
               for transport in ("auto", "broadcast") for job in (attention, witness)},
            ("steps", "auto"): steps("auto"),
            # the broadcast route: each mode once (the options add no collective)
            ("steps", "broadcast"): steps("broadcast", BROADCAST_CASES)}


BROADCAST_CASES = ("dp", "edge 2x2", "edge 1x4", "edge 1x4 N 9 -> 12", "tp 2x2")


JOBS = {"trainer": trainer, "layout": layout, "attention": attention, "witness": witness, "steps": steps,
        "every_check": every_check}

"""Scaling harness of the parallel modes (twin of ``scripts/scaling_bench.py``).

Times the full WGAN-GP step on meshes of 1, 2, 4, ... ranks of the process
group and prints one JSON line a mesh, then a summary line, as the JAX
script does:

- ``--mode dp``: data parallelism, the per-rank batch held (weak scaling);
  ``scaling_efficiency`` against linear;
- ``--mode edge``: the edge-partitioned step on ('data', 'node') meshes of
  growing node width, the global batch held, vertices padded to a multiple
  of the node axis; ``speedup_vs_1dev``;
- ``--mode tp``: the tensor-parallel step on ('data', 'model') meshes of
  growing model width, the global batch held.

A step's seconds are the marginal slope between two chains of steps
(``2 + iters`` and 2 steps, each ended by a device sync).  Run it under
``torchrun --nproc_per_node K`` (one card a rank, NCCL), inside a group the
caller started, or alone: ``--nproc K`` then starts K gloo ranks on
``--device`` (the CPU, or ranks sharing the card).  A tool: which scaling a
benchmark reports is that benchmark's choice.

    python -m druggen_tpu_torch.scaling_bench --mode edge --nproc 4 \\
        --device cpu --per-device-batch 4 --dim 16 --heads 4 --iters 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


class _Cfg:
    g_lr = d_lr = 1e-5
    beta1, beta2 = 0.9, 0.999
    adam_weight_decay = 0.01


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--per-device-batch", type=int, default=128)
    p.add_argument("--vertexes", type=int, default=45)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--mode", choices=["dp", "edge", "tp"], default="dp")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fused-mlp", action="store_true",
                   help="the Generator's edge tail through K1/K2")
    p.add_argument("--device", default="cuda")
    p.add_argument("--nproc", type=int, default=1,
                   help="without a process group: start this many gloo ranks")
    return p


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one_mesh(args, mesh, vert: int, batch: int, device):
    """Seconds a step on ``mesh`` (None on a rank outside it)."""
    from druggen_tpu_torch.chem.vocab import CHEMBL_VOCAB
    from druggen_tpu_torch.models import Discriminator, Generator
    from druggen_tpu_torch.parallel import edge_partition as ep
    from druggen_tpu_torch.parallel import mesh as pmesh
    from druggen_tpu_torch.parallel import tensor_parallel as tp
    from druggen_tpu_torch.train.optim import make_optimizers
    from druggen_tpu_torch.train.step import TrainStep

    if not mesh.member:
        return None
    m_dim, b_dim = CHEMBL_VOCAB.m_dim, CHEMBL_VOCAB.b_dim
    kw = dict(act="relu", vertexes=vert, edges=b_dim, nodes=m_dim, dropout=0.0,
              dim=args.dim, depth=args.depth, heads=args.heads, mlp_ratio=3,
              dtype=None if args.compute_dtype == "float32" else torch.bfloat16)
    G = Generator(fused_mlp=args.fused_mlp, **kw)
    D = Discriminator(**kw)
    if "model" in mesh.shape:
        tp.shard_gan_state_tp(mesh, G, D)
    g_opt, d_opt = make_optimizers(_Cfg(), G.to(device), D.to(device))
    dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
    common = dict(lambda_gp=10.0, m_dim=m_dim, b_dim=b_dim, compute_dtype=dtype,
                  g_fused=args.fused_mlp,
                  generator=torch.Generator(device).manual_seed(1))
    rng = np.random.default_rng(0)
    x = rng.integers(0, m_dim, (batch, vert)).astype(np.int8)
    a0 = np.triu(rng.integers(0, b_dim, (batch, vert, vert)), 1)
    a = (a0 + a0.transpose(0, 2, 1)).astype(np.int8)
    if "node" in mesh.shape:
        step = ep.ShardedTrainStep(G, D, g_opt, d_opt, mesh, **common)
        inputs = ep.shard_train_inputs(mesh, x, a, x, a)
    else:
        data = mesh.axis("data")
        step = TrainStep(G, D, g_opt, d_opt, noise_rows=(data.index, data.size), **common)
        for o in (g_opt, d_opt):
            o.grad_hook = pmesh.gradient_hook(data, divide=data.size)
        inputs = pmesh.shard_batch(mesh, x, a, x, a)
    inputs = [np.ascontiguousarray(t) for t in inputs]

    def chain(k: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(k):
            out = step(*inputs)
        float(out["d_loss"])
        _sync(device)
        return time.perf_counter() - t0

    chain(2)                                  # warm-up (first launches, builds)
    short = chain(2)
    long = chain(2 + args.iters)
    return max((long - short) / args.iters, 1e-9)


def run(args) -> list:
    """The scaling rows (on rank 0; None elsewhere)."""
    from druggen_tpu_torch.infer.engine import resolve_device
    from druggen_tpu_torch.parallel import edge_partition as ep
    from druggen_tpu_torch.parallel import mesh as pmesh
    from druggen_tpu_torch.parallel import tensor_parallel as tp

    rank, world = pmesh.world()
    device = resolve_device(pmesh.rank_device(args.device))
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rows, base = [], None
    for nd in sizes:
        if args.mode == "dp":
            mesh, vert, batch = pmesh.make_mesh(nd), args.vertexes, args.per_device_batch * nd
        elif args.mode == "edge":
            vert = -(-args.vertexes // nd) * nd
            mesh, batch = ep.make_edge_mesh(1, nd), args.per_device_batch
        else:
            if args.dim % nd:
                if rank == 0:
                    print(json.dumps({"mesh": f"1x{nd}",
                                      "skipped": f"dim {args.dim} % tp {nd} != 0"}))
                continue
            mesh, vert, batch = tp.make_dp_tp_mesh(1, nd), args.vertexes, args.per_device_batch
        sec = _one_mesh(args, mesh, vert, batch, device)
        if rank != 0:
            continue
        mols = batch / sec
        base = base or mols
        row = {"devices": nd, "batch": batch, "step_seconds": round(sec, 5),
               "mols_per_s": round(mols, 1), "edges_per_s": round(mols * vert * vert, 1)}
        if args.mode == "dp":
            row["scaling_efficiency"] = round(mols / (base * nd), 3)
        else:
            row = {"mesh": f"1x{nd}", **row, "speedup_vs_1dev": round(mols / base, 3)}
            row["vertexes" if args.mode == "edge" else "dim"] = (
                vert if args.mode == "edge" else args.dim)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rank == 0:
        print(json.dumps({"summary": rows}), flush=True)
        return rows
    return None


def _rank(args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nproc))
    run(args)


def main(argv=None) -> None:
    import torch.distributed as dist

    from druggen_tpu_torch.parallel import mesh as pmesh

    args = _parser().parse_args(argv)
    if dist.is_initialized() or args.nproc == 1 and not pmesh.launched_by_torchrun():
        run(args)
    elif pmesh.launched_by_torchrun():
        pmesh.init_distributed()
        run(args)
        pmesh.leave_group()
    else:
        pmesh.spawn(_rank, args.nproc, args)


if __name__ == "__main__":
    main()

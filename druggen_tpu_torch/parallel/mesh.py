"""Meshes of ranks, the start-up of the process group, and the collectives
(port of ``druggen_tpu/parallel/mesh.py``).

A *device* of the port is a rank of the default ``torch.distributed``
process group, one device a rank.  A :class:`Mesh` is a named layout of
those ranks, ``('data',)``, ``('data', 'node')`` or ``('data', 'model')``,
laid out host-major in row-major order (rank ``d * k + j`` holds mesh
coordinate ``(d, j)``), as JAX's meshes reshape ``jax.devices()``, which
orders devices by process.  Each axis has its own sub-group: :class:`Axis`
is the line of ranks through this rank along one axis.  Every rank of the
world builds the same meshes in the same order (``new_group`` is
collective); a rank outside a mesh smaller than the world holds no
coordinate and idles.

The group comes from, in this order: a group the caller already started;
:func:`init_distributed` with an explicit coordinator (``--distributed``);
the environment ``torchrun`` sets.  With none of them the world is one
rank and every collective of a one-rank axis is the identity.

Transport.  NCCL and gloo on CPU tensors run the native collectives
(``all_gather``, ``all_reduce``, ``all_to_all_single``); gloo on CUDA
tensors carries only ``broadcast`` and ``all_reduce``, so there a gather is
one broadcast from each rank of the axis and the edge transpose one
broadcast of each rank's block, of which each rank keeps its columns (half
precision travels as f32, which is exact).  ``TRANSPORT = "broadcast"``
forces that route everywhere (the CPU tests run both).  Nothing is ever
computed on the CPU in place of the card.

Data.  The global batch of a step is the concatenation of the hosts'
batches (``BatchIterator(host_id, num_hosts)`` per host, as the JAX trainer
feeds ``make_array_from_process_local_data``); within a host each rank takes
the rows of its 'data' coordinate, and along 'node' the vertex rows of its
coordinate (:func:`shard`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# "auto": native collectives where the backend carries them for the
# tensor's device, broadcast/all_reduce otherwise; "broadcast": always the
# latter.
TRANSPORT = "auto"
# collectives this process has called and their payload bytes (each call's
# input, or each broadcast's buffer, as it travels)
MOVED = {"calls": 0, "bytes": 0}


def _count(t: torch.Tensor) -> None:
    MOVED["calls"] += 1
    MOVED["bytes"] += t.numel() * t.element_size()


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str = "", num_processes: int = 0,
                     process_id: int = -1, backend: str | None = None
                     ) -> tuple[int, int]:
    """Start the default process group and return ``(rank, world size)``.

    A group that is already up is kept.  ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` start it over TCP
    (JAX ``mesh.py:71-86``); each left empty is read from the environment
    ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  ``backend`` defaults to NCCL when every rank of a host has a
    card of its own, else gloo (two ranks on one card, or the CPU)."""
    if dist.is_initialized():
        return world()
    env = os.environ
    rank = process_id if process_id >= 0 else int(env.get("RANK", "0"))
    size = num_processes if num_processes > 0 else int(env.get("WORLD_SIZE", "1"))
    if backend is None:
        local = int(env.get("LOCAL_WORLD_SIZE", size))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    if coordinator_address:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=size, rank=rank)
    else:
        dist.init_process_group(backend, init_method="env://", world_size=size,
                                rank=rank)
    return world()


def leave_group() -> None:
    """End a rank that a launcher spawned, once its work is done: a barrier
    over the world, then the process exits at once with code 0.  gloo's
    teardown of sub-groups at interpreter exit can abort a process
    ("terminate called without an active exception") after all its work
    succeeded, which would fail the launcher's join."""
    import sys

    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _spawned(rank: int, nprocs: int, init: str, fn, args) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=nprocs)
    fn(*args)
    leave_group()


def spawn(fn, nprocs: int, *args, timeout: float = 600.0) -> None:
    """Run ``fn(*args)`` on ``nprocs`` new processes, each a rank of a gloo
    group (a ``file://`` rendezvous in a fresh temporary directory, so that
    concurrent groups never share a port).  Raises when a rank fails, with
    its traceback, or when the group outlives ``timeout`` seconds (a
    deadlock fails instead of hanging); no rank outlives the call.  ``fn``
    must be importable by the new processes (a module's top level)."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="druggen_group_") as tmp:
        ctx = mp.start_processes(_spawned, args=(nprocs, os.path.join(tmp, "rendezvous"),
                                                 fn, args),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()


def launched_by_torchrun() -> bool:
    env = os.environ
    return "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env


def rank_device(device: str | torch.device) -> torch.device:
    """The card of this rank for a bare ``"cuda"``: ``LOCAL_RANK`` (or the
    rank) modulo the cards of the host, so ranks that outnumber the cards
    share them."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or world()[1] == 1:
        return dev
    if not torch.cuda.is_available():
        return dev
    local = int(os.environ.get("LOCAL_RANK", world()[0]))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis through this rank: its ``name``, the global ``ranks`` of
    the line in axis order, this rank's ``index`` on it and the line's
    process ``group`` (None for a one-rank line)."""

    name: str
    ranks: tuple
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """``Mesh({'data': dp, 'node': k})``: ranks ``0 .. prod(sizes) - 1`` of
    the default group laid out row-major; collective (every rank of the
    world builds it).  Raises ``ValueError`` when the mesh needs more ranks
    than the world has (JAX ``mesh.py:45-46``)."""

    def __init__(self, shape: dict):
        self.names = tuple(shape)
        self.sizes = tuple(int(shape[n]) for n in self.names)
        self.rank, self.world_size = world()
        need = int(np.prod(self.sizes))
        if need > self.world_size:
            raise ValueError(f"mesh {dict(shape)} needs {need} ranks, have "
                             f"{self.world_size}")
        grid = np.arange(need).reshape(self.sizes)
        self.member = self.rank < need
        self.coords = (dict(zip(self.names, (int(c) for c in np.unravel_index(
            self.rank, self.sizes)))) if self.member else None)
        # hosts: LOCAL_WORLD_SIZE ranks each, host-major
        local = int(os.environ.get("LOCAL_WORLD_SIZE", self.world_size))
        self.num_hosts = max(self.world_size // max(local, 1), 1)
        self.host_id = self.rank // max(local, 1)
        self.axes = {}
        for d, name in enumerate(self.names):
            lines = np.moveaxis(grid, d, -1).reshape(-1, self.sizes[d])
            for line in lines:
                group = self._group(line)
                if self.member and self.rank in line:
                    self.axes[name] = Axis(name, tuple(int(r) for r in line),
                                           int(np.flatnonzero(line == self.rank)[0]),
                                           group)
        every = grid.reshape(-1)
        group = self._group(every)
        self.whole = (Axis("mesh", tuple(int(r) for r in every),
                           int(self.rank), group) if self.member else None)

    def _group(self, ranks):
        if len(ranks) == 1:
            return None
        if len(ranks) == self.world_size:
            return dist.group.WORLD
        return dist.new_group([int(r) for r in ranks])

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(n_data: int = 0) -> Mesh:
    """1-D mesh over 'data'; ``n_data=0`` uses every rank (JAX
    ``make_mesh``)."""
    n = n_data if n_data > 0 else world()[1]
    return Mesh({"data": n})


# ---------------------------------------------------------------------------
# transport (no autograd; models/layers.py wraps them)
# ---------------------------------------------------------------------------

def _broadcast_route(x: torch.Tensor, axis: Axis) -> bool:
    if TRANSPORT == "broadcast":
        return True
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A copy to send on the broadcast route (half precision as f32)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.clone()


def _broadcast_from(x: torch.Tensor, axis: Axis, i: int) -> torch.Tensor:
    """Rank ``i`` of the axis's ``x`` on every rank of the axis."""
    buf = _wire(x) if i == axis.index else torch.empty(
        x.shape, dtype=torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
        else x.dtype, device=x.device)
    dist.broadcast(buf, src=axis.ranks[i], group=axis.group)
    _count(buf)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in axis order."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    if _broadcast_route(x, axis):
        parts = [_broadcast_from(x, axis, i) for i in range(axis.size)]
    else:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        _count(x)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    if axis.size == 1:
        return x
    if _broadcast_route(x, axis):
        y = _wire(x)
    else:
        y = x.contiguous().clone()
    dist.all_reduce(y, group=axis.group)
    _count(y)
    return y.to(x.dtype)


def edge_transpose(e: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Transpose axes (1, 2) of a global ``[B, N, N, ...]`` tensor whose
    first vertex axis is sharded over ``axis``: this rank's row block
    ``[B, n, N, ...]`` in, its row block of the transpose out.  One tiled
    all_to_all (rank ``s`` sends its columns of rank ``r``'s rows to ``r``)
    and a local swap (JAX ``layers.py:110-123``)."""
    k = axis.size
    if k == 1:
        return e.transpose(1, 2)
    b, n, big = e.shape[:3]
    rest = e.shape[3:]
    if big != n * k:
        raise ValueError(f"edge block {tuple(e.shape)}: N {big} != {k} x {n}")
    me = axis.index
    if _broadcast_route(e, axis):
        # each rank's rows, of which this rank keeps its own columns
        chunks = [_broadcast_from(e, axis, s)[:, :, me * n:(me + 1) * n]
                  for s in range(k)]
        z = torch.cat(chunks, 1)                         # [b, N, n, ...]
    else:
        send = e.reshape(b, n, k, n, *rest).movedim(2, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis.group)
        _count(send)
        z = recv.movedim(0, 1).reshape(b, big, n, *rest)
    return z.transpose(1, 2)


def gradient_hook(axis: Axis, divide: float = 1.0, scale=None):
    """An :class:`..train.optim.AdamW` ``grad_hook``: the flat gradient
    (times ``scale``, per element) summed over ``axis``, divided by
    ``divide``.  Every rank then guards and updates on the same numbers."""
    def hook(flat: torch.Tensor) -> torch.Tensor:
        if scale is not None:
            flat = flat * scale
        flat = all_reduce(flat, axis)
        return flat / divide if divide != 1 else flat
    return hook


# ---------------------------------------------------------------------------
# placement of batches and states
# ---------------------------------------------------------------------------

def _coord(mesh: Mesh, name: str) -> tuple[int, int]:
    """(index, count) of this rank's block along ``name`` in the arrays a
    rank holds: 'data' indexes its host's batch (the hosts' batches make the
    global one), the other axes the global extent."""
    idx, size = mesh.coords[name], mesh.shape[name]
    if name == "data" and mesh.num_hosts > 1:
        if size % mesh.num_hosts:
            raise ValueError(f"'data' axis {size} does not split over "
                             f"{mesh.num_hosts} hosts")
        size //= mesh.num_hosts
        idx %= size
    return idx, size


def shard(mesh: Mesh, array, spec: tuple):
    """This rank's block of ``array`` (numpy or torch): dimension ``i`` is
    split over the mesh axis ``spec[i]`` (None: kept whole)."""
    index = []
    for dim, name in enumerate(spec):
        if name is None:
            index.append(slice(None))
            continue
        i, k = _coord(mesh, name)
        n = array.shape[dim]
        if n % k:
            raise ValueError(f"dimension {dim} of {tuple(array.shape)} does not "
                             f"split over {k} ranks of {name!r}")
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    return array[tuple(index)]


def unshard(mesh: Mesh, t: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The inverse of :func:`shard` on every rank of the mesh (collective):
    the blocks gathered along each split dimension; along 'data' the global
    batch."""
    for dim, name in enumerate(spec):
        if name is not None:
            t = all_gather(t, mesh.axis(name), dim)
    return t


def batch_sharding(mesh: Mesh, ndim: int) -> tuple:
    """Axis 0 (the batch) over 'data', the rest whole (JAX ``batch_sharding``)."""
    return ("data",) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> tuple:
    """No dimension split (JAX ``replicated``)."""
    return ()


def shard_batch(mesh: Mesh, *arrays):
    """Each ``[B, ...]`` host batch cut to this rank's 'data' rows (JAX
    ``shard_batch``, and ``global_batch_from_local``: each host feeds its
    own ``BatchIterator(host_id, num_hosts)`` slice and the global batch is
    their union)."""
    return tuple(shard(mesh, a, batch_sharding(mesh, np.ndim(a))) for a in arrays)


@torch.no_grad()
def shard_state(mesh: Mesh, tensors, axis: Axis | None = None) -> None:
    """Make every rank hold the values of ``tensors`` of the first rank of
    its line along ``axis`` (default: the whole mesh), in place: one
    broadcast each.  Under a split 'model' axis pass the 'data' axis: the
    ranks of a 'model' line hold different shards."""
    axis = mesh.whole if axis is None else axis
    if axis is None or axis.size == 1:
        return
    for t in tensors:
        t.copy_(_broadcast_from(t, axis, 0))


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's picklable ``obj`` on every rank of the mesh."""
    axis = mesh.whole
    if axis is None or axis.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=axis.ranks[0], group=axis.group)
    return box[0]

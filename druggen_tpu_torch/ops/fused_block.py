"""Fused encoder-block edge stream (the "megablock"), K7 and K8.

Port of ``druggen_tpu/ops/fused_block.py``.  One encoder block's whole edge
stream, per graph, query atom i, key atom j and channel c:

    e         = y @ We + be                        (edge projection)
    t         = (q_i * k_j) / sqrt(dk) * (e + 1) * e
    y1        = t @ Woe + boe                      (pre-softmax edge readout)
    node_agg  = sum_j softmax_j(t) * v_j           (per channel)
    u         = LN4(y + y1)
    y_out     = LN6(u + MLP2(u))                   (the edge-stream tail)

:func:`fused_block_edge_stream` runs it through K7 (``csrc/fused_block.cu``,
the Pallas ``_fwd_kernel``) and K8 (``csrc/fused_block_bwd.cu``,
``_bwd_kernel``): one read of ``y`` and one write of ``y_out`` forward, a
backward that recomputes everything from ``y``.  Both are hand-written CUDA
for sm_90a, built per width (C, H) at first use; their headers state what
bounds them.

Rounding points, as in the Pallas kernels.  Forward: ``We`` and ``Woe``
rounded to the stream dtype and multiplied in f32; ``t``, ``y1``, the softmax
and ``y + y1`` f32; ``u`` rounded to the stream dtype before fc1 and the
hidden before fc2; LN6 in f32; ``y_out`` and ``node_agg`` rounded at the end.
Backward: the four weights rounded then used in f32; the recompute keeps
``u`` and ``h`` unrounded in f32; every gradient f32 until the final casts.
:func:`fused_block_fwd_reference` and :func:`fused_block_bwd_reference` are
the plain versions with those points; :func:`block_edge_stream_reference` is
the all-f32 oracle (JAX ``jnp_block_edge_stream``).

Routes on the card (:func:`launch_plan`): bf16 at C = 128 with H a multiple
of 128 and N <= 64 (the training path) runs the Hopper kernels of
``csrc/block_hopper.cuh`` (every product on ``wgmma``; an f32 left operand
as three bf16 pieces, :func:`split_bf16`; the softmax's terms divided by
their sum as one reciprocal a channel, within an ulp of the plain versions'
division); every other width, N > 64 and f32 run the CUDA-core kernels in
the same sources.

Routing (:func:`uses_kernel`, the JAX rule of ``fused_block_edge_stream``
with "card" for "TPU"): on a CUDA tensor a channel width that is a multiple
of 128 launches K7/K8 and any other width runs the oracle under autograd; on
a CPU tensor the plain versions of K7/K8 run at every width (as JAX's
interpret mode runs the kernel at every width).  The JAX package's padding of
vertices and batch is a Mosaic layout workaround and is not carried over.

:class:`FusedBlock` is the ``torch.autograd.Function`` (the JAX
``custom_vjp``): K7 forward, K8 backward, first-order only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from druggen_tpu_torch.ops import _build
from druggen_tpu_torch.ops.fused_attention import _device_index, _softmax_keys
from druggen_tpu_torch.ops.fused_mlp import (
    KINK_REACH,
    SMEM_LIMIT,
    _widths,
    num_sms,
    padded_weights,
)

_EPS = 1e-5
PARAM_NAMES = ("we", "be", "woe", "boe", "g4", "b4", "w1", "b1", "w2", "b2", "g6", "b6")
GRAD_NAMES = ("dq", "dk", "dv", "dy") + tuple(f"d{p}" for p in PARAM_NAMES)


def uses_kernel(d: int, device_type: str) -> bool:
    """The JAX routing rule (``fused_block_edge_stream`` :569-584): on the
    card (the TPU there) a width ``d`` that is a multiple of 128 takes the
    kernels and any other the oracle; off the card (JAX's interpret mode,
    here the CPU) the kernels' plain versions run at every width."""
    return device_type != "cuda" or d % 128 == 0


# ---------------------------------------------------------------- plain math

def _ln(x, g, b):
    """The Pallas kernels' f32 LayerNorm: ``(x - mu) * rsqrt(var + eps) * g + b``."""
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    return d * torch.rsqrt((d * d).mean(-1, keepdim=True) + _EPS) * g + b


def block_edge_stream_reference(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1,
                                w2, b2, g6, b6, heads: int):
    """The oracle (JAX ``jnp_block_edge_stream`` :53-71): everything in f32
    with f32 weights, the outputs rounded once (``y_out`` to y's dtype,
    ``node_agg`` to q's).  q, k, v [B, N, D]; y [B, N, N, D]; we, woe [D, D],
    w1 [D, H], w2 [H, D] ([in, out]); vectors [D] or [H].  Differentiable to
    any order."""
    d = q.shape[-1]
    f32 = torch.float32
    inv = 1.0 / math.sqrt(d // heads)
    qf, kf, vf, yf = (a.to(f32) for a in (q, k, v, y))
    e = yf @ we.to(f32) + be.to(f32)
    t = (qf[:, :, None] * kf[:, None]) * inv
    t = t * (e + 1.0) * e
    y1 = t @ woe.to(f32) + boe.to(f32)
    node_agg = (torch.softmax(t, dim=2) * vf[:, None]).sum(dim=2)
    u = _ln(yf + y1, g4.to(f32), b4.to(f32))
    h = torch.relu(u @ w1.to(f32) + b1.to(f32))
    m = h @ w2.to(f32) + b2.to(f32)
    y_out = _ln(u + m, g6.to(f32), b6.to(f32))
    return y_out.to(y.dtype), node_agg.to(q.dtype)


def fused_block_fwd_reference(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1,
                              w2, b2, g6, b6, heads: int):
    """Plain PyTorch version of K7 (the Pallas ``_fwd_kernel`` :82-141)
    with its rounding points (module docstring).  Returns ``(y_out,
    node_agg)`` in y's and q's dtype."""
    d = q.shape[-1]
    f32, dt = torch.float32, y.dtype
    inv = 1.0 / math.sqrt(d // heads)

    def rnd(a):
        return a.to(dt).to(f32)

    qf, kf, vf, yf = (a.to(f32) for a in (q, k, v, y))
    e = yf @ rnd(we) + be.to(f32)
    t = (qf[:, :, None] * kf[:, None]) * inv
    t = t * (e + 1.0) * e
    y1 = t @ rnd(woe) + boe.to(f32)
    node_agg = (_softmax_keys(t) * vf[:, None]).sum(dim=2)
    u = _ln(yf + y1, g4.to(f32), b4.to(f32))
    h = torch.relu(rnd(u) @ rnd(w1) + b1.to(f32))
    m = rnd(h) @ rnd(w2) + b2.to(f32)
    y_out = _ln(u + m, g6.to(f32), b6.to(f32))
    return y_out.to(dt), node_agg.to(q.dtype)


def _ln_parts(x):
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + _EPS)
    return d * rstd, rstd


def _ln_bwd(dy, xhat, rstd, g):
    dxh = dy * g
    return (dxh - dxh.mean(-1, keepdim=True)
            - xhat * (dxh * xhat).mean(-1, keepdim=True)) * rstd


def _recompute(q, k, v, y, params, heads):
    """K8's recompute of the forward, all f32 from the rounded weights."""
    we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6 = params
    d = q.shape[-1]
    f32, dt = torch.float32, y.dtype
    inv = 1.0 / math.sqrt(d // heads)

    def rnd(a):
        return a.to(dt).to(f32)

    qf, kf, vf, yf = (a.to(f32) for a in (q, k, v, y))
    w = {"we": rnd(we), "woe": rnd(woe), "w1": rnd(w1), "w2": rnd(w2)}
    e = yf @ w["we"] + be.to(f32)
    p = (qf[:, :, None] * kf[:, None]) * inv
    t = p * (e + 1.0) * e
    y1 = t @ w["woe"] + boe.to(f32)
    s = _softmax_keys(t)
    xhat4, rstd4 = _ln_parts(yf + y1)
    u = xhat4 * g4.to(f32) + b4.to(f32)
    hpre = u @ w["w1"] + b1.to(f32)
    h = torch.relu(hpre)
    xhat6, rstd6 = _ln_parts(u + h @ w["w2"] + b2.to(f32))
    return dict(qf=qf, kf=kf, vf=vf, yf=yf, w=w, e=e, p=p, t=t, s=s, xhat4=xhat4,
                rstd4=rstd4, u=u, hpre=hpre, h=h, xhat6=xhat6, rstd6=rstd6, inv=inv)


def fused_block_bwd_reference(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1,
                              w2, b2, g6, b6, gy, gn, heads: int, relu_set=None):
    """Plain PyTorch version of K8 (the Pallas ``_bwd_kernel`` :144-352)
    with its rounding points (module docstring).  Returns ``(dq, dk, dv, dy,
    dwe, dbe, dwoe, dboe, dg4, db4, dw1, db1, dw2, db2, dg6, db6)``: dq, dk,
    dv in q's dtype, dy in y's, the parameter gradients in f32 cast to each
    parameter's dtype.

    ``relu_set``: optional ``(rows, units, live)``, rows of the edge stream
    viewed as [B * N * N] rows, hidden units and bools: the ReLU derivative
    at each such unit is ``live`` instead of ``hpre > 0`` (which side of
    the kink a unit within rounding of it takes; :func:`witness_kink_flips`)."""
    params = (we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6)
    f32 = torch.float32
    r = _recompute(q, k, v, y, params, heads)
    w, inv = r["w"], r["inv"]
    d, hid = q.shape[-1], w1.shape[-1]
    go = gy.to(f32)
    g_n = gn.to(f32)
    dr = _ln_bwd(go, r["xhat6"], r["rstd6"], g6.to(f32))
    dh = dr @ w["w2"].t()
    live = r["hpre"] > 0.0
    if relu_set is not None:
        rows, units, values = relu_set
        live = live.reshape(-1, hid).clone()
        live[rows, units] = values
        live = live.reshape(r["hpre"].shape)
    dhpre = dh * live
    du = dr + dhpre @ w["w1"].t()
    dtt = _ln_bwd(du, r["xhat4"], r["rstd4"], g4.to(f32))
    s = r["s"]
    ds_in = g_n[:, :, None] * r["vf"][:, None]
    dt = dtt @ w["woe"].t() + s * (ds_in - (ds_in * s).sum(dim=2, keepdim=True))
    e = r["e"]
    dp = dt * (e + 1.0) * e
    de = dt * r["p"] * (2.0 * e + 1.0)
    dy = dtt + de @ w["we"].t()
    dq = (dp * r["kf"][:, None]).sum(dim=2) * inv
    dk = (dp * r["qf"][:, :, None]).sum(dim=1) * inv
    dv = (s * g_n[:, :, None]).sum(dim=1)

    def wsum(a, b_):
        return a.reshape(-1, a.shape[-1]).t() @ b_.reshape(-1, b_.shape[-1])

    def vsum(a):
        return a.reshape(-1, a.shape[-1]).sum(0)

    grads = (wsum(r["yf"], de), vsum(de), wsum(r["t"], dtt), vsum(dtt),
             vsum(du * r["xhat4"]), vsum(du), wsum(r["u"], dhpre), vsum(dhpre),
             wsum(r["h"], dr), vsum(dr), vsum(go * r["xhat6"]), vsum(go))
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dy.to(y.dtype),
            *(g.to(p.dtype) for g, p in zip(grads, params)))


def witness_kink_flips(q, k, v, y, params, gy, gn, heads, dy, bad_rows, row_ok):
    """Explain the rows of K8's ``dy`` that its plain version does not match
    by the side of the ReLU kink that hidden units near it take.

    K8's recompute keeps the pre-activation ``hpre = u @ W1 + b1`` in f32;
    the kernel and the plain version sum it in another order, so a unit
    whose ``hpre`` lies within rounding of 0 (``KINK_REACH[f32]`` times
    sum_k |u_k W1_kj|) may take either side of the kink, which moves its
    row's ``dy`` by O(1e-1).  For each row in ``bad_rows`` (indices into the
    edge stream viewed as [B * N * N] rows) the plain version is recomputed
    with each side for each of its 3 units nearest the kink that lie within
    reach; a row is explained by the setting with the fewest units moved
    under which ``row_ok(dy_rows, ref_rows)`` (a bool per row) holds.  Only
    the graphs that hold such rows are recomputed (a row's ``dy`` depends on
    its own graph alone).  ``params`` is the 12 parameters in
    :data:`PARAM_NAMES` order.

    Returns ``(relu_set, unexplained)``: the settings of the explained rows,
    for ``fused_block_bwd_reference(..., relu_set=relu_set)``, and the rows
    that no setting explains."""
    b, n, d = q.shape
    hid = params[6].shape[-1]
    dev = q.device
    bad_rows = bad_rows.to(dev)
    per_graph = n * n
    graphs = torch.unique(bad_rows // per_graph)
    local = torch.searchsorted(graphs, bad_rows // per_graph) * per_graph + bad_rows % per_graph
    sub = [a[graphs] for a in (q, k, v, y, gy, gn)]
    r = _recompute(*sub[:4], params, heads)
    u = r["u"].reshape(-1, d)[local]
    w1r = r["w"]["w1"]
    hpre = r["hpre"].reshape(-1, hid)[local]
    reach = KINK_REACH[torch.float32] * (u.abs() @ w1r.abs())
    kk = min(3, hid)
    near = hpre.abs().topk(kk, -1, largest=False).indices
    within = hpre.gather(1, near).abs() <= reach.gather(1, near)
    side = hpre.gather(1, near) > 0.0
    rows = local.repeat_interleave(kk)
    bit = 2 ** torch.arange(kk, device=dev)
    got = dy.reshape(-1, d)[bad_rows]

    def setting(moved):
        return side ^ (((moved[:, None] & bit) > 0) & within)

    choice = torch.full_like(bad_rows, -1)
    for moved in sorted(range(2 ** kk), key=lambda m: bin(m).count("1")):
        live = setting(torch.full_like(bad_rows, moved))
        ref = fused_block_bwd_reference(
            *sub[:4], *params, *sub[4:], heads,
            relu_set=(rows, near.reshape(-1), live.reshape(-1)))[3]
        ref_rows = ref.reshape(-1, d)[local]
        choice = torch.where((choice < 0) & row_ok(got, ref_rows), moved, choice)
    ok = choice >= 0
    relu_set = (bad_rows[ok].repeat_interleave(kk), near[ok].reshape(-1),
                setting(choice.clamp_min(0))[ok].reshape(-1))
    return relu_set, bad_rows[~ok]


def split_bf16(x):
    """The kernels' three-piece split of an f32 tensor (``block_hopper.cuh``
    ``split3``): bf16 tensors ``(a, b, c)`` with ``a = bf16(x)``, ``b =
    bf16(x - a)``, ``c = bf16(x - a - b)`` (both differences exact in f32),
    so that ``a + (b + c) == x`` bit for bit for 2^-110 <= |x| < 2^128 (1 -
    2^-9) and for 0 (below, c loses the bits under 2^-133; from the top on,
    a is infinite)."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = x.to(f32)
    a = x.to(bf16)
    r = x - a.to(f32)
    b = r.to(bf16)
    c = (r - b.to(f32)).to(bf16)
    return a, b, c


def split_matmul(x, w):
    """``x @ w`` as the kernels run it for an f32 ``x`` and a bf16-exact
    ``w``: three bf16 pieces of ``x``, each product exact in f32, summed
    into one f32 result (the smallest piece first)."""
    f32 = torch.float32
    wf = w.to(f32)
    a, b, c = split_bf16(x)
    return (c.to(f32) @ wf + b.to(f32) @ wf) + a.to(f32) @ wf


def split_matmul6(x, w):
    """``x @ w`` as K5/K6 (``csrc/attn_hopper.cuh`` ``mma_pieces_w6``) run it
    for an f32 ``x`` and an f32 ``w``: both as three bf16 pieces, the six
    significant piece products (x piece, w piece) (2, 0), (1, 1), (0, 2),
    (1, 0), (0, 1), (0, 0), each exact in f32, summed into one f32 result in
    that order.  The three left out, (1, 2), (2, 1), (2, 2), are below
    2^-23 |x| |w| together."""
    f32 = torch.float32
    xs = [p_.to(f32) for p_ in split_bf16(x)]
    ws = [p_.to(f32) for p_ in split_bf16(w)]
    out = None
    for pa, pb in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        term = xs[pa] @ ws[pb]
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------- launch plan

# The Hopper route's geometry (csrc/block_hopper.cuh and fused_block_bwd.cu
# hold the same constants; their shared memory is the libraries' own:
# library_plan).
TILE_ROWS = 64          # rows a slab tile (one warpgroup); N at most this
HIDDEN_CHUNK = 64       # hidden columns a streamed weight chunk
WGRAD_ROWS = 64         # rows a wgrad stage
WGRAD_TILE = 128        # a wgrad block's output tile: C x 128


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Launch geometry and scratch of the bf16 K7 and K8 for C = ``c``, H =
    ``h``, ``batch`` graphs of ``n`` atoms on ``num_sms`` SMs."""
    c: int
    h: int
    batch: int
    n: int
    hopper: bool            # the Hopper route takes this shape (else CUDA cores)
    slabs: int              # (b, i) slabs, one 64-row tile each
    rows: int               # edge rows, batch * n * n
    tile_rows: int
    grid: int               # persistent blocks of K7 and of K8's rows launches
    wgrad_tiles: int        # wgrad blocks a row chunk (C x 128 output tiles)
    chunks: int             # wgrad row chunks (split K)
    chunk_rows: int
    vec_partials: int       # rows of K8's LayerNorm-sum partial [*, 4 C] (one a warp)
    row_scratch_bytes: int  # K8's f32 rows for its later launches (and LN4's 1 / std)
    scratch_bytes: int      # all of K8's device scratch

    @property
    def pad_share(self) -> float:
        """Share of the tiles' rows that are padding past N."""
        return 1.0 - self.n / self.tile_rows if self.hopper else 0.0

    def slab_range(self, block: int) -> tuple:
        """The contiguous run of slabs ``[begin, end)`` that persistent
        block ``block`` of K7 and of K8's rows launches owns (the kernels'
        ``SlabRange``)."""
        return (self.slabs * block // self.grid, self.slabs * (block + 1) // self.grid)

    def tile_rows_of(self, slab: int) -> tuple:
        """The edge rows ``[first, first + n)`` of slab ``slab``'s 64-row
        tile that are valid (the tile's other rows are padding)."""
        return (slab * self.n, slab * self.n + self.n)

    def wgrad_tile(self, tile: int) -> tuple:
        """``(gradient, first column)`` of wgrad block ``tile`` of a row
        chunk: each a C x 128 tile of dWe, dWoe, dW1 or dW2^T (the kernel's
        ``wg_z``)."""
        tc, th = self.c // WGRAD_TILE, self.h // WGRAD_TILE
        for name, count in (("dwe", tc), ("dwoe", tc), ("dw1", th), ("dw2", th)):
            if tile < count:
                return name, tile * WGRAD_TILE
            tile -= count
        raise IndexError("no such wgrad tile")


# Where K8's Hopper route takes each of the 12 parameter gradients from (the
# reduce launch sums each over its partials in a fixed order): the wgrad
# pass's weight partials, its column sums of the stored rows (the bias
# gradients), or the rows launches' LayerNorm sums.
GRADIENT_SOURCES = {
    "dwe": "wgrad", "dbe": "wgrad column sums of de", "dwoe": "wgrad",
    "dboe": "wgrad column sums of dtt", "dg4": "rows (backward)", "db4": "rows (backward)",
    "dw1": "wgrad", "db1": "wgrad column sums of dhpre", "dw2": "wgrad (transposed)",
    "db2": "wgrad column sums of dr", "dg6": "rows (recompute)", "db6": "rows (recompute)",
}


def launch_plan(c: int, h: int, batch: int, n: int, num_sms: int) -> LaunchPlan:
    """The bf16 K7/K8 geometry (``csrc/block_hopper.cuh`` explains it): the
    Hopper route where C is 128, H a multiple of 128 and 1 <= N <= 64; one
    warpgroup a block, a persistent block per SM, each a contiguous run of
    slabs; K8's wgrad in blocks of C x 128 output tiles over row chunks that
    cover the rows exactly, about two blocks a SM; K8's f32 row scratch t,
    xhat4, dr, dtt, de, dp [R, C], h, dhpre [R, H] and LN4's 1 / std [R]."""
    if c <= 0 or h <= 0 or batch < 0 or n <= 0:
        raise ValueError(f"K7/K8 take C, H, N > 0 and batch >= 0, got C {c}, H {h}, "
                         f"batch {batch}, N {n}")
    hopper = c == 128 and h % 128 == 0 and n <= TILE_ROWS
    slabs, rows = batch * n, batch * n * n
    wgrad_tiles = 2 * (c // WGRAD_TILE) + 2 * (h // WGRAD_TILE)
    grid = max(1, min(num_sms, slabs))
    stages = max(1, -(-rows // WGRAD_ROWS))
    chunks = min(stages, max(1, (2 * num_sms) // max(1, wgrad_tiles)))
    chunk_rows = _pad(-(-rows // chunks), WGRAD_ROWS) if rows else WGRAD_ROWS
    chunks = max(1, -(-rows // chunk_rows))
    row_scratch = rows * (6 * c + 2 * h + 1) * 4
    scratch = (row_scratch + 3 * slabs * c * 4 + slabs * (h // HIDDEN_CHUNK) * 128 * 4
               + grid * 4 * 4 * c * 4
               + chunks * (3 * c + h) * 4 + chunks * (2 * c * c + 2 * c * h) * 4
               + (2 * c * c + 2 * c * h + 7 * c + h) * 4)
    return LaunchPlan(
        c=c, h=h, batch=batch, n=n, hopper=hopper, slabs=slabs, rows=rows,
        tile_rows=TILE_ROWS, grid=grid, wgrad_tiles=wgrad_tiles, chunks=chunks,
        chunk_rows=chunk_rows, vec_partials=grid * 4, row_scratch_bytes=row_scratch,
        scratch_bytes=scratch)


# ---------------------------------------------------------------- kernels

@functools.cache
def _fwd_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_block", _widths(c, h))
    for fn in (lib.fused_block_fwd_bf16, lib.fused_block_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 18
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_block_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_block_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_block_fwd_bf16_wgmma.argtypes = (
        [ctypes.c_void_p] * 18
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.fused_block_fwd_bf16_wgmma.restype = ctypes.c_int
    lib.fused_block_fwd_wgmma_smem_bytes.argtypes = []
    lib.fused_block_fwd_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd", _widths(c, h))
    for fn in (lib.fused_block_bwd_bf16, lib.fused_block_bwd_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_block_bwd_sizes.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_block_bwd_sizes.restype = None
    lib.fused_block_bwd_smem_bytes.argtypes = []
    lib.fused_block_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_block_bwd_bf16_wgmma.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.fused_block_bwd_bf16_wgmma.restype = ctypes.c_int
    lib.fused_block_bwd_wgmma_plan.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_block_bwd_wgmma_plan.restype = None
    return lib


def library_plan(c: int, h: int) -> dict:
    """The Hopper route's shared memory a block (K7, K8's rows launches, its
    wgrad), wgrad tiles a row chunk and K8's pointer count, as the two
    libraries built for (c, h) compute them (zeros where that width takes
    the CUDA-core route)."""
    out = (ctypes.c_longlong * 4)()
    _bwd_lib(c, h).fused_block_bwd_wgmma_plan(out)
    return {"fwd_smem": _fwd_lib(c, h).fused_block_fwd_wgmma_smem_bytes(),
            "rows_smem": out[1], "wgrad_smem": out[2], "wgrad_tiles": out[3],
            "pointers": out[0]}


def _check_cuda_args(name, q, k, v, y, params, extra=()):
    """What K7/K8 take: q, k, v [B, N, D] and y [B, N, N, D] in one stream
    dtype (bf16 or f32), D a multiple of 128, H a multiple of 128 (K8's
    tiles), the parameters on the same device with the JAX shapes."""
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or f32, got {dt}")
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [B, N, D], got {tuple(q.shape)}")
    b, n, d = q.shape
    hid = params[6].shape[-1]
    if not uses_kernel(d, "cuda"):
        raise ValueError(f"{name} kernel: D={d} is routed to the oracle by the JAX "
                         "rule (uses_kernel)")
    if hid % 128:
        raise ValueError(f"{name} kernel takes an MLP hidden that is a multiple of "
                         f"128, got {hid}")
    for label, t, shape in (("k", k, (b, n, d)), ("v", v, (b, n, d)),
                            ("y", y, (b, n, n, d)), *extra):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{label} is {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"expected {shape} {dt} {q.device}")
    shapes = ((d, d), (d,), (d, d), (d,), (d,), (d,), (d, hid), (hid,), (hid, d),
              (d,), (d,), (d,))
    for label, t, shape in zip(PARAM_NAMES, params, shapes):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{label} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {q.device}")


def fused_block_fwd(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6,
                    heads: int):
    """K7: ``(y_out, node_agg)`` like :func:`fused_block_fwd_reference`.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``fused_block_fwd.launches``) or raises."""
    params = (we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6)
    if q.device.type == "cpu":
        return fused_block_fwd_reference(q, k, v, y, *params, heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_block_fwd runs on cpu or cuda, not {q.device}")
    _check_cuda_args("fused_block_fwd", q, k, v, y, params)
    b, n, d = q.shape
    hid = w1.shape[-1]
    dt, f32 = q.dtype, torch.float32
    lib = _fwd_lib(d, hid)
    index = _device_index(q)
    plan = launch_plan(d, hid, b, n, num_sms(index))
    if dt == torch.bfloat16 and plan.hopper:
        return _fwd_hopper(lib, plan, q, k, v, y, params, heads, index)
    if lib.fused_block_fwd_smem_bytes(n, int(dt == torch.bfloat16)) > SMEM_LIMIT:
        raise ValueError(f"fused_block_fwd kernel at N={n}, D={d} needs more than "
                         f"{SMEM_LIMIT:,} B of shared memory")
    q, k, v, y = (a.contiguous() for a in (q, k, v, y))
    we_r = we.to(dt).to(f32).contiguous()
    woe_r = woe.to(dt).to(f32).contiguous()
    w1t, w2t = padded_weights(w1, w2, dt)
    vecs = [p.to(f32).contiguous() for p in (be, boe, g4, b4, b1, b2, g6, b6)]
    be_, boe_, g4_, b4_, b1_, b2_, g6_, b6_ = vecs
    y_out = torch.empty_like(y)
    node = torch.empty_like(q)
    fn = lib.fused_block_fwd_bf16 if dt == torch.bfloat16 else lib.fused_block_fwd_f32
    with torch.cuda.device(index):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), we_r.data_ptr(),
                 be_.data_ptr(), woe_r.data_ptr(), boe_.data_ptr(), g4_.data_ptr(),
                 b4_.data_ptr(), w1t.data_ptr(), b1_.data_ptr(), w2t.data_ptr(),
                 b2_.data_ptr(), g6_.data_ptr(), b6_.data_ptr(), y_out.data_ptr(),
                 node.data_ptr(), b, n, d, hid, 1.0 / math.sqrt(d // heads),
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed: CUDA error {err}")
    fused_block_fwd.launches += 1
    return y_out, node


fused_block_fwd.launches = 0


def _square_t(w):
    """W^T [out, in] in bf16: the layout the Hopper kernels stage."""
    return w.t().to(torch.bfloat16).contiguous()


def _f32_vecs(*vecs):
    return [p.to(torch.float32).contiguous() for p in vecs]


def _fwd_hopper(lib, plan, q, k, v, y, params, heads, index):
    we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6 = params
    b, n, d = q.shape
    hid = w1.shape[-1]
    q, k, v, y = (a.contiguous() for a in (q, k, v, y))
    we_t, woe_t = _square_t(we), _square_t(woe)
    w1t, w2t = padded_weights(w1, w2, torch.bfloat16, HIDDEN_CHUNK)
    be_, boe_, g4_, b4_, b1_, b2_, g6_, b6_ = _f32_vecs(be, boe, g4, b4, b1, b2, g6, b6)
    y_out = torch.empty_like(y)
    node = torch.empty_like(q)
    with torch.cuda.device(index):
        err = lib.fused_block_fwd_bf16_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), we_t.data_ptr(),
            be_.data_ptr(), woe_t.data_ptr(), boe_.data_ptr(), g4_.data_ptr(), b4_.data_ptr(),
            w1t.data_ptr(), b1_.data_ptr(), w2t.data_ptr(), b2_.data_ptr(), g6_.data_ptr(),
            b6_.data_ptr(), y_out.data_ptr(), node.data_ptr(), b, n, d, hid,
            1.0 / math.sqrt(d // heads), plan.grid, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed: CUDA error {err}")
    fused_block_fwd.launches += 1
    return y_out, node


def _bwd_hopper(lib, plan, q, k, v, y, params, gy, gn, heads, index):
    we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6 = params
    b, n, d = q.shape
    hid = w1.shape[-1]
    dev, f32 = q.device, torch.float32
    q, k, v, y, gy, gn = (a.contiguous() for a in (q, k, v, y, gy, gn))
    w1t, w2t = padded_weights(w1, w2, torch.bfloat16, HIDDEN_CHUNK)
    rows = plan.rows

    def f32_buf(*shape):
        return torch.empty(*shape, dtype=f32, device=dev)

    keep = [q, k, v, y, gy, gn, _square_t(we), _square_t(woe), w1t, w2t,
            *_f32_vecs(be, boe, g4, b4, b1, b2, g6, b6)]
    # t, xhat4, dr, dtt, de, dp [R, C]; h, dhpre [R, H]; the softmax's max,
    # 1 / sum and sum_j (gn v_j) s [B N, C]; LN4's 1 / std [R]; the ReLU mask,
    # a 32-bit word a thread and hidden chunk
    scratch = ([f32_buf(rows, d) for _ in range(6)] + [f32_buf(rows, hid) for _ in range(2)]
               + [f32_buf(plan.slabs, d) for _ in range(3)] + [f32_buf(rows)]
               + [torch.empty(plan.slabs * (hid // HIDDEN_CHUNK) * 128, dtype=torch.int32,
                              device=dev)])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dy = torch.empty_like(y)
    n_grads = 2 * d * d + 2 * d * hid + 7 * d + hid
    # the rows pass's LayerNorm sums, the wgrad pass's column sums, the
    # weight partials, the gradients
    tail = [f32_buf(plan.vec_partials, 4 * d), f32_buf(plan.chunks, 3 * d + hid),
            f32_buf(plan.chunks * (2 * d * d + 2 * d * hid)), f32_buf(n_grads)]
    ptrs = keep + scratch + [dq, dk, dv, dy] + tail
    n_ptrs = library_plan(d, hid)["pointers"]
    if len(ptrs) != n_ptrs:
        raise RuntimeError(f"fused_block_bwd: {len(ptrs)} pointers, the library takes {n_ptrs}")
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    with torch.cuda.device(index):
        err = lib.fused_block_bwd_bf16_wgmma(
            ctypes.cast(arr, ctypes.c_void_p), b, n, d, hid, 1.0 / math.sqrt(d // heads),
            plan.grid, plan.chunks, plan.chunk_rows, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_bwd kernel launch failed: CUDA error {err}")
    fused_block_bwd.launches += 1
    return dq, dk, dv, dy, tail[3]


def fused_block_bwd(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6,
                    gy, gn, heads: int):
    """K8: the 16 gradients of :func:`fused_block_bwd_reference` for the
    cotangents ``gy`` (of y_out, y's dtype) and ``gn`` (of node_agg, q's
    dtype).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (counted in ``fused_block_bwd.launches``) or raises."""
    params = (we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6)
    if q.device.type == "cpu":
        return fused_block_bwd_reference(q, k, v, y, *params, gy, gn, heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_block_bwd runs on cpu or cuda, not {q.device}")
    b, n, d = q.shape
    _check_cuda_args("fused_block_bwd", q, k, v, y, params,
                     (("gy", gy, (b, n, n, d)), ("gn", gn, (b, n, d))))
    hid = w1.shape[-1]
    dt, f32, dev = q.dtype, torch.float32, q.device
    index = _device_index(q)
    lib = _bwd_lib(d, hid)
    shapes = ((d, d), (d,), (d, d), (d,), (d,), (d,), (d, hid), (hid,), (hid, d),
              (d,), (d,), (d,))

    def param_grads(grads):
        split = torch.split(grads, [math.prod(s_) for s_ in shapes])
        return tuple(g_.view(s_).to(p.dtype) for g_, s_, p in zip(split, shapes, params))

    plan = launch_plan(d, hid, b, n, num_sms(index))
    if dt == torch.bfloat16 and plan.hopper:
        dq, dk, dv, dy, grads = _bwd_hopper(lib, plan, q, k, v, y, params, gy, gn, heads, index)
        return (dq, dk, dv, dy, *param_grads(grads))
    if lib.fused_block_bwd_smem_bytes() > SMEM_LIMIT:
        raise ValueError(f"fused_block_bwd kernel at D={d} needs more than "
                         f"{SMEM_LIMIT:,} B of shared memory")
    sizes = (ctypes.c_longlong * 5)()
    lib.fused_block_bwd_sizes(sizes)
    n_ptrs, n_vec, n_grads, slab, tiles = sizes
    q, k, v, y, gy, gn = (a.contiguous() for a in (q, k, v, y, gy, gn))
    w = {name: p.to(dt).to(f32) for name, p in zip(("we", "woe", "w1", "w2"),
                                                   (we, woe, w1, w2))}
    rows = b * n * n
    # split-K over rows for the weight gradients: about four blocks a
    # streaming multiprocessor over all output tiles
    chunks = max(1, min(-(-rows // slab), (4 * num_sms(index)) // tiles))
    chunk_rows = -(-rows // chunks)
    chunk_rows = -(-chunk_rows // slab) * slab

    def f32_buf(*shape):
        return torch.empty(*shape, dtype=f32, device=dev)

    keep = [q, k, v, y, gy, gn,
            w["we"].contiguous(), be.to(f32).contiguous(), w["woe"].contiguous(),
            boe.to(f32).contiguous(), g4.to(f32).contiguous(), b4.to(f32).contiguous(),
            w["w1"].contiguous(), b1.to(f32).contiguous(), w["w2"].contiguous(),
            b2.to(f32).contiguous(), g6.to(f32).contiguous(), b6.to(f32).contiguous(),
            w["we"].t().contiguous(), w["woe"].t().contiguous(), w["w1"].t().contiguous(),
            w["w2"].t().contiguous()]
    scratch = [f32_buf(rows, d), f32_buf(rows, d), f32_buf(rows, d), f32_buf(rows, d),
               f32_buf(rows), f32_buf(rows, hid), f32_buf(rows, d), f32_buf(rows, hid),
               f32_buf(rows, d), f32_buf(rows, d), f32_buf(b, n, d), f32_buf(b, n, d)]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dy = torch.empty_like(y)
    vec_partial = f32_buf(b * 8, n_vec)
    w_partial = f32_buf(chunks * (2 * d * d + 2 * d * hid))
    grads = f32_buf(n_grads)
    ptrs = keep + scratch + [dq, dk, dv, dy, vec_partial, w_partial, grads]
    if len(ptrs) != n_ptrs:
        raise RuntimeError(f"fused_block_bwd: {len(ptrs)} pointers, the library takes {n_ptrs}")
    arr = (ctypes.c_void_p * n_ptrs)(*[t.data_ptr() for t in ptrs])
    fn = lib.fused_block_bwd_bf16 if dt == torch.bfloat16 else lib.fused_block_bwd_f32
    with torch.cuda.device(index):
        err = fn(ctypes.cast(arr, ctypes.c_void_p), b, n, d, hid,
                 1.0 / math.sqrt(d // heads), chunks, chunk_rows,
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_bwd kernel launch failed: CUDA error {err}")
    fused_block_bwd.launches += 1
    return (dq, dk, dv, dy, *param_grads(grads))


fused_block_bwd.launches = 0


class FusedBlock(torch.autograd.Function):
    """K7 forward, K8 backward (the JAX ``custom_vjp`` of
    ``_fused_block_op``).

    ``apply(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6,
    heads)`` -> ``(y_out, node_agg)``.  Saves only the inputs; the backward
    recomputes the forward from ``y``.  First-order only: a second
    derivative through it raises."""

    @staticmethod
    def forward(ctx, q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6, heads):
        ctx.save_for_backward(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6)
        ctx.heads = heads
        return fused_block_fwd(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2,
                               g6, b6, heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gn):
        saved = ctx.saved_tensors
        q, y = saved[0], saved[3]
        grads = fused_block_bwd(*saved, gy.to(y.dtype), gn.to(q.dtype), ctx.heads)
        return (*grads, None)


def fused_block_edge_stream(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2,
                            g6, b6, *, heads: int):
    """The fused edge stream of one encoder block (module docstring), JAX
    ``fused_block_edge_stream``: q, k, v ``[B, N, D]``, y ``[B, N, N, D]``
    -> ``(y_out [B, N, N, D], node_agg [B, N, D])``.  Weights [in, out].
    K7/K8 (their plain versions on the CPU) where :func:`uses_kernel` sends
    the shape; the oracle elsewhere."""
    if not uses_kernel(q.shape[-1], q.device.type):
        return block_edge_stream_reference(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1,
                                           w2, b2, g6, b6, heads)
    return FusedBlock.apply(q, k, v, y, we, be, woe, boe, g4, b4, w1, b1, w2, b2, g6, b6,
                            heads)

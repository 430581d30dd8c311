"""Edge-modulated attention with the edge projections fused, K5 and K6.

Port of the projection-fused (v3) half of ``druggen_tpu/ops/fused_attention.py``.
The Generator's attention (``models/layers.py`` :class:`GraphMHA`) computes,
per graph, query atom i, key atom j and channel c (heads x dk):

    e        = edge_raw @ We + be
    t        = q_i * k_j / sqrt(dk) * (e + 1) * e
    edge_out = t @ Woe + boe                     (read BEFORE the softmax)
    node_agg = sum_j softmax_j(t) * v_j          (per channel)

:func:`edge_modulated_attention_proj` runs it in one kernel when the JAX
package's routing rule sends the shape there (the channel width a multiple
of 128 and the per-graph block within 10 MiB of the TPU's VMEM: JAX
``edge_modulated_attention_proj`` :448-466, ``_vmem_estimate_bytes``
:182-184, copied); any other shape takes :func:`reference_attention_proj`,
as in JAX.  That rule is the JAX package's own routing, the same on the CPU
and on the card.

The kernels are ``csrc/fused_attention.cu`` (K5, the Pallas
``_fwd3_kernel``) and ``csrc/fused_attention_bwd.cu`` (K6, ``_bwd3_kernel``),
hand-written CUDA for sm_90a; their headers state what bounds them.  Two
routes on the card (:func:`hopper_route`, the shape rule): bf16 at D = 128
with 1 <= N <= 64 (the ``use_pallas`` training path) runs the Hopper kernels
of ``csrc/attn_hopper.cuh`` (every product on ``wgmma``; We and Woe as three
bf16 pieces each, an f32 left operand as three pieces in registers, so each
product term is exact; geometry in :func:`launch_plan`); f32, any other D
and N > 64 run the CUDA-core (FFMA) kernels in the same sources.
Rounding points, as in the Pallas kernels: q, k, v and edge_raw are widened
from the stream dtype to f32; We, be, Woe, boe are the f32 parameters; both
projections are f32 x f32 products with f32 sums; ``edge_out`` and the
softmax use the f32 ``t``, which is rounded to the stream dtype only for the
residual; the backward recomputes ``e`` and the softmax from that rounded
``t``.  Outputs are in the stream dtype, weight gradients in f32.

:class:`EdgeAttentionProj` is the ``torch.autograd.Function`` (JAX
``_make_proj_op``'s ``custom_vjp``): K5 forward, K6 backward, first-order
only.  A CPU tensor takes the plain versions in both directions; a CUDA
tensor launches the kernel or raises.

The v2 op, :func:`edge_modulated_attention` (JAX :187-208), is the same
chain without the two projections: q, k, v [B, N, H, dk] and e
[B, N, N, H, dk] in, ``(edge_pre, node_agg)`` out.  Its kernels are K3
(``csrc/fused_attention_v2.cu``, the Pallas ``_fwd_kernel``) and K4
(``csrc/fused_attention_v2_bwd.cu``, ``_bwd_kernel``), under
:class:`EdgeAttention` (JAX ``_make_op``'s ``custom_vjp``).  Rounding
points: q, k, v and e are widened to f32, everything is f32, and the outputs
are rounded to the stream dtype.  Its routing rule is JAX's: the kernel at
``d % 128 == 0`` with the per-graph estimate within 12 MiB (v3's is 10).
Every shape the rule admits takes one kernel a direction, one launch a call
(``csrc/attn_v2.cuh``: a work item is one graph and 128 channels, 64 above
N 64; its query rows' edge slices stream by TMA through a ring of
shared-memory slots that a producer warp keeps full; geometry in
:func:`v2_launch_plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from druggen_tpu_torch.ops import _build
from druggen_tpu_torch.ops.fused_mlp import SMEM_LIMIT, num_sms


# ---------------------------------------------------------------- the rule

def _vmem_estimate_bytes(n: int, d: int, itemsize: int) -> int:
    """Copied from ``druggen_tpu/ops/fused_attention.py::_vmem_estimate_bytes``."""
    # e block + f32 working copy + t + outputs + vectors, with slack
    return n * n * d * (itemsize + 4 + itemsize) + 8 * n * d * 4


def uses_kernel(n: int, d: int, dtype) -> bool:
    """The JAX routing rule (``edge_modulated_attention_proj`` :461-463):
    the fused op runs at ``d % 128 == 0`` with the per-graph block estimate
    within 10 MiB; anything else takes the plain composite."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return d % 128 == 0 and _vmem_estimate_bytes(n, d, itemsize) <= 10 * 2 ** 20


def uses_v2_kernel(n: int, d: int, dtype) -> bool:
    """The JAX routing rule of the v2 op (``edge_modulated_attention``
    :201-203): K3/K4 at ``d % 128 == 0`` with the per-graph block estimate
    within 12 MiB; anything else takes :func:`reference_attention`."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return d % 128 == 0 and _vmem_estimate_bytes(n, d, itemsize) <= 12 * 2 ** 20


# ---------------------------------------------------------------- launch plan

# The Hopper route's geometry (csrc/attn_hopper.cuh and fused_attention_bwd.cu
# hold the same constants; their shared memory is the libraries' own:
# library_plan).
HOPPER_D = 128          # the channel width the Hopper kernels are built for
TILE_ROWS = 64          # rows a slab tile (one warpgroup); N at most this
WGRAD_ROWS = 64         # rows a wgrad stage
PAIR_THREADS = 256      # threads a block of K6's stats and node passes
WARPGROUPS = 2          # warpgroups a block of K5 and K6's rows pass, a tile each


def hopper_route(n: int, d: int, dtype) -> bool:
    """The shape rule of K5/K6 on the card: bf16 at D = 128 with 1 <= N <= 64
    takes the Hopper kernels; f32, any other D and N > 64 take the CUDA-core
    kernels.  (The JAX rule, :func:`uses_kernel`, decides before this whether
    the fused op runs at all.)"""
    return dtype == torch.bfloat16 and d == HOPPER_D and 1 <= n <= TILE_ROWS


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Launch geometry and scratch of the Hopper K5 and K6 for ``batch``
    graphs of ``n`` atoms at D = ``d`` on ``num_sms`` SMs."""
    d: int
    batch: int
    n: int
    hopper: bool            # the shape takes the Hopper kernels (in bf16)
    slabs: int              # (b, i) slabs, one 64-row tile each
    rows: int               # edge rows, batch * n * n
    tile_rows: int
    grid: int               # persistent blocks of K5 and of K6's rows pass
    warpgroups: int         # their warpgroups a block, taking its slabs in turn
    pair_threads: int       # K6's stats and node passes: a thread a (slab or
    pair_blocks: int        # (b, j), column pair)
    wgrad_tiles: int        # wgrad blocks a row chunk: dWe and dWoe, D x D each
    chunks: int             # wgrad row chunks (split K)
    chunk_rows: int
    scratch_bytes: int      # all of K6's device scratch

    @property
    def pad_share(self) -> float:
        """Share of the tiles' rows that are padding past N."""
        return 1.0 - self.n / self.tile_rows if self.hopper else 0.0

    def slab_range(self, block: int) -> tuple:
        """The contiguous run of slabs ``[begin, end)`` that persistent block
        ``block`` owns (the kernels' ``SlabRange``)."""
        return (self.slabs * block // self.grid, self.slabs * (block + 1) // self.grid)

    def warpgroup_slabs(self, block: int, warpgroup: int) -> range:
        """The slabs that warpgroup ``warpgroup`` of block ``block`` takes:
        every ``warpgroups``-th of the block's run, from its
        ``warpgroup``-th."""
        begin, end = self.slab_range(block)
        return range(begin + warpgroup, end, self.warpgroups)

    def tile_rows_of(self, slab: int) -> tuple:
        """The edge rows ``[first, first + n)`` of slab ``slab``'s 64-row
        tile that are valid (the tile's other rows are padding)."""
        return (slab * self.n, slab * self.n + self.n)

    def graph_of(self, slab: int) -> int:
        """The graph b of slab (b, i)."""
        return slab // self.n

    def pair_item(self, thread: int) -> tuple:
        """``(b, atom, first column)`` of thread ``thread`` of K6's stats
        pass (the slab (b, atom)'s softmax statistics of a column pair) and
        of its node pass (the dk/dv column pair of key atom j = atom, summed
        over the graph's query atoms)."""
        c2 = self.d // 2
        bj, pair = divmod(thread, c2)
        b, j = divmod(bj, self.n)
        return b, j, 2 * pair

    def wgrad_tile(self, tile: int) -> tuple:
        """``(gradient, first column)`` of wgrad block ``tile`` of a row
        chunk: dWe or dWoe, each one D x D tile (the kernel's ``z``)."""
        if 0 <= tile < self.wgrad_tiles:
            return ("dwe", "dwoe")[tile], 0
        raise IndexError("no such wgrad tile")

    def chunk_rows_of(self, chunk: int) -> tuple:
        """The edge rows ``[first, end)`` of wgrad row chunk ``chunk``."""
        first = chunk * self.chunk_rows
        return (min(first, self.rows), min(first + self.chunk_rows, self.rows))


# Where K6's Hopper route takes each parameter gradient from (the reduce
# launch sums each over its partials in a fixed order).
GRADIENT_SOURCES = {"dwe": "wgrad", "dbe": "wgrad column sums of de",
                    "dwoe": "wgrad", "dboe": "wgrad column sums of ge"}


def launch_plan(d: int, batch: int, n: int, num_sms: int) -> LaunchPlan:
    """The bf16 K5/K6 geometry (``csrc/attn_hopper.cuh`` explains it): the
    Hopper route where D is 128 and 1 <= N <= 64; a persistent block per SM,
    each a contiguous run of slabs, taken in turn by its two warpgroups (K5
    and K6's rows pass); K6's stats and node passes a thread per (slab or
    (b, j), column pair); its wgrad two blocks (dWe, dWoe) a row chunk over
    row chunks that cover the rows exactly, about four blocks a SM; K6's
    scratch: de and dbase [R, D] f32, the slabs' softmax max, 1 / sum and
    dot [B N, D], the partials and the gradients."""
    if d <= 0 or batch < 0 or n <= 0:
        raise ValueError(f"K5/K6 take D, N > 0 and batch >= 0, got D {d}, batch {batch}, N {n}")
    hopper = d == HOPPER_D and n <= TILE_ROWS
    slabs, rows = batch * n, batch * n * n
    grid = max(1, min(num_sms, slabs))
    pair_threads = slabs * (d // 2)
    wgrad_tiles = 2
    stages = max(1, -(-rows // WGRAD_ROWS))
    chunks = min(stages, max(1, (4 * num_sms) // wgrad_tiles))
    per_chunk = -(-rows // chunks)
    chunk_rows = -(-per_chunk // WGRAD_ROWS) * WGRAD_ROWS if rows else WGRAD_ROWS
    chunks = max(1, -(-rows // chunk_rows))
    scratch = (2 * rows * d + 3 * slabs * d + chunks * (2 * d * d + 2 * d)
               + 2 * d * d + 2 * d) * 4
    return LaunchPlan(
        d=d, batch=batch, n=n, hopper=hopper, slabs=slabs, rows=rows, tile_rows=TILE_ROWS,
        grid=grid, warpgroups=WARPGROUPS, pair_threads=pair_threads,
        pair_blocks=-(-pair_threads // PAIR_THREADS), wgrad_tiles=wgrad_tiles, chunks=chunks,
        chunk_rows=chunk_rows, scratch_bytes=scratch)


# ---------------------------------------------------------------- plain math

def reference_attention(q, k, v, e):
    """Port of JAX ``reference_attention`` (:40-50): q, k, v [B, N, H, dk],
    e [B, N, N, H, dk] -> (edge_pre [B, N, N, D], node_agg [B, N, D]);
    differentiable to any order."""
    b, n, h, dk = q.shape
    d = h * dk
    attn = q[:, :, None] * k[:, None, :, :, :]
    attn = attn / math.sqrt(dk)
    attn = attn * (e + 1.0) * e
    edge_pre = attn.reshape(b, n, n, d)
    s = torch.softmax(attn, dim=2)
    node_agg = (s * v[:, None, :, :, :]).sum(dim=2).reshape(b, n, d)
    return edge_pre, node_agg


def _matmul(x, w):
    # jnp's promotion: a bf16 stream times an f32 weight is an f32 product
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def reference_attention_proj(q, k, v, edge_raw, we, be, woe, boe):
    """Port of JAX ``reference_attention_proj`` (:438-445), with jnp's type
    promotion (a bf16 stream against the f32 weights computes in f32)."""
    b, n, h, dk = q.shape
    d = h * dk
    e = _matmul(edge_raw.reshape(b, n, n, d), we) + be
    ep, na = reference_attention(q, k, v, e.reshape(b, n, n, h, dk))
    edge_out = _matmul(ep, woe) + boe
    return edge_out, na


def _softmax_keys(t):
    # the Pallas kernels' softmax over the keys (axis 2), f32
    ex = torch.exp(t - t.amax(dim=2, keepdim=True))
    return ex / ex.sum(dim=2, keepdim=True)


def edge_attention_v2_fwd_reference(q3, k3, v3, e4, heads: int):
    """Plain PyTorch version of K3 (the Pallas ``_fwd_kernel``): q3, k3, v3
    [B, N, D], e4 [B, N, N, D] widened to f32; returns ``(edge_pre, node_agg)``
    rounded to q3's dtype."""
    f32, dt = torch.float32, q3.dtype
    inv = 1.0 / math.sqrt(q3.shape[-1] // heads)
    q, k, v, e = (x.to(f32) for x in (q3, k3, v3, e4))
    t = (q[:, :, None] * k[:, None]) * inv
    t = t * (e + 1.0) * e
    node = (_softmax_keys(t) * v[:, None]).sum(dim=2)
    return t.to(dt), node.to(dt)


def edge_attention_v2_bwd_reference(q3, k3, v3, e4, ge, gn, heads: int):
    """Plain PyTorch version of K4 (the Pallas ``_bwd_kernel``): recomputes
    t and the softmax in f32 and returns ``(dq, dk, dv, de)`` rounded to
    q3's dtype."""
    f32, dt = torch.float32, q3.dtype
    inv = 1.0 / math.sqrt(q3.shape[-1] // heads)
    q, k, v, e, g_e, g_n = (x.to(f32) for x in (q3, k3, v3, e4, ge, gn))
    base = (q[:, :, None] * k[:, None]) * inv
    mod = (e + 1.0) * e
    s = _softmax_keys(base * mod)
    ds_in = g_n[:, :, None] * v[:, None]
    dot = (s * ds_in).sum(dim=2, keepdim=True)
    dt_ = g_e + s * (ds_in - dot)
    dbase = dt_ * mod
    de = dt_ * base * (2.0 * e + 1.0)
    dq = (dbase * k[:, None]).sum(dim=2) * inv
    dk = (dbase * q[:, :, None]).sum(dim=1) * inv
    dv = (s * g_n[:, :, None]).sum(dim=1)
    return dq.to(dt), dk.to(dt), dv.to(dt), de.to(dt)


def edge_attention_fwd_reference(q3, k3, v3, eraw, we, be, woe, boe, heads: int):
    """Plain PyTorch version of K5 (the Pallas ``_fwd3_kernel``), with its
    rounding points.  q3, k3, v3 [B, N, D]; eraw [B, N, N, D]; we, woe
    [D, D] ([in, out]); be, boe [D].  Returns ``(edge_out, node_agg, t)`` in
    q3's dtype."""
    b, n, d = q3.shape
    f32, dt = torch.float32, q3.dtype
    inv = 1.0 / math.sqrt(d // heads)
    q, k, v = q3.to(f32), k3.to(f32), v3.to(f32)
    e = (eraw.to(f32).reshape(-1, d) @ we.to(f32) + be.to(f32)).reshape(b, n, n, d)
    t = (q[:, :, None] * k[:, None]) * inv
    t = t * (e + 1.0) * e
    edge_out = (t.reshape(-1, d) @ woe.to(f32) + boe.to(f32)).reshape(b, n, n, d)
    node = (_softmax_keys(t) * v[:, None]).sum(dim=2)
    return edge_out.to(dt), node.to(dt), t.to(dt)


def edge_attention_bwd_reference(q3, k3, v3, eraw, we, be, woe, t_res, ge, gn,
                                 heads: int):
    """Plain PyTorch version of K6 (the Pallas ``_bwd3_kernel``), with its
    rounding points: ``e`` recomputed in f32, the softmax from the rounded
    ``t_res``.  Returns ``(dq, dk, dv, d_eraw, dwe, dbe, dwoe, dboe)``: the
    first four in q3's dtype, the weight gradients in f32 ([in, out])."""
    b, n, d = q3.shape
    f32, dt = torch.float32, q3.dtype
    inv = 1.0 / math.sqrt(d // heads)
    q, k, v = q3.to(f32), k3.to(f32), v3.to(f32)
    er = eraw.to(f32).reshape(-1, d)
    we32 = we.to(f32)
    e = (er @ we32 + be.to(f32)).reshape(b, n, n, d)
    t = t_res.to(f32)
    s = _softmax_keys(t)
    g_e = ge.to(f32).reshape(-1, d)
    g_n = gn.to(f32)
    dwoe = t.reshape(-1, d).t() @ g_e
    dboe = g_e.sum(0)
    dtt = (g_e @ woe.to(f32).t()).reshape(b, n, n, d)
    ds_in = g_n[:, :, None] * v[:, None]
    dot = (s * ds_in).sum(dim=2, keepdim=True)
    dtt = dtt + s * (ds_in - dot)
    base = (q[:, :, None] * k[:, None]) * inv
    dbase = dtt * ((e + 1.0) * e)
    de = dtt * base * (2.0 * e + 1.0)
    de2 = de.reshape(-1, d)
    dwe = er.t() @ de2
    dbe = de2.sum(0)
    d_eraw = (de2 @ we32.t()).reshape(b, n, n, d)
    dq = (dbase * k[:, None]).sum(dim=2) * inv
    dk = (dbase * q[:, :, None]).sum(dim=1) * inv
    dv = (s * g_n[:, :, None]).sum(dim=1)
    return (dq.to(dt), dk.to(dt), dv.to(dt), d_eraw.to(dt), dwe, dbe, dwoe, dboe)


# ---------------------------------------------------------------- kernels

@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention")
    for fn in (lib.edge_attention_fwd_bf16, lib.edge_attention_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 11
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.edge_attention_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.edge_attention_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.edge_attention_fwd_bf16_wgmma.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    lib.edge_attention_fwd_bf16_wgmma.restype = ctypes.c_int
    lib.edge_attention_fwd_wgmma_smem_bytes.argtypes = []
    lib.edge_attention_fwd_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_bwd")
    for fn in (lib.edge_attention_bwd_bf16, lib.edge_attention_bwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 19
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.edge_attention_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.edge_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.edge_attention_bwd_slab_rows.argtypes = []
    lib.edge_attention_bwd_slab_rows.restype = ctypes.c_int
    lib.edge_attention_bwd_bf16_wgmma.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.edge_attention_bwd_bf16_wgmma.restype = ctypes.c_int
    lib.edge_attention_bwd_wgmma_plan.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.edge_attention_bwd_wgmma_plan.restype = None
    return lib


def library_plan() -> dict:
    """The Hopper route's shared memory a block (K5, K6's rows pass, its
    wgrad), wgrad tiles a row chunk, rows a wgrad stage and K6's pointer
    count, as the two libraries compute them."""
    out = (ctypes.c_longlong * 5)()
    _bwd_lib().edge_attention_bwd_wgmma_plan(out)
    return {"fwd_smem": _fwd_lib().edge_attention_fwd_wgmma_smem_bytes(),
            "rows_smem": out[1], "wgrad_smem": out[2], "wgrad_tiles": out[3],
            "wgrad_rows": out[4], "pointers": out[0]}


def _device_index(t) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check_cuda_args(name, q3, k3, v3, eraw, f32_params, stream_extra=(), rule=uses_kernel):
    dt = q3.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or f32, got {dt}")
    b, n, d = q3.shape
    if not rule(n, d, dt):
        raise ValueError(f"{name} kernel: N={n}, D={d}, {dt} is routed to the "
                         f"plain composite by the JAX rule ({rule.__name__})")
    for label, t, shape in (("k3", k3, (b, n, d)), ("v3", v3, (b, n, d)),
                            ("eraw", eraw, (b, n, n, d)), *stream_extra):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q3.device:
            raise ValueError(f"{label} is {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"expected {shape} {dt} {q3.device}")
    for label, t, shape in f32_params:
        if tuple(t.shape) != shape or t.device != q3.device:
            raise ValueError(f"{label} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {q3.device}")


def edge_attention_fwd(q3, k3, v3, eraw, we, be, woe, boe, heads: int):
    """K5: ``(edge_out, node_agg, t)`` like
    :func:`edge_attention_fwd_reference`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``edge_attention_fwd.launches``; the Hopper kernel where
    :func:`hopper_route` sends the shape) or raises."""
    if q3.device.type == "cpu":
        return edge_attention_fwd_reference(q3, k3, v3, eraw, we, be, woe, boe, heads)
    if q3.device.type != "cuda":
        raise ValueError(f"edge_attention_fwd runs on cpu or cuda, not {q3.device}")
    b, n, d = q3.shape
    _check_cuda_args("edge_attention_fwd", q3, k3, v3, eraw,
                     (("we", we, (d, d)), ("be", be, (d,)), ("woe", woe, (d, d)),
                      ("boe", boe, (d,))))
    q3, k3, v3, eraw = (x.contiguous() for x in (q3, k3, v3, eraw))
    we, be, woe, boe = (p.to(torch.float32).contiguous() for p in (we, be, woe, boe))
    edge_out = torch.empty_like(eraw)
    t = torch.empty_like(eraw)
    node = torch.empty_like(q3)
    index = _device_index(q3)
    lib = _fwd_lib()
    ptrs = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), eraw.data_ptr(), we.data_ptr(),
            be.data_ptr(), woe.data_ptr(), boe.data_ptr(), edge_out.data_ptr(),
            node.data_ptr(), t.data_ptr())
    inv = 1.0 / math.sqrt(d // heads)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        if hopper_route(n, d, q3.dtype):
            plan = launch_plan(d, b, n, num_sms(index))
            err = lib.edge_attention_fwd_bf16_wgmma(*ptrs, b, n, d, inv, plan.grid, stream)
        else:
            if lib.edge_attention_fwd_smem_bytes(n, d) > SMEM_LIMIT:
                raise ValueError(f"edge_attention_fwd kernel at N={n}, D={d} needs more "
                                 f"than {SMEM_LIMIT:,} B of shared memory")
            fn = (lib.edge_attention_fwd_bf16 if q3.dtype == torch.bfloat16
                  else lib.edge_attention_fwd_f32)
            err = fn(*ptrs, b, n, d, inv, stream)
    if err != 0:
        raise RuntimeError(f"edge_attention_fwd kernel launch failed: CUDA error {err}")
    edge_attention_fwd.launches += 1
    return edge_out, node, t


edge_attention_fwd.launches = 0


def _bwd_hopper(lib, plan, q3, k3, v3, eraw, we, be, woe, t_res, ge, gn, heads, index):
    b, n, d = q3.shape
    f32, dev = torch.float32, q3.device

    def f32_buf(*shape):
        return torch.empty(*shape, dtype=f32, device=dev)

    dq, dk, dv = torch.empty_like(q3), torch.empty_like(q3), torch.empty_like(q3)
    d_eraw = torch.empty_like(eraw)
    grads = f32_buf(2 * d * d + 2 * d)
    # inputs; de, dbase [R, D]; the slabs' softmax max, 1 / sum and dot;
    # outputs; the weight and column-sum partials; the gradients
    ptrs = [q3, k3, v3, gn, eraw, t_res, ge,
            *(p.to(f32).contiguous() for p in (we, woe, be)),
            f32_buf(plan.rows, d), f32_buf(plan.rows, d),
            *(f32_buf(plan.slabs, d) for _ in range(3)), dq, dk, dv, d_eraw,
            f32_buf(2, plan.chunks, d * d), f32_buf(plan.chunks, 2 * d), grads]
    n_ptrs = library_plan()["pointers"]
    if len(ptrs) != n_ptrs:
        raise RuntimeError(f"edge_attention_bwd: {len(ptrs)} pointers, the library takes {n_ptrs}")
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    with torch.cuda.device(index):
        err = lib.edge_attention_bwd_bf16_wgmma(
            ctypes.cast(arr, ctypes.c_void_p), b, n, d, 1.0 / math.sqrt(d // heads), plan.grid,
            plan.chunks, plan.chunk_rows, torch.cuda.current_stream(index).cuda_stream)
    return err, (dq, dk, dv, d_eraw, grads)


def edge_attention_bwd(q3, k3, v3, eraw, we, be, woe, t_res, ge, gn, heads: int):
    """K6: ``(dq, dk, dv, d_eraw, dwe, dbe, dwoe, dboe)`` like
    :func:`edge_attention_bwd_reference`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``edge_attention_bwd.launches``; the Hopper kernels where
    :func:`hopper_route` sends the shape) or raises."""
    if q3.device.type == "cpu":
        return edge_attention_bwd_reference(q3, k3, v3, eraw, we, be, woe, t_res,
                                            ge, gn, heads)
    if q3.device.type != "cuda":
        raise ValueError(f"edge_attention_bwd runs on cpu or cuda, not {q3.device}")
    b, n, d = q3.shape
    _check_cuda_args("edge_attention_bwd", q3, k3, v3, eraw,
                     (("we", we, (d, d)), ("be", be, (d,)), ("woe", woe, (d, d))),
                     (("t_res", t_res, (b, n, n, d)), ("ge", ge, (b, n, n, d)),
                      ("gn", gn, (b, n, d))))
    q3, k3, v3, eraw, t_res, ge, gn = (x.contiguous() for x in
                                       (q3, k3, v3, eraw, t_res, ge, gn))
    index = _device_index(q3)
    lib = _bwd_lib()
    if hopper_route(n, d, q3.dtype):
        plan = launch_plan(d, b, n, num_sms(index))
        err, (dq, dk, dv, d_eraw, grads) = _bwd_hopper(
            lib, plan, q3, k3, v3, eraw, we, be, woe, t_res, ge, gn, heads, index)
    else:
        err, (dq, dk, dv, d_eraw, grads) = _bwd_cuda_cores(
            lib, q3, k3, v3, eraw, we, be, woe, t_res, ge, gn, heads, index)
    if err != 0:
        raise RuntimeError(f"edge_attention_bwd kernel launch failed: CUDA error {err}")
    edge_attention_bwd.launches += 1
    dwe, dbe, dwoe, dboe = torch.split(grads, [d * d, d, d * d, d])
    return dq, dk, dv, d_eraw, dwe.view(d, d), dbe, dwoe.view(d, d), dboe


def _bwd_cuda_cores(lib, q3, k3, v3, eraw, we, be, woe, t_res, ge, gn, heads, index):
    b, n, d = q3.shape
    f32 = torch.float32
    we32 = we.to(f32).contiguous()
    we_t = we.to(f32).t().contiguous()
    woe_t = woe.to(f32).t().contiguous()
    be32 = be.to(f32).contiguous()
    if lib.edge_attention_bwd_smem_bytes(n) > SMEM_LIMIT:
        raise ValueError(f"edge_attention_bwd kernel at N={n} needs more than "
                         f"{SMEM_LIMIT:,} B of shared memory")
    rows = b * n * n
    slab = lib.edge_attention_bwd_slab_rows()
    tiles = (d // 128) ** 2
    # split-K over rows for the weight gradients: 2 x tiles output tiles x
    # chunks blocks, about two a streaming multiprocessor
    chunks = max(1, min(-(-rows // slab), (2 * num_sms(index)) // (2 * tiles)))
    chunk_rows = -(-rows // chunks)
    chunk_rows = -(-chunk_rows // slab) * slab
    dev = q3.device
    dq, dk, dv = torch.empty_like(q3), torch.empty_like(q3), torch.empty_like(q3)
    d_eraw = torch.empty_like(eraw)
    de_buf = torch.empty(rows, d, dtype=f32, device=dev)
    bias_partial = torch.empty(b, 2, d, dtype=f32, device=dev)
    w_partial = torch.empty(2, chunks, d * d, dtype=f32, device=dev)
    grads = torch.empty(2 * d * d + 2 * d, dtype=f32, device=dev)
    fn = (lib.edge_attention_bwd_bf16 if q3.dtype == torch.bfloat16
          else lib.edge_attention_bwd_f32)
    with torch.cuda.device(index):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), eraw.data_ptr(),
                 we32.data_ptr(), we_t.data_ptr(), be32.data_ptr(), woe_t.data_ptr(),
                 t_res.data_ptr(), ge.data_ptr(), gn.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), d_eraw.data_ptr(), de_buf.data_ptr(),
                 bias_partial.data_ptr(), w_partial.data_ptr(), grads.data_ptr(),
                 b, n, d, 1.0 / math.sqrt(d // heads), chunks, chunk_rows,
                 torch.cuda.current_stream(index).cuda_stream)
    return err, (dq, dk, dv, d_eraw, grads)


edge_attention_bwd.launches = 0


class EdgeAttentionProj(torch.autograd.Function):
    """K5 forward, K6 backward (the JAX ``custom_vjp`` of ``_make_proj_op``).

    ``apply(q3, k3, v3, eraw, we, be, woe, boe, heads)`` -> ``(edge_out,
    node_agg)``.  Saves q3, k3, v3, eraw, we, be, woe and the rounded ``t``;
    first-order only: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, q3, k3, v3, eraw, we, be, woe, boe, heads):
        edge_out, node, t = edge_attention_fwd(q3, k3, v3, eraw, we, be, woe, boe, heads)
        ctx.save_for_backward(q3, k3, v3, eraw, we, be, woe, t)
        ctx.heads = heads
        ctx.boe_dtype = boe.dtype
        return edge_out, node

    @staticmethod
    @once_differentiable
    def backward(ctx, ge, gn):
        q3, k3, v3, eraw, we, be, woe, t = ctx.saved_tensors
        dq, dk, dv, d_eraw, dwe, dbe, dwoe, dboe = edge_attention_bwd(
            q3, k3, v3, eraw, we, be, woe, t, ge.to(q3.dtype), gn.to(q3.dtype), ctx.heads)
        return (dq, dk, dv, d_eraw, dwe.to(we.dtype), dbe.to(be.dtype),
                dwoe.to(woe.dtype), dboe.to(ctx.boe_dtype), None)


def edge_modulated_attention_proj(q, k, v, edge_raw, we, be, woe, boe):
    """Fused edge attention (JAX ``edge_modulated_attention_proj``): q, k, v
    [B, N, H, dk]; edge_raw [B, N, N, D] (the edge stream before the ``e``
    Dense); we/be and woe/boe the ``e`` and ``out_e`` parameters ([in, out]).
    Returns ``(edge_out [B, N, N, D], node_agg [B, N, D])``: K5/K6 where
    :func:`uses_kernel` sends the shape, :func:`reference_attention_proj`
    elsewhere."""
    b, n, h, dk = q.shape
    d = h * dk
    if not uses_kernel(n, d, q.dtype):
        return reference_attention_proj(q, k, v, edge_raw, we, be, woe, boe)
    return EdgeAttentionProj.apply(q.reshape(b, n, d), k.reshape(b, n, d),
                                   v.reshape(b, n, d), edge_raw, we, be, woe, boe, h)


# ---------------------------------------------------------------- v2: K3, K4

# The v2 kernels' geometry (csrc/attn_v2.cuh holds the same constants and
# formula; the libraries refuse a launch whose shared memory disagrees and
# export theirs: v2_library_plan).
V2_GROUPS = 8           # key groups of a warp; a thread takes keys g + 8 m
V2_MAX_KPT = 14         # keys a thread: N at most 112
V2_REG_KPT = 8          # up to this many keys a thread, 128-channel work items
V2_MAX_STAGES = 8       # ring slots
V2_VEC = 512            # bytes a staged row vector (q_i, gn_i; 128 f32 channels)
V2_SM_SMEM = 233_472    # shared memory of a SM; each resident block reserves 1 KiB
V2_BLOCK_RESERVE = 1024
V2_ALIGN, V2_BARS = 1024, 256
V2_PER = {"fwd": 1, "bwd": 2}   # edge tensors a slot: K3 e; K4 e and ge


@dataclasses.dataclass(frozen=True)
class V2Plan:
    """Launch geometry of K3 (``kernel`` "fwd") or K4 ("bwd") for ``batch``
    graphs of ``n`` atoms at D = ``d`` on ``num_sms`` SMs."""
    kernel: str
    batch: int
    n: int
    d: int
    bf16: bool
    kpt: int                # keys a thread (the kernel's instantiation)
    width: int              # channels a work item (a consumer warp owns 8)
    stages: int             # ring slots
    blocks_per_sm: int
    items: int              # (graph, channel slice) work items
    grid: int               # persistent blocks
    smem_bytes: int         # dynamic shared memory a block

    def item_range(self, block: int) -> tuple:
        """The contiguous run of items ``[begin, end)`` of block ``block``
        (the kernels' ``item_range``); item ``it`` is graph
        ``it // (d / width)``, channels ``width (it % (d / width))`` on."""
        return (self.items * block // self.grid, self.items * (block + 1) // self.grid)


def v2_kpt(n: int) -> int:
    """Keys a thread for N atoms, rounded up to the instantiations 2, 4, .., 14."""
    return -(-n // 16) * 2


def v2_width(n: int) -> int:
    """Channels a work item: 128 (whole bf16 rows of D 128) up to 8 keys a
    thread, 64 above (blocks of 8 warps, up to 255 registers a thread)."""
    return 128 if v2_kpt(n) <= V2_REG_KPT else 64


def v2_box_bytes(n: int, bf16: bool) -> int:
    """One staged [N][width] slice: panels of N rows of 128 bytes (64 bf16 or
    32 f32 channels), each 1 KiB aligned."""
    return v2_width(n) * (2 if bf16 else 4) // 128 * (-(-n * 128 // 1024) * 1024)


def v2_smem_bytes(kernel: str, n: int, bf16: bool, stages: int) -> int:
    """Dynamic shared memory of a K3 / K4 block (``attn_v2.cuh::smem_bytes``)."""
    per = V2_PER[kernel]
    return (V2_ALIGN + (stages * per + 2) * v2_box_bytes(n, bf16) + stages * per * V2_VEC
            + V2_BARS)


def v2_launch_plan(kernel: str, batch: int, n: int, d: int, dtype, num_sms: int) -> V2Plan:
    """K3 / K4's launch (``csrc/attn_v2.cuh``): work items of one graph and
    :func:`v2_width` channels, a block of a consumer warp per 8 channels and
    a producer warp; K3 with 128-channel items two blocks a SM where two
    ring slots fit half a SM (56 registers a thread), else one; K4 one (its
    per-thread totals take up to 120 registers, or 255 with 64-channel
    items); as many ring slots as fit the block's share of a SM, at most 8;
    a persistent block per item up to the blocks a SM times ``num_sms``.
    Raises for a shape it cannot take (none that :func:`uses_v2_kernel`
    admits)."""
    if kernel not in V2_PER:
        raise ValueError(f"kernel is 'fwd' or 'bwd', not {kernel!r}")
    if not 1 <= n <= V2_GROUPS * V2_MAX_KPT or d <= 0 or d % 128 or batch < 0:
        raise ValueError(f"K3/K4 take 1 <= N <= {V2_GROUPS * V2_MAX_KPT}, D a multiple of "
                         f"128 and batch >= 0, got N {n}, D {d}, batch {batch}")
    bf16 = dtype == torch.bfloat16
    kpt, width = v2_kpt(n), v2_width(n)
    half = V2_SM_SMEM // 2 - V2_BLOCK_RESERVE
    bps = (2 if kernel == "fwd" and width == 128 and v2_smem_bytes(kernel, n, bf16, 2) <= half
           else 1)
    budget = half if bps == 2 else SMEM_LIMIT
    stages = max((s for s in range(2, V2_MAX_STAGES + 1)
                  if v2_smem_bytes(kernel, n, bf16, s) <= budget), default=0)
    if stages < 2:
        raise ValueError(f"K3/K4 at N {n}, D {d}, {dtype}: two ring slots do not fit "
                         f"{budget:,} B of shared memory")
    items = batch * (d // width)
    return V2Plan(kernel=kernel, batch=batch, n=n, d=d, bf16=bf16, kpt=kpt, width=width,
                  stages=stages, blocks_per_sm=bps, items=items,
                  grid=max(1, min(items, bps * num_sms)),
                  smem_bytes=v2_smem_bytes(kernel, n, bf16, stages))


@functools.cache
def _v2_fwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_v2")
    for fn in (lib.edge_attention_v2_fwd_bf16, lib.edge_attention_v2_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.edge_attention_v2_fwd_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_longlong)]
    lib.edge_attention_v2_fwd_plan.restype = None
    lib.edge_attention_v2_item_range.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.edge_attention_v2_item_range.restype = None
    return lib


@functools.cache
def _v2_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_v2_bwd")
    for fn in (lib.edge_attention_v2_bwd_bf16, lib.edge_attention_v2_bwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.edge_attention_v2_bwd_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_longlong)]
    lib.edge_attention_v2_bwd_plan.restype = None
    return lib


def v2_library_plan(kernel: str, n: int, dtype, stages: int) -> dict:
    """What the K3 (``"fwd"``) or K4 (``"bwd"``) library computes for (N, dtype,
    stages): its shared memory a block, keys a thread, and the blocks a SM
    the runtime keeps resident (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_longlong * 3)()
    lib = _v2_fwd_lib() if kernel == "fwd" else _v2_bwd_lib()
    getattr(lib, f"edge_attention_v2_{kernel}_plan")(n, int(dtype == torch.bfloat16), stages,
                                                     out)
    return {"smem_bytes": out[0], "kpt": out[1], "resident_blocks": out[2]}


def v2_library_item_range(items: int, grid: int, block: int) -> tuple:
    """The items the kernels' block ``block`` of ``grid`` takes, as the library
    computes them."""
    out = (ctypes.c_longlong * 2)()
    _v2_fwd_lib().edge_attention_v2_item_range(items, grid, block, out)
    return out[0], out[1]


def _aligned(x):
    # TMA reads and writes 16-byte-aligned rows
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def edge_attention_v2_fwd(q3, k3, v3, e4, heads: int):
    """K3: ``(edge_pre, node_agg)`` like :func:`edge_attention_v2_fwd_reference`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``edge_attention_v2_fwd.launches``) or raises."""
    if q3.device.type == "cpu":
        return edge_attention_v2_fwd_reference(q3, k3, v3, e4, heads)
    if q3.device.type != "cuda":
        raise ValueError(f"edge_attention_v2_fwd runs on cpu or cuda, not {q3.device}")
    _check_cuda_args("edge_attention_v2_fwd", q3, k3, v3, e4, (), rule=uses_v2_kernel)
    b, n, d = q3.shape
    q3, k3, v3, e4 = (_aligned(x) for x in (q3, k3, v3, e4))
    edge_pre, node = torch.empty_like(e4), torch.empty_like(q3)
    index = _device_index(q3)
    plan = v2_launch_plan("fwd", b, n, d, q3.dtype, num_sms(index))
    lib = _v2_fwd_lib()
    fn = (lib.edge_attention_v2_fwd_bf16 if q3.dtype == torch.bfloat16
          else lib.edge_attention_v2_fwd_f32)
    with torch.cuda.device(index):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), e4.data_ptr(),
                 edge_pre.data_ptr(), node.data_ptr(), b, n, d,
                 1.0 / math.sqrt(d // heads), plan.grid, plan.stages, plan.smem_bytes,
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attention_v2_fwd kernel launch failed: CUDA error {err}")
    edge_attention_v2_fwd.launches += 1
    return edge_pre, node


edge_attention_v2_fwd.launches = 0


def edge_attention_v2_bwd(q3, k3, v3, e4, ge, gn, heads: int):
    """K4: ``(dq, dk, dv, de)`` like :func:`edge_attention_v2_bwd_reference`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``edge_attention_v2_bwd.launches``) or raises."""
    if q3.device.type == "cpu":
        return edge_attention_v2_bwd_reference(q3, k3, v3, e4, ge, gn, heads)
    if q3.device.type != "cuda":
        raise ValueError(f"edge_attention_v2_bwd runs on cpu or cuda, not {q3.device}")
    b, n, d = q3.shape
    _check_cuda_args("edge_attention_v2_bwd", q3, k3, v3, e4, (),
                     (("ge", ge, (b, n, n, d)), ("gn", gn, (b, n, d))), rule=uses_v2_kernel)
    q3, k3, v3, e4, ge, gn = (_aligned(x) for x in (q3, k3, v3, e4, ge, gn))
    dq, dk, dv = torch.empty_like(q3), torch.empty_like(q3), torch.empty_like(q3)
    de = torch.empty_like(e4)
    index = _device_index(q3)
    plan = v2_launch_plan("bwd", b, n, d, q3.dtype, num_sms(index))
    lib = _v2_bwd_lib()
    fn = (lib.edge_attention_v2_bwd_bf16 if q3.dtype == torch.bfloat16
          else lib.edge_attention_v2_bwd_f32)
    with torch.cuda.device(index):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), e4.data_ptr(), ge.data_ptr(),
                 gn.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), de.data_ptr(),
                 b, n, d, 1.0 / math.sqrt(d // heads), plan.grid, plan.stages,
                 plan.smem_bytes, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attention_v2_bwd kernel launch failed: CUDA error {err}")
    edge_attention_v2_bwd.launches += 1
    return dq, dk, dv, de


edge_attention_v2_bwd.launches = 0


class EdgeAttention(torch.autograd.Function):
    """K3 forward, K4 backward (the JAX ``custom_vjp`` of ``_make_op``).

    ``apply(q3, k3, v3, e4, heads)`` -> ``(edge_pre, node_agg)``.  Saves the
    four inputs; first-order only: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, q3, k3, v3, e4, heads):
        ctx.save_for_backward(q3, k3, v3, e4)
        ctx.heads = heads
        return edge_attention_v2_fwd(q3, k3, v3, e4, heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, ge, gn):
        q3, k3, v3, e4 = ctx.saved_tensors
        dq, dk, dv, de = edge_attention_v2_bwd(q3, k3, v3, e4, ge.to(q3.dtype),
                                               gn.to(q3.dtype), ctx.heads)
        return dq, dk, dv, de, None


def edge_modulated_attention(q, k, v, e):
    """Fused modulate + softmax + aggregate (JAX ``edge_modulated_attention``):
    q, k, v [B, N, H, dk]; e [B, N, N, H, dk].  Returns ``(edge_pre
    [B, N, N, D], node_agg [B, N, D])``, :func:`reference_attention`'s
    outputs: K3/K4 where :func:`uses_v2_kernel` sends the shape,
    :func:`reference_attention` elsewhere."""
    b, n, h, dk = q.shape
    d = h * dk
    if not uses_v2_kernel(n, d, q.dtype):
        return reference_attention(q, k, v, e)
    return EdgeAttention.apply(q.reshape(b, n, d), k.reshape(b, n, d), v.reshape(b, n, d),
                               e.reshape(b, n, n, d), h)

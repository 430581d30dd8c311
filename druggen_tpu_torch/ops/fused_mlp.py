"""Fused LN -> MLP -> residual -> LN row op (the edge-stream tail), K1 and K2.

Port of ``druggen_tpu/ops/fused_mlp.py``.  Each encoder block ends its edge
stream with ``LN6(LN4(y + y1) + MLP2(LN4(y + y1)))``; this op computes

    fused_ln_mlp_ln(s, ...) = LN2(LN1(s) + fc2(relu(fc1(LN1(s)))))

over the last axis of ``s`` in one pass: one read of ``s`` and one write of
the output, with the 3C-wide hidden kept on chip.  The kernel is
``csrc/fused_mlp.cu`` (hand-written CUDA for sm_90a; its header states what
bounds it).  Rounding points, as in the Pallas kernel: LN1 in f32; its output
rounded to the stream dtype for fc1; fc1 with an f32 accumulator, + b1, relu;
the hidden rounded to the stream dtype for fc2; fc2 with an f32 accumulator,
+ b2; the residual added to the *f32* LN1 output; LN2 in f32, rounded to the
stream dtype.  Weights are cast to the stream dtype; LayerNorm parameters and
biases stay f32.

The backward, K2 (``csrc/fused_mlp_bwd.cu``, the Pallas ``_bwd_kernel``),
recomputes the forward from ``s`` and returns ``ds`` in the stream dtype and
the 8 parameter gradients in f32.  :class:`FusedLnMlpLn` is the
``torch.autograd.Function`` with K1 forward and K2 backward; like the JAX
``custom_vjp`` it saves only ``s`` and the parameters and is first-order
only (its backward is ``once_differentiable``).  A CPU tensor takes the
plain versions in both directions; a CUDA tensor launches or raises.

Widths.  The kernels take C and H as compile-time constants: each (C, H) a
run meets is built into its own library at first use, and every width runs.
The bf16 kernels are written for Hopper (``csrc/tail_hopper.cuh``: wgmma,
TMA, 64-row tiles a warpgroup); :func:`launch_plan` is their launch
geometry and shared memory in plain Python, which the library checks.  They
take W1^T and W2^T zero-padded to multiples of 64, stage both in shared
memory where they fit one SM's 227 KB beside the tile buffers (dim 128 with
mlp_ratio 3: 230,416 B for K1) and otherwise stream them chunk by chunk from
L2 (dim 128 with mlp_ratio 4, dim 256).  That single pass takes C a multiple
of 8 up to 256; every other C takes the split path (``csrc/tail_split.cuh``:
LayerNorm row kernels and wgmma GEMMs that pass x, h and the f32 residual
sum through device memory, the same rounding points).  The f32 twins (CUDA
cores, ``csrc/tail_common.cuh``'s tile routine, shared with K7 and K9) take
the weights padded to multiples of 16 and read them through L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from druggen_tpu_torch.ops import _build

_EPS = 1e-5
# Dynamic shared memory one block may use on the H100 (227 KB).
SMEM_LIMIT = 232_448


def fused_ln_mlp_ln_reference(s, g1, bl1, w1, b1, w2, b2, g2, bl2):
    """Plain PyTorch version of the kernel, with the same rounding points.

    ``s``: [..., C]; ``w1`` [C, H], ``w2`` [H, C]; LN params [C]; ``b1`` [H].
    The products run on f32 copies of the stream-dtype operands, so every
    product is exact and the sums are f32, as in the kernel."""
    c = s.shape[-1]
    f32 = torch.float32
    dt = s.dtype
    x = F.layer_norm(s.to(f32), (c,), g1.to(f32), bl1.to(f32), _EPS)
    h = torch.relu(x.to(dt).to(f32) @ w1.to(dt).to(f32) + b1.to(f32))
    m = h.to(dt).to(f32) @ w2.to(dt).to(f32) + b2.to(f32)
    return F.layer_norm(x + m, (c,), g2.to(f32), bl2.to(f32), _EPS).to(dt)


def _ln_fwd(s, gamma, beta):
    """The Pallas kernels' ``_ln_fwd``: f32 LayerNorm, also returning
    ``xhat`` and ``rstd``."""
    mu = s.mean(-1, keepdim=True)
    d = s - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + _EPS)
    xhat = d * rstd
    return xhat * gamma + beta, xhat, rstd


def _ln_bwd_input(dy, xhat, rstd, gamma):
    """d(input) of ``y = gamma * xhat + beta`` given the upstream ``dy``."""
    dxhat = dy * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd


def fused_ln_mlp_ln_bwd_reference(s, g1, bl1, w1, b1, w2, b2, g2, bl2, dout,
                                  relu_set=None):
    """Plain PyTorch version of K2 with the Pallas ``_bwd_kernel``'s rounding
    points: the forward recomputed as in K1; the products ``dm W2^T``,
    ``dh W1^T``, ``h^T dm`` and ``x^T dh`` on stream-dtype operands with f32
    sums (f32 products of the rounded values, so each product is exact);
    ``ds`` rounded to the stream dtype; the parameter gradients in f32, cast
    to each parameter's dtype.  Returns ``(ds, dg1, dbl1, dw1, db1, dw2, db2,
    dg2, dbl2)`` with ``dw1`` [C, H] and ``dw2`` [H, C].

    ``relu_set``: optional ``(rows, units, live)``, rows of ``s`` viewed as
    [rows, C], hidden units and bools: the ReLU derivative at each such
    unit is set to ``live`` instead of ``h_pre > 0`` (which side of the
    kink a unit within rounding of it takes; :func:`witness_kink_flips`)."""
    c = s.shape[-1]
    f32 = torch.float32
    dt = s.dtype

    def rnd(t):
        return t.to(dt).to(f32)

    s2 = s.reshape(-1, c).to(f32)
    go = dout.reshape(-1, c).to(f32)
    w1r, w2r = rnd(w1), rnd(w2)
    g1f, g2f = g1.to(f32), g2.to(f32)
    # recompute the forward
    x, xhat1, rstd1 = _ln_fwd(s2, g1f, bl1.to(f32))
    h_pre = rnd(x) @ w1r + b1.to(f32)
    h = torch.relu(h_pre)
    m = rnd(h) @ w2r + b2.to(f32)
    _, rhat, rstd2 = _ln_fwd(x + m, g2f, bl2.to(f32))
    # backward
    dm = _ln_bwd_input(go, rhat, rstd2, g2f)
    live = h_pre > 0.0
    if relu_set is not None:
        rows, units, values = relu_set
        live[rows, units] = values
    dh = (rnd(dm) @ w2r.t()) * live
    dx = dm + rnd(dh) @ w1r.t()
    ds = _ln_bwd_input(dx, xhat1, rstd1, g1f)
    return (ds.to(dt).reshape(s.shape),
            (dx * xhat1).sum(0).to(g1.dtype), dx.sum(0).to(bl1.dtype),
            (rnd(x).t() @ rnd(dh)).to(w1.dtype), dh.sum(0).to(b1.dtype),
            (rnd(h).t() @ rnd(dm)).to(w2.dtype), dm.sum(0).to(b2.dtype),
            (go * rhat).sum(0).to(g2.dtype), go.sum(0).to(bl2.dtype))


# How far a rounding difference between two computations of the same row
# can move a hidden pre-activation h_pre_j, per unit of sum_k |x_k W1_kj|:
# bf16, every rounded x_k one ulp off (an ulp is at most 2^-7 of |x_k|);
# f32, the products summed in another order (at most C = 128 roundings of
# 2^-24).
KINK_REACH = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -17}


def witness_kink_flips(s, params, dout, ds, bad_rows, row_ok):
    """Explain the rows of K2's ``ds`` that its plain version does not match
    by the side of the ReLU kink that units near it take.

    A hidden unit whose pre-activation ``h_pre`` lies within rounding of 0
    (``KINK_REACH`` times sum_k |x_k W1_kj|) may take either side of the
    kink, in the kernel and in the plain version alike (a row's ``h_pre``
    is summed in another order when the rows around it change); its ``dh``
    element, and so the row's ``ds``, then differ by O(1e-1).  For each row
    in ``bad_rows`` (indices into ``s`` viewed as [rows, C]) the plain row
    is recomputed with each side of the kink for each of its 3 units
    nearest the kink that lie within reach (every other unit keeps the side
    of its ``h_pre``).  A row is explained by the setting with the fewest
    units moved from the side of their ``h_pre`` under which
    ``row_ok(ds_rows, ref_rows)`` (a bool per row) holds.  ``params`` is
    ``(g1, bl1, w1, b1, w2, b2, g2, bl2)``.

    Returns ``(relu_set, unexplained)``: the settings of the explained
    rows, for ``fused_ln_mlp_ln_bwd_reference(..., relu_set=relu_set)``,
    and the rows that no setting explains."""
    c = s.shape[-1]
    dt = s.dtype
    bad_rows = bad_rows.to(s.device)
    s2, go = s.reshape(-1, c)[bad_rows], dout.reshape(-1, c)[bad_rows]
    got = ds.reshape(-1, c)[bad_rows]
    g1, bl1, w1, b1 = params[:4]
    x = F.layer_norm(s2.float(), (c,), g1.float(), bl1.float(), _EPS).to(dt).float()
    w1r = w1.to(dt).float()
    h_pre = x @ w1r + b1.float()
    reach = KINK_REACH[dt] * (x.abs() @ w1r.abs())
    k = min(3, h_pre.shape[-1])
    near = h_pre.abs().topk(k, -1, largest=False).indices
    within = h_pre.gather(1, near).abs() <= reach.gather(1, near)
    side = h_pre.gather(1, near) > 0.0
    rows = torch.arange(len(bad_rows), device=s.device).repeat_interleave(k)
    bit = 2 ** torch.arange(k, device=s.device)

    def setting(moved):
        return side ^ (((moved[:, None] & bit) > 0) & within)

    choice = torch.full_like(bad_rows, -1)
    for moved in sorted(range(2 ** k), key=lambda m: bin(m).count("1")):
        live = setting(torch.full_like(bad_rows, moved))
        ref = fused_ln_mlp_ln_bwd_reference(
            s2, *params, go, relu_set=(rows, near.reshape(-1), live.reshape(-1)))[0]
        choice = torch.where((choice < 0) & row_ok(got, ref), moved, choice)
    ok = choice >= 0
    relu_set = (bad_rows[ok].repeat_interleave(k), near[ok].reshape(-1),
                setting(choice.clamp_min(0))[ok].reshape(-1))
    return relu_set, bad_rows[~ok]


def _widths(c: int, h: int) -> dict:
    return {"KERNEL_C": c, "KERNEL_H": h}


@functools.cache
def _kernel_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_mlp", _widths(c, h))
    for fn in (lib.fused_ln_mlp_ln_fwd_bf16, lib.fused_ln_mlp_ln_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_fwd_bf16_split.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.fused_ln_mlp_ln_fwd_bf16_split.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_split.argtypes = []
    lib.fused_ln_mlp_ln_split.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_ln_mlp_ln_fwd_stages_weights.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_fwd_stages_weights.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_mlp_bwd", _widths(c, h))
    for fn in (lib.fused_ln_mlp_ln_bwd_bf16, lib.fused_ln_mlp_ln_bwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 18
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_bwd_bf16_split.argtypes = (
        [ctypes.c_void_p] * 20
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    lib.fused_ln_mlp_ln_bwd_bf16_split.restype = ctypes.c_int
    for name in ("fused_ln_mlp_ln_bwd_smem_bytes", "fused_ln_mlp_ln_bwd_wgrad_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.fused_ln_mlp_ln_bwd_stages_weights.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_bwd_stages_weights.restype = ctypes.c_int
    return lib


# The bf16 kernels' plan (csrc/tail_hopper.cuh, fused_mlp.cu, fused_mlp_bwd.cu
# compute the same numbers as constants and refuse a launch that disagrees).
TILE_ROWS = 64          # rows a warpgroup tile
HIDDEN_CHUNK = 64       # hidden columns a chunk
WGRAD_ROWS = 64         # rows a wgrad stage
SPLIT_STAGES = 4        # K stages of a split-path GEMM's ring
_ALIGN_SLACK = 1024     # the kernels align their shared memory to 1,024 B
_BAR_RESERVE = 256      # room kept for mbarriers when deciding what fits


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Launch geometry, shared memory and scratch of the bf16 K1 and K2 for
    C = ``c``, H = ``h`` and ``rows`` rows on ``num_sms`` SMs."""
    c: int
    h: int
    rows: int
    cp: int                 # C and H padded to 64-column panels
    hp: int
    warpgroups: int         # consumer warpgroups a block (K1, K2's rows pass)
    tile_rows: int          # rows a warpgroup tile
    tiles: int
    grid: int               # persistent blocks of K1 and of K2's rows pass
    fwd_staged: bool        # K1 stages both weights once a block
    fwd_ring: int           # else: weight-ring stages a warpgroup
    fwd_smem: int           # dynamic shared memory a K1 block, bytes
    rows_staged: bool
    rows_ring: int
    rows_smem: int
    wgrad_tile_n: int       # a wgrad warpgroup's output tile: 64 x wgrad_tile_n
    wgrad_warpgroups: int
    wgrad_super_tiles: int  # blocks a row chunk (each covers wgrad_warpgroups tiles)
    wgrad_stages: int
    wgrad_smem: int
    chunks: int             # wgrad row chunks (split K)
    chunk_rows: int
    vec_partials: int       # rows of K2's vector partial (a block; split: a tile)
    scratch_bytes: int      # K2's device scratch: row operands and partials
    split: bool = False     # the split path (tail_split.cuh)
    fwd_scratch_bytes: int = 0  # K1's device scratch (split path only)

    @property
    def wgrad_grid(self) -> tuple:
        return (self.wgrad_super_tiles, self.chunks, 2)


def _split_gemm_smem(n: int) -> int:
    """Shared memory of a split-path GEMM block whose output is n wide."""
    bn = next(b for b in (256, 192, 128, 64) if n % b == 0)
    return SPLIT_STAGES * (TILE_ROWS * 128 + bn * 128) + SPLIT_STAGES * 8 + _ALIGN_SLACK


def launch_plan(c: int, h: int, rows: int, num_sms: int) -> LaunchPlan:
    """The bf16 K1/K2 plan (``csrc/tail_hopper.cuh`` explains it): two
    consumer warpgroups a block while C padded to 64 is at most 128 (mode A),
    else one; weights staged where they fit ``SMEM_LIMIT`` beside the tile
    buffers, else streamed through a ring of 64-column chunks; wgrad output
    tiles of 64 x 192 (or 128, 64) shared by up to four warpgroups; row
    chunks of a multiple of 64 rows that cover the rows exactly.  C not a
    multiple of 8, or C padded to 64 above 256, takes the split path
    (``csrc/tail_split.cuh``): one 64-row tile a block, its GEMMs'
    ``SPLIT_STAGES``-stage rings, one vector partial a tile."""
    if c <= 0 or h <= 0:
        raise ValueError(f"the tail kernels take C, H > 0, got C {c}, H {h}")
    cp, hp = _pad(c, 64), _pad(h, 64)
    split = c % 8 != 0 or cp > 256
    mode_a = cp <= 128
    nwg = 2 if mode_a else 1
    tile = TILE_ROWS * cp * 2
    weights = 2 * cp * hp * 2
    chunk = 2 * HIDDEN_CHUNK * cp * 2
    nvec = 5 * c + h

    def ring(fixed: int) -> int:
        room = SMEM_LIMIT - _ALIGN_SLACK - _BAR_RESERVE - fixed
        return min(4, room // (nwg * chunk))

    def fits(bufs: int) -> bool:
        return weights + bufs + _BAR_RESERVE + _ALIGN_SLACK <= SMEM_LIMIT

    fwd_bufs = nwg * (tile if mode_a else 2 * tile)
    fwd_staged = fits(fwd_bufs)
    fwd_ring = 0 if fwd_staged else ring(fwd_bufs)
    fwd_smem = ((weights if fwd_staged else 0) + fwd_bufs + nwg * fwd_ring * chunk
                + nwg * (1 + fwd_ring) * 8 + _ALIGN_SLACK)
    vec_smem = 0 if mode_a else _pad(4 * nvec * 4, 1024)
    rows_bufs = (2 if mode_a else 3) * tile + vec_smem
    rows_staged = fits(rows_bufs)
    rows_ring = 0 if rows_staged else ring(rows_bufs)
    rows_smem = ((weights if rows_staged else 0) + rows_bufs + nwg * rows_ring * chunk
                 + nwg * (2 + rows_ring) * 8 + _ALIGN_SLACK)
    wmt = cp // 64
    nw = 192 if hp % 192 == 0 else (128 if hp % 128 == 0 else 64)
    wnt = hp // nw
    ms = 2 if wmt % 2 == 0 else 1
    ns = 4 // ms if wnt % (4 // ms) == 0 else (2 if wnt % 2 == 0 else 1)
    super_tiles = (wmt // ms) * (wnt // ns)
    stage = WGRAD_ROWS * 128 * (ms + ns * nw // 64)
    stages = min(4, (SMEM_LIMIT - _ALIGN_SLACK - _BAR_RESERVE) // stage)
    wgrad_smem = stages * stage + stages * 8 + _ALIGN_SLACK
    tiles = -(-rows // TILE_ROWS)
    grid = min(num_sms, -(-tiles // nwg))
    slabs = -(-rows // WGRAD_ROWS)
    chunks = min(slabs, max(1, num_sms // (2 * super_tiles)))
    chunk_rows = _pad(-(-rows // chunks), WGRAD_ROWS) if rows else WGRAD_ROWS
    chunks = -(-rows // chunk_rows)
    vec_partials = grid
    fwd_scratch = 0
    if split:
        fwd_staged = rows_staged = False
        fwd_ring = rows_ring = SPLIT_STAGES
        fwd_smem = rows_smem = max(_split_gemm_smem(hp), _split_gemm_smem(cp))
        nwg, grid = 1, tiles
        vec_partials = tiles
        # x [rows, CP] and h [rows, HP] bf16, z [rows, CP] f32, (mu1, rstd1)
        fwd_scratch = rows * ((cp + hp) * 2 + cp * 4 + 8)
    scratch = (2 * rows * (cp + hp) * 2 + vec_partials * nvec * 4
               + 2 * chunks * cp * hp * 4 + (2 * c * h + 5 * c + h) * 4
               + (rows * (cp * 4 + 8) if split else 0))
    return LaunchPlan(
        c=c, h=h, rows=rows, cp=cp, hp=hp, warpgroups=nwg, tile_rows=TILE_ROWS,
        tiles=tiles, grid=grid, fwd_staged=fwd_staged, fwd_ring=fwd_ring,
        fwd_smem=fwd_smem, rows_staged=rows_staged, rows_ring=rows_ring,
        rows_smem=rows_smem, wgrad_tile_n=nw, wgrad_warpgroups=ms * ns,
        wgrad_super_tiles=super_tiles, wgrad_stages=stages, wgrad_smem=wgrad_smem,
        chunks=chunks, chunk_rows=chunk_rows, vec_partials=vec_partials,
        scratch_bytes=scratch, split=split, fwd_scratch_bytes=fwd_scratch)


@functools.cache
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda_args(s, g1, bl1, w1, b1, w2, b2, g2, bl2) -> None:
    if s.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_ln_mlp_ln kernel takes bf16 or f32, got {s.dtype}")
    c = s.shape[-1]
    hid = w1.shape[-1]
    shapes = {"w1": (w1, (c, hid)), "w2": (w2, (hid, c)), "b1": (b1, (hid,)),
              "g1": (g1, (c,)), "bl1": (bl1, (c,)), "b2": (b2, (c,)),
              "g2": (g2, (c,)), "bl2": (bl2, (c,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s is on {s.device}")
    if not s.is_contiguous():
        raise ValueError("s must be contiguous")
    if s.data_ptr() % 16:
        raise ValueError("s must be 16-byte aligned")


def padded_weights(w1, w2, dtype, multiple: int = 16):
    """W1^T [HP, CP] and W2^T [CP, HP] in ``dtype``, zero-padded to
    multiples of ``multiple`` (the layout the tail kernels read: 16 for the
    f32 twins and K7/K8, 64 for the bf16 K1/K2)."""
    c, hid = w1.shape
    cp, hp = _pad(c, multiple), _pad(hid, multiple)
    w1t = F.pad(w1.t().to(dtype), (0, cp - c, 0, hp - hid)).contiguous()
    w2t = F.pad(w2.t().to(dtype), (0, hp - hid, 0, cp - c)).contiguous()
    return w1t, w2t


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _f32_params(g1, bl1, b1, b2, g2, bl2, hp: int):
    """The LayerNorm parameters and biases as contiguous f32, b1 padded to
    ``hp``."""
    g1, bl1, b2, g2, bl2 = (p.to(torch.float32).contiguous() for p in (g1, bl1, b2, g2, bl2))
    b1 = F.pad(b1.to(torch.float32), (0, hp - b1.shape[0])).contiguous()
    return g1, bl1, b1, b2, g2, bl2


def fused_ln_mlp_ln(s, g1, bl1, w1, b1, w2, b2, g2, bl2):
    """``LN2(LN1(s) + fc2(relu(fc1(LN1(s)))))`` over the last axis of ``s``.

    Same signature as the JAX ``fused_ln_mlp_ln``: ``s`` [..., C];
    ``w1`` [C, H], ``w2`` [H, C] (``nn.Linear.weight.t()`` views are fine);
    LN params [C]; ``b1`` [H].  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (counted in ``fused_ln_mlp_ln.launches``) or
    raises."""
    if s.device.type == "cpu":
        return fused_ln_mlp_ln_reference(s, g1, bl1, w1, b1, w2, b2, g2, bl2)
    if s.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_ln runs on cpu or cuda, not {s.device}")
    _check_cuda_args(s, g1, bl1, w1, b1, w2, b2, g2, bl2)
    c, hid = s.shape[-1], w1.shape[-1]
    dt = s.dtype
    lib = _kernel_lib(c, hid)
    rows = s.numel() // c
    out = torch.empty_like(s)
    if rows == 0:
        return out
    index = _device_index(s.device)
    scratch = []
    if dt == torch.bfloat16:
        plan = launch_plan(c, hid, rows, num_sms(index))
        w1t, w2t = padded_weights(w1, w2, dt, 64)
        hp = plan.hp
        if plan.split:   # x, h, the f32 residual sum, (mu1, rstd1)
            f32, dev = torch.float32, s.device
            scratch = [torch.empty(rows, plan.cp, dtype=dt, device=dev),
                       torch.empty(rows, hp, dtype=dt, device=dev),
                       torch.empty(rows, plan.cp, dtype=f32, device=dev),
                       torch.empty(rows, 2, dtype=f32, device=dev)]
            fn, geometry = lib.fused_ln_mlp_ln_fwd_bf16_split, ()
        else:
            fn, geometry = lib.fused_ln_mlp_ln_fwd_bf16, (plan.grid, plan.fwd_smem)
    else:
        w1t, w2t = padded_weights(w1, w2, dt)
        fn, hp = lib.fused_ln_mlp_ln_fwd_f32, hid
        geometry = (min(-(-rows // 16), 4 * num_sms(index)),
                    lib.fused_ln_mlp_ln_fwd_smem_bytes(0))
    g1, bl1, b1, b2, g2, bl2 = _f32_params(g1, bl1, b1, b2, g2, bl2, hp)
    args = [s, g1, bl1, w1t, b1, w2t, b2, g2, bl2, out, *scratch]
    with torch.cuda.device(index):
        err = fn(*(t.data_ptr() for t in args), rows, c, hid, *geometry,
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ln_mlp_ln kernel launch failed: CUDA error {err}")
    fused_ln_mlp_ln.launches += 1
    return out


fused_ln_mlp_ln.launches = 0


def fused_ln_mlp_ln_bwd(s, g1, bl1, w1, b1, w2, b2, g2, bl2, dout):
    """K2: the backward of :func:`fused_ln_mlp_ln` for the cotangent
    ``dout`` (same shape and dtype as ``s``).  Returns ``(ds, dg1, dbl1, dw1,
    db1, dw2, db2, dg2, dbl2)`` like :func:`fused_ln_mlp_ln_bwd_reference`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``fused_ln_mlp_ln_bwd.launches``) or raises."""
    if s.device.type == "cpu":
        return fused_ln_mlp_ln_bwd_reference(s, g1, bl1, w1, b1, w2, b2, g2,
                                             bl2, dout)
    if s.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_ln_bwd runs on cpu or cuda, not {s.device}")
    _check_cuda_args(s, g1, bl1, w1, b1, w2, b2, g2, bl2)
    if dout.shape != s.shape or dout.dtype != s.dtype or dout.device != s.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} {dout.device} "
                         f"does not match s {tuple(s.shape)} {s.dtype} {s.device}")
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")
    c, hid = s.shape[-1], w1.shape[-1]
    rows = s.numel() // c
    dt = s.dtype
    dev = s.device
    index = _device_index(dev)
    lib = _bwd_lib(c, hid)
    sms = num_sms(index)
    f32 = torch.float32
    split_scratch = []
    if dt == torch.bfloat16:
        plan = launch_plan(c, hid, rows, sms)
        cp, hp = plan.cp, plan.hp
        w1t, w2t = padded_weights(w1, w2, dt, 64)
        fn = lib.fused_ln_mlp_ln_bwd_bf16
        geometry = (plan.grid, plan.rows_smem, plan.chunks, plan.chunk_rows,
                    plan.wgrad_super_tiles, plan.wgrad_smem)
        if plan.split:   # z (then dr, then dx) and (mu1, rstd1); no row grid
            fn, geometry = lib.fused_ln_mlp_ln_bwd_bf16_split, geometry[2:]
            split_scratch = [torch.empty(rows, cp, dtype=f32, device=dev),
                             torch.empty(rows, 2, dtype=f32, device=dev)]
        vec_partial = torch.empty(plan.vec_partials, 5 * c + hid, dtype=f32, device=dev)
        w_partial = torch.empty(2, plan.chunks, cp * hp, dtype=f32, device=dev)
    else:
        cp, hp = c, hid
        w1t, w2t = padded_weights(w1, w2, dt)
        fn = lib.fused_ln_mlp_ln_bwd_f32
        # 16-row tiles on a few blocks a SM; split-K over 64-row slabs for
        # the 128 x 128 weight-gradient tiles, about two blocks a SM
        row_blocks = max(1, min(-(-rows // 16), 4 * sms))
        w_tiles = -(-c // 128) * -(-hid // 128)
        chunks = max(1, min(-(-rows // 64), (2 * sms) // (2 * w_tiles)))
        chunk_rows = _pad(-(-max(rows, 1) // chunks), 64)
        geometry = (row_blocks, lib.fused_ln_mlp_ln_bwd_smem_bytes(0), chunks, chunk_rows,
                    w_tiles, lib.fused_ln_mlp_ln_bwd_wgrad_smem_bytes(0))
        vec_partial = torch.zeros(row_blocks * 8, 5 * c + hid, dtype=f32, device=dev)
        w_partial = torch.empty(2, chunks, c * hid, dtype=f32, device=dev)
    g1f, bl1f, b1f, b2f, g2f, bl2f = _f32_params(g1, bl1, b1, b2, g2, bl2, hp)
    ds = torch.empty_like(s)
    x_buf = torch.empty(rows, cp, dtype=dt, device=dev)
    h_buf = torch.empty(rows, hp, dtype=dt, device=dev)
    dm_buf = torch.empty(rows, cp, dtype=dt, device=dev)
    dh_buf = torch.empty(rows, hp, dtype=dt, device=dev)
    grads = torch.empty(2 * c * hid + 5 * c + hid, dtype=f32, device=dev)
    args = [s, dout, g1f, bl1f, w1t, b1f, w2t, b2f, g2f, bl2f, ds, x_buf, h_buf, dm_buf,
            dh_buf, *split_scratch, vec_partial, w_partial, grads]
    with torch.cuda.device(index):
        err = fn(*(t.data_ptr() for t in args), rows, c, hid, *geometry,
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ln_mlp_ln_bwd kernel launch failed: CUDA error {err}")
    fused_ln_mlp_ln_bwd.launches += 1
    dg1, dbl1, dw1, db1, dw2, db2, dg2, dbl2 = torch.split(
        grads, [c, c, c * hid, hid, hid * c, c, c, c])
    return (ds, dg1.to(g1.dtype), dbl1.to(bl1.dtype),
            dw1.view(c, hid).to(w1.dtype), db1.to(b1.dtype),
            dw2.view(hid, c).to(w2.dtype), db2.to(b2.dtype),
            dg2.to(g2.dtype), dbl2.to(bl2.dtype))


fused_ln_mlp_ln_bwd.launches = 0


class FusedLnMlpLn(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX ``custom_vjp`` of ``_fused_op``).

    Saves only ``s`` and the parameters; the backward recomputes the
    forward.  First-order only: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, s, g1, bl1, w1, b1, w2, b2, g2, bl2):
        ctx.save_for_backward(s, g1, bl1, w1, b1, w2, b2, g2, bl2)
        return fused_ln_mlp_ln(s, g1, bl1, w1, b1, w2, b2, g2, bl2)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return fused_ln_mlp_ln_bwd(*ctx.saved_tensors, dout)

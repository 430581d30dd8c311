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
The weights go to the kernels as W1^T and W2^T in the stream dtype,
zero-padded to multiples of 16 (the library's ``*_padded_widths``).  A bf16
block stages both weights in shared memory where they fit one SM's 227 KB
beside its buffers (dim 128 with mlp_ratio 3: 230,144 B) and otherwise reads
them through L2 (dim 128 with mlp_ratio 4, dim 256); the f32 twins always
read them through L2.  The tile routine is shared with K7
(``csrc/tail_common.cuh``).
"""

from __future__ import annotations

import ctypes
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
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_bwd_sizes.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_ln_mlp_ln_bwd_sizes.restype = None
    lib.fused_ln_mlp_ln_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_ln_mlp_ln_bwd_stages_weights.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_bwd_stages_weights.restype = ctypes.c_int
    return lib


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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def padded_weights(w1, w2, dtype):
    """W1^T [HP, CP] and W2^T [CP, HP] in ``dtype``, zero-padded to
    multiples of 16 (the layout the tail kernels read; a no-op pad at the
    published widths)."""
    c, hid = w1.shape
    cp, hp = _pad16(c), _pad16(hid)
    w1t = F.pad(w1.t().to(dtype), (0, cp - c, 0, hp - hid)).contiguous()
    w2t = F.pad(w2.t().to(dtype), (0, hp - hid, 0, cp - c)).contiguous()
    return w1t, w2t


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
    c = s.shape[-1]
    dt = s.dtype
    lib = _kernel_lib(c, w1.shape[-1])
    rows = s.numel() // c
    out = torch.empty_like(s)
    if rows == 0:
        return out
    w1t, w2t = padded_weights(w1, w2, dt)   # nn.Linear layout, padded
    g1, bl1, b1, b2, g2, bl2 = (p.to(torch.float32).contiguous()
                                for p in (g1, bl1, b1, b2, g2, bl2))
    fn = (lib.fused_ln_mlp_ln_fwd_bf16 if dt == torch.bfloat16
          else lib.fused_ln_mlp_ln_fwd_f32)
    index = s.device.index if s.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        err = fn(s.data_ptr(), g1.data_ptr(), bl1.data_ptr(), w1t.data_ptr(),
                 b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), g2.data_ptr(),
                 bl2.data_ptr(), out.data_ptr(), rows, c, w1.shape[-1],
                 num_sms(index), torch.cuda.current_stream(index).cuda_stream)
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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _bwd_lib(c, hid)
    sizes = (ctypes.c_longlong * 4)()
    lib.fused_ln_mlp_ln_bwd_sizes(sizes)
    n_vec, n_grads, slab, w_tiles = sizes
    sms = num_sms(index)
    tiles = -(-rows // 16)
    bf16 = int(dt == torch.bfloat16)
    # a block that stages the weights fills an SM; otherwise a few a SM
    per_sm = 1 if lib.fused_ln_mlp_ln_bwd_stages_weights(bf16) else (2 if bf16 else 4)
    row_blocks = max(1, min(tiles, sms * per_sm))
    # split-K over rows for the weight gradients: 2 x w_tiles output tiles x
    # chunks blocks, about two a streaming multiprocessor
    chunks = max(1, min(-(-rows // slab), (2 * sms) // (2 * w_tiles)))
    chunk_rows = -(-max(rows, 1) // chunks)
    chunk_rows = -(-chunk_rows // slab) * slab
    w1t, w2t = padded_weights(w1, w2, dt)
    g1f, bl1f, b1f, b2f, g2f, bl2f = (p.to(torch.float32).contiguous()
                                      for p in (g1, bl1, b1, b2, g2, bl2))
    ds = torch.empty_like(s)
    x_buf = torch.empty(rows, c, dtype=dt, device=dev)
    h_buf = torch.empty(rows, hid, dtype=dt, device=dev)
    dm_buf = torch.empty(rows, c, dtype=dt, device=dev)
    dh_buf = torch.empty(rows, hid, dtype=dt, device=dev)
    vec_partial = torch.zeros(row_blocks * 8, n_vec, dtype=torch.float32, device=dev)
    w_partial = torch.empty(2, chunks, c * hid, dtype=torch.float32, device=dev)
    grads = torch.empty(n_grads, dtype=torch.float32, device=dev)
    fn = (lib.fused_ln_mlp_ln_bwd_bf16 if dt == torch.bfloat16
          else lib.fused_ln_mlp_ln_bwd_f32)
    with torch.cuda.device(index):
        err = fn(s.data_ptr(), dout.data_ptr(), g1f.data_ptr(), bl1f.data_ptr(),
                 w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
                 g2f.data_ptr(), bl2f.data_ptr(), ds.data_ptr(), x_buf.data_ptr(),
                 h_buf.data_ptr(), dm_buf.data_ptr(), dh_buf.data_ptr(),
                 vec_partial.data_ptr(), w_partial.data_ptr(), grads.data_ptr(),
                 rows, c, hid, row_blocks, chunks, chunk_rows,
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

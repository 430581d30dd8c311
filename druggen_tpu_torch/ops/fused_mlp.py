"""Fused LN -> MLP -> residual -> LN row op (the edge-stream tail), K1.

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

Forward only: the serving path runs under ``torch.inference_mode()``.  The
backward (the Pallas ``_bwd_kernel``) is ported with training.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from druggen_tpu_torch.ops import _build

_EPS = 1e-5
# The kernel's compiled widths: dim 128, mlp_ratio 3 (the published config).
KERNEL_C = 128
KERNEL_H = 384


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


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    for fn in (lib.fused_ln_mlp_ln_fwd_bf16, lib.fused_ln_mlp_ln_fwd_f32):
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_ln_mlp_ln_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_ln_mlp_ln_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda_args(s, g1, bl1, w1, b1, w2, b2, g2, bl2) -> None:
    if s.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_ln_mlp_ln kernel takes bf16 or f32, got {s.dtype}")
    c = s.shape[-1]
    hid = w1.shape[-1]
    if (c, hid) != (KERNEL_C, KERNEL_H):
        raise ValueError(f"fused_ln_mlp_ln kernel is compiled for C={KERNEL_C}, "
                         f"H={KERNEL_H}; got C={c}, H={hid}")
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
    rows = s.numel() // c
    out = torch.empty_like(s)
    if rows == 0:
        return out
    dt = s.dtype
    w1t = w1.t().to(dt).contiguous()     # W1^T [H, C], nn.Linear layout
    w2t = w2.t().to(dt).contiguous()     # W2^T [C, H]
    g1, bl1, b1, b2, g2, bl2 = (p.to(torch.float32).contiguous()
                                for p in (g1, bl1, b1, b2, g2, bl2))
    lib = _kernel_lib()
    fn = (lib.fused_ln_mlp_ln_fwd_bf16 if dt == torch.bfloat16
          else lib.fused_ln_mlp_ln_fwd_f32)
    index = s.device.index if s.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        err = fn(s.data_ptr(), g1.data_ptr(), bl1.data_ptr(), w1t.data_ptr(),
                 b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), g2.data_ptr(),
                 bl2.data_ptr(), out.data_ptr(), rows, c, w1.shape[-1],
                 _num_sms(index), torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ln_mlp_ln kernel launch failed: CUDA error {err}")
    fused_ln_mlp_ln.launches += 1
    return out


fused_ln_mlp_ln.launches = 0

"""The whole Generator forward in one wrapper call, K9.

Port of ``druggen_tpu/ops/fused_generator.py``.  Serving with ``use_pallas``
runs the Generator (reference ``models.py:71-103``, ``layers.py:108-193``)
from the one-hot inputs to the node and edge logits without the eager
modules: the input MLPs, every encoder block and the two readouts.

PRECONDITION, as in JAX: ``z_e`` is symmetric in its two vertex axes.  The
Generator symmetrises its edge embedding, ``(e + e^T) / 2``; for a symmetric
input the pointwise input MLP commutes with that, so it is skipped.  One-hot
adjacencies of real molecules are symmetric; ``debug=True`` checks it.

Rounding points, those of the Pallas kernel (JAX ``_kernel`` :121-196) and
not those of K1 or K5: every weight, bias and LayerNorm parameter is cast to
the stream dtype first; every product has stream-dtype operands, an f32 sum
and the f32 bias, and is rounded to the stream dtype (``_mm``); a LayerNorm
is computed in f32 from its stream-dtype input and rounded; the modulate
chain ``q_i * k_j * (1/sqrt(dk)) * (e + 1) * e`` is rounded after every
operation, with the scale a stream-dtype constant; the residuals
``x1 + node_mha``, ``y + y1`` and those of the two MLPs are stream-dtype
adds; the softmax over the keys is f32 from the rounded scores, and the
aggregation ``sum_j p_j v_j / sum_j p_j`` is rounded.  In f32 every rounding
is the identity.  Like JAX, the kernel applies ReLU after the input MLPs and
inside the block MLPs whatever the configured activation.

The kernel is ``csrc/fused_generator.cu`` (hand-written CUDA for sm_90a,
built per width, bf16 and f32; its header states what bounds it).  One
wrapper call issues ``2 * depth + 1`` device launches (a node pass per
depth and one after the last, an edge pass per depth) and adds one to
``fused_generator_logits.launches``: the engine expects one count per
forward.

:func:`extract_generator_weights` carries the port's Generator (or its
state_dict) into the Pallas kernel's ordered weight list (JAX
``extract_generator_weights``); :class:`GeneratorWeights` keeps that list
and packs it once per stream dtype and device for the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from druggen_tpu_torch.ops import _build
from druggen_tpu_torch.ops.fused_mlp import SMEM_LIMIT

_EPS = 1e-5

# Copied from druggen_tpu/ops/fused_generator.py (_PRE_KEYS, _BLOCK_KEYS,
# _POST_KEYS): the ordered weight layout of the kernel.
_PRE_KEYS = ("node_fc1/kernel", "node_fc1/bias", "node_fc2/kernel",
             "node_fc2/bias", "edge_fc1/kernel", "edge_fc1/bias",
             "edge_fc2/kernel", "edge_fc2/bias")
_BLOCK_KEYS = (
    "ln1/scale", "ln1/bias",
    "attn/q/kernel", "attn/q/bias", "attn/k/kernel", "attn/k/bias",
    "attn/v/kernel", "attn/v/bias", "attn/e/kernel", "attn/e/bias",
    "attn/out_e/kernel", "attn/out_e/bias",
    "attn/out_n/kernel", "attn/out_n/bias",
    "ln3/scale", "ln3/bias", "ln4/scale", "ln4/bias",
    "mlp/fc1/kernel", "mlp/fc1/bias", "mlp/fc2/kernel", "mlp/fc2/bias",
    "ln5/scale", "ln5/bias",
    "mlp2/fc1/kernel", "mlp2/fc1/bias", "mlp2/fc2/kernel", "mlp2/fc2/bias",
    "ln6/scale", "ln6/bias",
)
_POST_KEYS = ("readout_n/kernel", "readout_n/bias",
              "readout_e/kernel", "readout_e/bias")

# flax module names -> the port's (reference torch) module names
_TOP = {"node_fc1": "node_layers.0", "node_fc2": "node_layers.2",
        "edge_fc1": "edge_layers.0", "edge_fc2": "edge_layers.2",
        "readout_n": "readout_n", "readout_e": "readout_e"}
_BLOCK_PREFIX = "TransformerEncoder.Encoder_Blocks"


def _tensor(sd: dict, module: str, leaf: str) -> torch.Tensor:
    """The flax leaf ``leaf`` of ``module`` from a port state_dict:
    ``kernel`` is ``weight`` transposed to [in, out], ``scale`` is
    ``weight``, ``bias`` is ``bias``."""
    t = sd[f"{module}.{'bias' if leaf == 'bias' else 'weight'}"].detach()
    return t.t() if leaf == "kernel" else t


def extract_generator_weights(G_or_state_dict) -> tuple[list[torch.Tensor], int]:
    """The kernel's ordered weight list from the port's Generator or its
    state_dict, as JAX ``extract_generator_weights`` (:81-102) gives it from
    the flax parameters: kernels [in, out]; per-block weights stacked on a
    leading depth axis; 1-D vectors as ``[1, F]`` (``[depth, 1, F]`` in a
    block).  Returns ``(weights, depth)``."""
    sd = (G_or_state_dict.state_dict() if isinstance(G_or_state_dict, nn.Module)
          else G_or_state_dict)
    depth = len([k for k in sd if k.startswith(_BLOCK_PREFIX) and k.endswith(".ln1.weight")])

    def top(key):
        module, leaf = key.split("/")
        t = _tensor(sd, _TOP[module], leaf)
        return t[None, :] if t.ndim == 1 else t

    ws = [top(k) for k in _PRE_KEYS]
    for key in _BLOCK_KEYS:
        *mods, leaf = key.split("/")
        stacked = torch.stack([_tensor(sd, f"{_BLOCK_PREFIX}.{d}.{'.'.join(mods)}", leaf)
                               for d in range(depth)])
        ws.append(stacked[:, None, :] if stacked.ndim == 2 else stacked)
    ws += [top(k) for k in _POST_KEYS]
    return ws, depth


def _split(weights):
    """(pre, blocks, post): 8 tensors, a dict by _BLOCK_KEYS name, 4 tensors."""
    pre = weights[:len(_PRE_KEYS)]
    blocks = dict(zip(_BLOCK_KEYS, weights[len(_PRE_KEYS):len(_PRE_KEYS) + len(_BLOCK_KEYS)]))
    post = weights[len(_PRE_KEYS) + len(_BLOCK_KEYS):]
    return pre, blocks, post


def stream_scale(dk: int, dtype) -> float:
    """``1/sqrt(dk)`` as the kernel multiplies by it: a constant of the
    stream dtype (jnp converts the Python float to the array's dtype)."""
    return float(torch.tensor(1.0 / math.sqrt(dk), dtype=dtype))


def fused_generator_logits_reference(weights, depth: int, z_e, z_n, *, heads: int):
    """Plain PyTorch version of K9 with the Pallas kernel's rounding points
    (see the module docstring).  ``weights``: the list of
    :func:`extract_generator_weights`; ``z_e`` [B, N, N, b_dim] (symmetric),
    ``z_n`` [B, N, m_dim], both in the stream dtype.  Returns
    ``(node_logits [B, N, m_dim], edge_logits [B, N, N, b_dim])`` in it.
    Computed in f32 on values rounded to the stream dtype, so every product
    term is exact and only the f32 sums' order can differ from the kernel."""
    dt, f32 = z_e.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    def mm(a, w, b):
        return rnd(a @ w + b.reshape(-1))

    def ln(x, s, b):
        return rnd(F.layer_norm(x, (x.shape[-1],), s.reshape(-1), b.reshape(-1), _EPS))

    pre, blocks, post = _split([rnd(w.to(z_e.device)) for w in weights])
    w_nf1, b_nf1, w_nf2, b_nf2, w_ef1, b_ef1, w_ef2, b_ef2 = pre
    w_rn, b_rn, w_re, b_re = post
    dim = w_nf2.shape[-1]
    scale = stream_scale(dim // heads, dt)
    x = torch.relu(mm(torch.relu(mm(z_n.to(f32), w_nf1, b_nf1)), w_nf2, b_nf2))
    y = torch.relu(mm(torch.relu(mm(z_e.to(f32), w_ef1, b_ef1)), w_ef2, b_ef2))
    for d in range(depth):
        p = {key: w[d] for key, w in blocks.items()}
        x1 = ln(x, p["ln1/scale"], p["ln1/bias"])
        q, k, v = (mm(x1, p[f"attn/{n}/kernel"], p[f"attn/{n}/bias"]) for n in "qkv")
        e = mm(y, p["attn/e/kernel"], p["attn/e/bias"])
        att = rnd(q[:, :, None] * k[:, None])
        att = rnd(att * scale)
        att = rnd(att * rnd(e + 1.0))
        att = rnd(att * e)
        y1 = mm(att, p["attn/out_e/kernel"], p["attn/out_e/bias"])
        ex = torch.exp(att - att.amax(dim=2, keepdim=True))
        agg = rnd((ex * v[:, None]).sum(dim=2) / ex.sum(dim=2))
        node_mha = mm(agg, p["attn/out_n/kernel"], p["attn/out_n/bias"])
        x2 = ln(rnd(x1 + node_mha), p["ln3/scale"], p["ln3/bias"])
        y2 = ln(rnd(y + y1), p["ln4/scale"], p["ln4/bias"])
        xh = torch.relu(mm(x2, p["mlp/fc1/kernel"], p["mlp/fc1/bias"]))
        x = ln(rnd(x2 + mm(xh, p["mlp/fc2/kernel"], p["mlp/fc2/bias"])),
               p["ln5/scale"], p["ln5/bias"])
        yh = torch.relu(mm(y2, p["mlp2/fc1/kernel"], p["mlp2/fc1/bias"]))
        y = ln(rnd(y2 + mm(yh, p["mlp2/fc2/kernel"], p["mlp2/fc2/bias"])),
               p["ln6/scale"], p["ln6/bias"])
    return mm(x, w_rn, b_rn).to(dt), mm(y, w_re, b_re).to(dt)


# ---------------------------------------------------------------- packing

def _pad16(n: int) -> int:
    return -(-n // 16) * 16


# The order in which the kernel finds the matrices and the vectors (its
# MAT_* and VEC_* indices): the input MLPs, then per depth, then the readouts.
_MATS_PRE = ("node_fc1/kernel", "node_fc2/kernel", "edge_fc1/kernel", "edge_fc2/kernel")
_VECS_PRE = ("node_fc1/bias", "node_fc2/bias", "edge_fc1/bias", "edge_fc2/bias")
_MATS_BLOCK = ("attn/q/kernel", "attn/k/kernel", "attn/v/kernel", "attn/e/kernel",
               "attn/out_e/kernel", "attn/out_n/kernel", "mlp/fc1/kernel",
               "mlp/fc2/kernel", "mlp2/fc1/kernel", "mlp2/fc2/kernel")
_VECS_BLOCK = ("ln1/scale", "ln1/bias", "attn/q/bias", "attn/k/bias", "attn/v/bias",
               "attn/e/bias", "attn/out_e/bias", "attn/out_n/bias", "ln3/scale",
               "ln3/bias", "ln4/scale", "ln4/bias", "mlp/fc1/bias", "mlp/fc2/bias",
               "ln5/scale", "ln5/bias", "mlp2/fc1/bias", "mlp2/fc2/bias",
               "ln6/scale", "ln6/bias")
_MATS_POST = ("readout_n/kernel", "readout_e/kernel")
_VECS_POST = ("readout_n/bias", "readout_e/bias")
_ALIGN = 64         # elements: every packed matrix starts 128-byte aligned


class _Packed:
    """The weights as the kernel reads them: each matrix [in, out] as W^T
    [pad16(out), pad16(in)] in the stream dtype (zeros in the padding), each
    vector as f32 holding stream-dtype values, and the element offset of
    each in its buffer (int64, on the device)."""

    def __init__(self, weights, depth: int, dtype, device):
        by_key = dict(zip(_PRE_KEYS, weights[:8]))
        by_key.update(zip(_POST_KEYS, weights[8 + len(_BLOCK_KEYS):]))
        blocks = dict(zip(_BLOCK_KEYS, weights[8:8 + len(_BLOCK_KEYS)]))

        def mats():
            yield from (by_key[k] for k in _MATS_PRE)
            for d in range(depth):
                yield from (blocks[k][d] for k in _MATS_BLOCK)
            yield from (by_key[k] for k in _MATS_POST)

        def vecs():
            yield from (by_key[k].reshape(-1) for k in _VECS_PRE)
            for d in range(depth):
                yield from (blocks[k][d].reshape(-1) for k in _VECS_BLOCK)
            yield from (by_key[k].reshape(-1) for k in _VECS_POST)

        parts, offsets, at = [], [], 0
        for w in mats():
            k_in, n_out = w.shape
            wt = F.pad(w.t().to(device=device, dtype=dtype),
                       (0, _pad16(k_in) - k_in, 0, _pad16(n_out) - n_out)).reshape(-1)
            offsets.append(at)
            size = -(-wt.numel() // _ALIGN) * _ALIGN
            parts.append(F.pad(wt, (0, size - wt.numel())))
            at += size
        self.wts = torch.cat(parts).contiguous()
        self.woff = torch.tensor(offsets, dtype=torch.int64, device=device)
        vparts, voffsets, at = [], [], 0
        for v in vecs():
            voffsets.append(at)
            size = -(-v.numel() // 4) * 4
            vparts.append(F.pad(v.to(device=device, dtype=dtype).to(torch.float32),
                                (0, size - v.numel())))
            at += size
        self.vecs = torch.cat(vparts).contiguous()
        self.voff = torch.tensor(voffsets, dtype=torch.int64, device=device)


class GeneratorWeights:
    """:func:`extract_generator_weights`'s ``(weights, depth)``, with the
    kernel's packed buffers made once per (stream dtype, device)."""

    def __init__(self, weights, depth: int):
        self.weights = list(weights)
        self.depth = depth
        self.m_dim = self.weights[0].shape[0]      # node_fc1 [m_dim, 64]
        self.dim = self.weights[2].shape[-1]       # node_fc2 [64, dim]
        self.b_dim = self.weights[4].shape[0]      # edge_fc1 [b_dim, 64]
        self.hidden = self.weights[8 + _BLOCK_KEYS.index("mlp2/fc1/kernel")].shape[-1]
        self._packed: dict = {}

    @classmethod
    def of(cls, G_or_weights) -> "GeneratorWeights":
        """From a Generator, a state_dict, a ``(weights, depth)`` pair or an
        instance (returned as it is)."""
        if isinstance(G_or_weights, cls):
            return G_or_weights
        if isinstance(G_or_weights, tuple):
            return cls(*G_or_weights)
        return cls(*extract_generator_weights(G_or_weights))

    def packed(self, dtype, device) -> _Packed:
        key = (dtype, torch.device(device))
        if key not in self._packed:
            self._packed[key] = _Packed(self.weights, self.depth, dtype, device)
        return self._packed[key]


# ---------------------------------------------------------------- the kernel

@functools.cache
def _kernel_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_generator", {"KERNEL_C": c, "KERNEL_H": h})
    for fn in (lib.fused_generator_bf16, lib.fused_generator_f32):
        fn.argtypes = ([ctypes.c_void_p] * 14
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_generator_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_generator_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_cuda_args(gw: GeneratorWeights, z_e, z_n, heads: int) -> None:
    dt = z_e.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_generator_logits kernel takes bf16 or f32, got {dt}")
    if z_e.ndim != 4 or z_e.shape[1] != z_e.shape[2] or z_e.shape[-1] != gw.b_dim:
        raise ValueError(f"z_e is {tuple(z_e.shape)}, expected [B, N, N, {gw.b_dim}]")
    b, n = z_e.shape[:2]
    if tuple(z_n.shape) != (b, n, gw.m_dim) or z_n.device != z_e.device:
        raise ValueError(f"z_n is {tuple(z_n.shape)} on {z_n.device}, expected "
                         f"{(b, n, gw.m_dim)} on {z_e.device}")
    if gw.dim % heads or gw.dim % 16:
        raise ValueError(f"dim {gw.dim} must be a multiple of heads {heads} and of 16")


def fused_generator_logits(G_or_weights, z_e, z_n, *, heads: int, debug: bool = False):
    """The whole Generator forward: ``(node_logits [B, N, m_dim],
    edge_logits [B, N, N, b_dim])`` in the stream dtype of ``z_e``, as JAX
    ``fused_generator_logits`` (:199-267).

    ``G_or_weights``: the port's Generator, its state_dict, the
    ``(weights, depth)`` of :func:`extract_generator_weights` or a
    :class:`GeneratorWeights`.  ``z_e`` [B, N, N, b_dim] one-hot adjacency
    (must be vertex-symmetric; ``debug=True`` checks it and raises
    ``AssertionError``, as JAX asserts), ``z_n``
    [B, N, m_dim].  A CPU tensor takes the plain version; a CUDA tensor
    launches K9 (counted in ``fused_generator_logits.launches``, one a
    forward) or raises."""
    gw = GeneratorWeights.of(G_or_weights)
    if debug and not torch.equal(z_e, z_e.transpose(1, 2)):
        raise AssertionError("fused generator requires symmetric z_e")
    z_n = z_n.to(z_e.dtype)
    if z_e.device.type == "cpu":
        return fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=heads)
    if z_e.device.type != "cuda":
        raise ValueError(f"fused_generator_logits runs on cpu or cuda, not {z_e.device}")
    _check_cuda_args(gw, z_e, z_n, heads)
    dt, dev = z_e.dtype, z_e.device
    b, n = z_e.shape[:2]
    c, h, depth = gw.dim, gw.hidden, gw.depth
    lib = _kernel_lib(c, h)
    bf16 = int(dt == torch.bfloat16)
    if lib.fused_generator_smem_bytes(n, gw.m_dim, gw.b_dim, bf16) > SMEM_LIMIT:
        raise ValueError(f"fused_generator_logits kernel at N={n}, dim {c}, hidden {h}, "
                         f"{dt} needs more than {SMEM_LIMIT:,} B of shared memory")
    pk = gw.packed(dt, dev)
    z_e, z_n = z_e.contiguous(), z_n.contiguous()
    out_n = torch.empty(b, n, gw.m_dim, dtype=dt, device=dev)
    out_e = torch.empty(b, n, n, gw.b_dim, dtype=dt, device=dev)
    if b == 0:
        return out_n, out_e
    # node-stream scratch (x1, q, k, v, agg) and, between depths, the edge stream
    node = torch.empty(5, b, n, c, dtype=dt, device=dev)
    ys = torch.empty(b, n, n, c, dtype=dt, device=dev) if depth > 1 else node[0]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fn = lib.fused_generator_bf16 if bf16 else lib.fused_generator_f32
    with torch.cuda.device(index):
        err = fn(z_n.data_ptr(), z_e.data_ptr(), pk.wts.data_ptr(), pk.vecs.data_ptr(),
                 pk.woff.data_ptr(), pk.voff.data_ptr(), out_n.data_ptr(), out_e.data_ptr(),
                 *(node[i].data_ptr() for i in range(5)), ys.data_ptr(),
                 b, n, gw.m_dim, gw.b_dim, c, h, depth, stream_scale(c // heads, dt),
                 torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_generator_logits kernel launch failed: CUDA error {err}")
    fused_generator_logits.launches += 1
    return out_n, out_e


fused_generator_logits.launches = 0

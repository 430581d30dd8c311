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

Two routes on the card (:func:`hopper_route`, the shape rule).  bf16 at
dim 128 with N <= 64 and b_dim <= 7 (the published serving shape) runs the
Hopper route:
per depth a node pass (``csrc/fused_generator.cu``), an edge-attention and
an edge-tail launch (``csrc/fused_generator_hopper.cu``: ``wgmma`` with
staged weights, 64-row slab tiles for the attention, K1's staged plan on
flat 64-row tiles for the tail; its header states the plan and what bounds
it), and a last node pass: ``3 * depth + 1`` device launches; the geometry
is :func:`launch_plan`, and :class:`PlainStages` is the plain version launch
by launch.  f32, the other widths and N > 64 run the generic kernels
(``csrc/fused_generator.cu``, built per width): ``2 * depth + 1`` launches
(a node pass per depth and one after the last, an edge pass per depth).
Either way one wrapper call adds one to ``fused_generator_logits.launches``:
the engine expects one count per forward.

:func:`extract_generator_weights` carries the port's Generator (or its
state_dict) into the Pallas kernel's ordered weight list (JAX
``extract_generator_weights``); :class:`GeneratorWeights` keeps that list
and packs it once per stream dtype and device for the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from druggen_tpu_torch.ops import _build
from druggen_tpu_torch.ops.fused_mlp import SMEM_LIMIT, num_sms
from druggen_tpu_torch.ops.fused_mlp import launch_plan as mlp_launch_plan

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


class PlainStages:
    """The plain version of K9 by launch, with the Pallas kernel's rounding
    points (see the module docstring): :meth:`node` is a node pass,
    :meth:`edge_attention` and :meth:`edge_tail` a depth's two edge launches
    on the Hopper route (:func:`hopper_route`).
    :func:`fused_generator_logits_reference` composes them.  Every stage
    computes in f32 on values rounded to the stream dtype ``dtype``, so
    every product term is exact and only the f32 sums' order can differ
    from a kernel; it takes its inputs in any dtype and returns f32 tensors
    of stream-dtype values (handing them on in the stream dtype loses
    nothing)."""

    def __init__(self, weights, depth: int, dtype, device, *, heads: int):
        self.dt, self.depth = dtype, depth
        pre, self._blocks, post = _split([self._rnd(w.to(device)) for w in weights])
        (self.w_nf1, self.b_nf1, self.w_nf2, self.b_nf2,
         self.w_ef1, self.b_ef1, self.w_ef2, self.b_ef2) = pre
        self.w_rn, self.b_rn, self.w_re, self.b_re = post
        self.scale = stream_scale(self.w_nf2.shape[-1] // heads, dtype)

    def _rnd(self, t):
        return t.to(self.dt).to(torch.float32)

    def _mm(self, a, w, b):
        return self._rnd(a @ w + b.reshape(-1))

    def _ln(self, x, s, b):
        return self._rnd(F.layer_norm(x, (x.shape[-1],), s.reshape(-1), b.reshape(-1), _EPS))

    def _block(self, d: int) -> dict:
        return {key: w[d] for key, w in self._blocks.items()}

    def node(self, d: int, z_n=None, x1=None, agg=None):
        """Node pass ``d`` of ``0..depth``: from ``z_n`` [B, N, m_dim] (d 0)
        or from the previous depth's ``x1`` and ``agg`` [B, N, C] (its
        out_n, residual, LN3 -> MLP -> LN5), to ``(x1, q, k, v)`` of depth
        ``d``, or to the node logits [B, N, m_dim] after the last depth."""
        f32, rnd, mm, ln = torch.float32, self._rnd, self._mm, self._ln
        if d == 0:
            x = torch.relu(mm(torch.relu(mm(z_n.to(f32), self.w_nf1, self.b_nf1)),
                              self.w_nf2, self.b_nf2))
        else:
            p = self._block(d - 1)
            x1, agg = x1.to(f32), agg.to(f32)
            node_mha = mm(agg, p["attn/out_n/kernel"], p["attn/out_n/bias"])
            x2 = ln(rnd(x1 + node_mha), p["ln3/scale"], p["ln3/bias"])
            xh = torch.relu(mm(x2, p["mlp/fc1/kernel"], p["mlp/fc1/bias"]))
            x = ln(rnd(x2 + mm(xh, p["mlp/fc2/kernel"], p["mlp/fc2/bias"])),
                   p["ln5/scale"], p["ln5/bias"])
        if d == self.depth:
            return mm(x, self.w_rn, self.b_rn)
        p = self._block(d)
        x1 = ln(x, p["ln1/scale"], p["ln1/bias"])
        return (x1, *(mm(x1, p[f"attn/{n}/kernel"], p[f"attn/{n}/bias"]) for n in "qkv"))

    def edge_input(self, z_e):
        """The edge input MLP of ``z_e`` [B, N, N, b_dim] -> [B, N, N, C]."""
        mm = self._mm
        return torch.relu(mm(torch.relu(mm(z_e.to(torch.float32), self.w_ef1, self.b_ef1)),
                             self.w_ef2, self.b_ef2))

    def edge_attention(self, d: int, q, k, v, y=None, z_e=None):
        """Depth ``d``'s edge attention: the edge rows ``y`` [B, N, N, C]
        (at d 0 the input MLP of ``z_e``) and ``q, k, v`` [B, N, C] ->
        ``(s, agg)``: ``s = round(y + out_e(t))`` [B, N, N, C] and the
        aggregation [B, N, C]."""
        f32, rnd, mm = torch.float32, self._rnd, self._mm
        y = self.edge_input(z_e) if d == 0 else y.to(f32)
        q, k, v = q.to(f32), k.to(f32), v.to(f32)
        p = self._block(d)
        e = mm(y, p["attn/e/kernel"], p["attn/e/bias"])
        att = rnd(q[:, :, None] * k[:, None])
        att = rnd(att * self.scale)
        att = rnd(att * rnd(e + 1.0))
        att = rnd(att * e)
        y1 = mm(att, p["attn/out_e/kernel"], p["attn/out_e/bias"])
        ex = torch.exp(att - att.amax(dim=2, keepdim=True))
        agg = rnd((ex * v[:, None]).sum(dim=2) / ex.sum(dim=2))
        return rnd(y + y1), agg

    def edge_tail(self, d: int, s):
        """Depth ``d``'s edge tail: ``s`` [B, N, N, C] through LN4 -> MLP2
        -> LN6, to the next depth's rows, or after the last depth to the
        edge logits [B, N, N, b_dim]."""
        mm, ln, rnd = self._mm, self._ln, self._rnd
        p = self._block(d)
        y2 = ln(s.to(torch.float32), p["ln4/scale"], p["ln4/bias"])
        yh = torch.relu(mm(y2, p["mlp2/fc1/kernel"], p["mlp2/fc1/bias"]))
        y = ln(rnd(y2 + mm(yh, p["mlp2/fc2/kernel"], p["mlp2/fc2/bias"])),
               p["ln6/scale"], p["ln6/bias"])
        return mm(y, self.w_re, self.b_re) if d == self.depth - 1 else y


def fused_generator_logits_reference(weights, depth: int, z_e, z_n, *, heads: int):
    """Plain PyTorch version of K9 with the Pallas kernel's rounding points
    (see the module docstring): :class:`PlainStages` composed in the
    kernel's order.  ``weights``: the list of
    :func:`extract_generator_weights`; ``z_e`` [B, N, N, b_dim] (symmetric),
    ``z_n`` [B, N, m_dim], both in the stream dtype.  Returns
    ``(node_logits [B, N, m_dim], edge_logits [B, N, N, b_dim])`` in it."""
    if depth < 1:
        raise ValueError(f"the Generator has at least one block, got depth {depth}")
    dt = z_e.dtype
    st = PlainStages(weights, depth, dt, z_e.device, heads=heads)
    x1, q, k, v = st.node(0, z_n)
    y = None
    for d in range(depth):
        s, agg = st.edge_attention(d, q, k, v, y=y, z_e=z_e)
        y = st.edge_tail(d, s)
        out = st.node(d + 1, x1=x1, agg=agg)
        if d + 1 < depth:
            x1, q, k, v = out
    return out.to(dt), y.to(dt)


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
    each in its buffer (int64, on the device, and a host copy from which the
    Hopper route's launches take their parameters' addresses)."""

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
        self.woff_host = torch.tensor(offsets, dtype=torch.int64)
        vparts, voffsets, at = [], [], 0
        for v in vecs():
            voffsets.append(at)
            size = -(-v.numel() // 4) * 4
            vparts.append(F.pad(v.to(device=device, dtype=dtype).to(torch.float32),
                                (0, size - v.numel())))
            at += size
        self.vecs = torch.cat(vparts).contiguous()
        self.voff = torch.tensor(voffsets, dtype=torch.int64, device=device)
        self.voff_host = torch.tensor(voffsets, dtype=torch.int64)


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


# ---------------------------------------------------------------- the route

# The Hopper route's geometry (csrc/fused_generator_hopper.cu holds the same
# constants; its shared memory is the library's own: library_plan).
HOPPER_C = 128          # the stream width the route is built for
TILE_ROWS = 64          # rows a tile: a slab's keys (N at most this), or flat edge rows
WARPGROUPS = 2          # warpgroups a block of both edge launches, a tile each
MAX_B_DIM = 7           # one-hot bond width whose edge-readout weights fit beside
                        # the tail's K1 layout (the input MLP takes up to 16)


def hopper_route(n: int, c: int, h: int, dtype, b_dim: int) -> bool:
    """The shape rule of K9 on the card: bf16 at C = 128 with a hidden width
    that K1's staged plan takes (a multiple of 64 whose W1, W2 fit one SM
    beside two 64-row tiles: ``fused_mlp.launch_plan``), 1 <= N <= 64 and
    b_dim <= 7 runs the Hopper edge launches of
    ``csrc/fused_generator_hopper.cu``; f32, the other widths and N > 64
    run the generic kernels (``csrc/fused_generator.cu``)."""
    if dtype != torch.bfloat16 or c != HOPPER_C or h % 64 or not 1 <= n <= TILE_ROWS:
        return False
    tail = mlp_launch_plan(c, h, 0, 1)
    return 1 <= b_dim <= MAX_B_DIM and tail.fwd_staged and tail.warpgroups == WARPGROUPS


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Launch geometry and device scratch of K9 on the Hopper route for
    ``batch`` graphs of ``n`` atoms at C = ``c``, H = ``h``, ``depth``
    blocks, on ``num_sms`` SMs."""
    c: int
    h: int
    batch: int
    n: int
    depth: int
    slabs: int              # (b, i) slabs of the attention launch, a 64-row tile each
    rows: int               # edge rows, batch * n * n
    attn_grid: int          # persistent blocks of the attention launch
    tiles: int              # flat 64-row tiles of the tail launch
    tail_grid: int          # persistent blocks of the tail launch
    warpgroups: int
    node_blocks: int        # node pass: a block a graph
    node_scratch_bytes: int   # x1, q, k, v, agg [B, N, C]
    edge_scratch_bytes: int   # s and the rows between depths [B N N, C]

    @property
    def device_launches(self) -> int:
        """Node, attention and tail a depth, and a last node pass."""
        return 3 * self.depth + 1


@functools.cache
def launch_plan(c: int, h: int, batch: int, n: int, depth: int, num_sms: int) -> LaunchPlan:
    """The geometry of ``csrc/fused_generator_hopper.cu``'s launches (its
    header explains it): the attention a persistent block an SM over
    contiguous runs of slabs, its two warpgroups taking them in turn; the
    tail K1's plan, flat 64-row tiles over all edge rows, two warpgroups a
    block; the node pass a block a graph.  Scratch in bf16: the node
    stream's five [B, N, C] tensors and one [B N N, C] buffer for s and the
    rows between depths (written in place)."""
    if c <= 0 or h <= 0 or batch < 0 or n <= 0 or depth <= 0:
        raise ValueError(f"K9 takes C, H, N, depth > 0 and batch >= 0, got C {c}, H {h}, "
                         f"batch {batch}, N {n}, depth {depth}")
    slabs, rows = batch * n, batch * n * n
    tiles = -(-rows // TILE_ROWS)
    return LaunchPlan(
        c=c, h=h, batch=batch, n=n, depth=depth, slabs=slabs, rows=rows,
        attn_grid=max(1, min(num_sms, slabs)), tiles=tiles,
        tail_grid=max(1, min(num_sms, -(-tiles // WARPGROUPS))), warpgroups=WARPGROUPS,
        node_blocks=batch, node_scratch_bytes=5 * slabs * c * 2, edge_scratch_bytes=rows * c * 2)


# ---------------------------------------------------------------- the kernels

@functools.cache
def _kernel_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_generator", {"KERNEL_C": c, "KERNEL_H": h})
    for fn in (lib.fused_generator_bf16, lib.fused_generator_f32):
        fn.argtypes = ([ctypes.c_void_p] * 14
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_generator_node_bf16.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_generator_node_bf16.restype = ctypes.c_int
    lib.fused_generator_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_generator_smem_bytes.restype = ctypes.c_longlong
    lib.fused_generator_node_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fused_generator_node_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _hopper_lib(c: int, h: int) -> ctypes.CDLL:
    lib = _build.load("fused_generator_hopper", {"KERNEL_C": c, "KERNEL_H": h})
    lib.fused_generator_hopper_attn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_generator_hopper_tail.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    for fn in (lib.fused_generator_hopper_attn, lib.fused_generator_hopper_tail,
               lib.fused_generator_hopper_route):
        fn.restype = ctypes.c_int
    lib.fused_generator_hopper_route.argtypes = []
    for fn in (lib.fused_generator_hopper_attn_smem_bytes,
               lib.fused_generator_hopper_tail_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    return lib


def library_plan(c: int, h: int, n: int, m_dim: int) -> dict:
    """The route's shared memory a block (node pass at ``n`` atoms and
    ``m_dim`` atom types, attention, tail) and whether the library at
    (``c``, ``h``) takes the route, as the libraries compute them."""
    lib, hlib = _kernel_lib(c, h), _hopper_lib(c, h)
    return {"node_smem": lib.fused_generator_node_smem_bytes(n, m_dim),
            "attn_smem": hlib.fused_generator_hopper_attn_smem_bytes(),
            "tail_smem": hlib.fused_generator_hopper_tail_smem_bytes(),
            "route": bool(hlib.fused_generator_hopper_route())}


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


def _stream(dev) -> tuple:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_generator_logits {what} launch failed: CUDA error {err}")


def _check_buffers(*named) -> None:
    """Each ``(name, tensor, shape, dtype)``: on one CUDA device,
    contiguous, of that shape and dtype (before its pointer goes to a
    launch)."""
    device = named[0][1].device
    for name, t, shape, dtype in named:
        if (t.device != device or device.type != "cuda" or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape) or t.dtype != dtype):
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"(contiguous {t.is_contiguous()}), expected {tuple(shape)} "
                             f"{dtype}, contiguous, on {device} (cuda)")


def node_pass(gw: GeneratorWeights, d: int, z_n, node, out_n) -> None:
    """Node pass ``d`` of ``0..depth`` on the card (fused_generator.cu's node kernel),
    bf16: from ``z_n`` (d 0) or the previous depth's x1 and agg in ``node``
    [5, B, N, C] (x1, q, k, v, agg) to x1, q, k, v of depth ``d`` in
    ``node``, or the node logits into ``out_n`` [B, N, m_dim] (d = depth).
    One device launch; not counted (the forward is)."""
    dev, bf16 = z_n.device, torch.bfloat16
    b, n = z_n.shape[:2]
    _check_buffers(("z_n", z_n, (b, n, gw.m_dim), bf16),
                   ("node", node, (5, b, n, gw.dim), bf16),
                   ("out_n", out_n, (b, n, gw.m_dim), bf16))
    pk = gw.packed(bf16, dev)
    index, stream = _stream(dev)
    with torch.cuda.device(index):
        err = _kernel_lib(gw.dim, gw.hidden).fused_generator_node_bf16(
            z_n.data_ptr(), pk.wts.data_ptr(), pk.vecs.data_ptr(), pk.woff.data_ptr(),
            pk.voff.data_ptr(), out_n.data_ptr(), *(node[i].data_ptr() for i in range(5)),
            b, n, gw.m_dim, gw.dim, gw.hidden, gw.depth, d, stream)
    _raise_on(err, f"node pass {d}")


def edge_attention_pass(gw: GeneratorWeights, d: int, z_e, node, ys, *, heads: int) -> None:
    """Depth ``d``'s edge-attention launch on the Hopper route: the edge
    rows (at d 0 the input MLP of ``z_e``, else ``ys`` [B N N, C]) and q, k,
    v of ``node`` to s (over ``ys``) and agg (``node[4]``).  bf16 only."""
    dev, bf16 = z_e.device, torch.bfloat16
    b, n = z_e.shape[:2]
    _check_buffers(("z_e", z_e, (b, n, n, gw.b_dim), bf16), ("node", node, (5, b, n, gw.dim), bf16),
                   ("ys", ys, (b * n * n, gw.dim), bf16))
    pk = gw.packed(bf16, dev)
    index, stream = _stream(dev)
    plan = launch_plan(gw.dim, gw.hidden, b, n, gw.depth, num_sms(index))
    with torch.cuda.device(index):
        err = _hopper_lib(gw.dim, gw.hidden).fused_generator_hopper_attn(
            z_e.data_ptr(), pk.wts.data_ptr(), pk.vecs.data_ptr(), pk.woff_host.data_ptr(),
            pk.voff_host.data_ptr(), node[1].data_ptr(), node[2].data_ptr(), node[3].data_ptr(),
            node[4].data_ptr(), ys.data_ptr(), b, n, gw.b_dim, gw.dim, gw.hidden, d,
            stream_scale(gw.dim // heads, torch.bfloat16), plan.attn_grid, stream)
    _raise_on(err, f"edge attention {d}")


def edge_tail_pass(gw: GeneratorWeights, d: int, ys, out_e) -> None:
    """Depth ``d``'s edge-tail launch on the Hopper route: s in ``ys``
    [B N N, C] through LN4 -> MLP2 -> LN6 to the next depth's rows (over
    ``ys``) or, after the last depth, to the edge logits ``out_e`` [B, N,
    N, b_dim].  bf16 only."""
    dev, bf16 = ys.device, torch.bfloat16
    b, n = out_e.shape[:2]
    _check_buffers(("ys", ys, (b * n * n, gw.dim), bf16),
                   ("out_e", out_e, (b, n, n, gw.b_dim), bf16))
    pk = gw.packed(bf16, dev)
    index, stream = _stream(dev)
    plan = launch_plan(gw.dim, gw.hidden, b, n, gw.depth, num_sms(index))
    with torch.cuda.device(index):
        err = _hopper_lib(gw.dim, gw.hidden).fused_generator_hopper_tail(
            ys.data_ptr(), pk.wts.data_ptr(), pk.vecs.data_ptr(), pk.woff_host.data_ptr(),
            pk.voff_host.data_ptr(), out_e.data_ptr(), b, n, gw.b_dim, gw.dim, gw.hidden,
            gw.depth, d, plan.tail_grid, stream)
    _raise_on(err, f"edge tail {d}")


def _hopper_launches(gw: GeneratorWeights, z_e, z_n, out_n, out_e, heads: int):
    """K9's Hopper route in launch order: yields ``(stage, d, node, ys,
    launch)`` for each device launch (node, attention, tail a depth, then a
    last node pass), with the scratch it works on (``node`` [5, B, N, C]:
    x1, q, k, v, agg; ``ys`` [B N N, C]) and ``launch()``, which makes it.
    The forward calls each ``launch``; :func:`route_by_launch` wraps them."""
    b, n = z_e.shape[:2]
    node = torch.empty(5, b, n, gw.dim, dtype=z_e.dtype, device=z_e.device)
    ys = torch.empty(b * n * n, gw.dim, dtype=z_e.dtype, device=z_e.device)
    for d in range(gw.depth):
        yield "node", d, node, ys, functools.partial(node_pass, gw, d, z_n, node, out_n)
        yield "attention", d, node, ys, functools.partial(
            edge_attention_pass, gw, d, z_e, node, ys, heads=heads)
        yield "tail", d, node, ys, functools.partial(edge_tail_pass, gw, d, ys, out_e)
    yield "node", gw.depth, node, ys, functools.partial(node_pass, gw, gw.depth, z_n, node, out_n)


def _hopper_forward(gw: GeneratorWeights, z_e, z_n, out_n, out_e, heads: int) -> None:
    n = z_e.shape[1]
    lp = library_plan(gw.dim, gw.hidden, n, gw.m_dim)
    if not lp["route"]:
        raise ValueError(f"the fused_generator_hopper library at dim {gw.dim}, hidden "
                         f"{gw.hidden} does not take the Hopper route")
    if max(lp["node_smem"], lp["attn_smem"], lp["tail_smem"]) > SMEM_LIMIT:
        raise ValueError(f"fused_generator_logits Hopper route at N={n}, dim {gw.dim}, hidden "
                         f"{gw.hidden} needs more than {SMEM_LIMIT:,} B of shared memory: {lp}")
    for *_, launch in _hopper_launches(gw, z_e, z_n, out_n, out_e, heads):
        launch()


def route_by_launch(gw: GeneratorWeights, z_e, z_n, check, *, heads: int):
    """K9's Hopper route one launch at a time (the forward's own sequence,
    :func:`_hopper_launches`), for checking the kernels: after each launch
    ``check(label, kernel_output, stage_output)`` with the launch's plain
    stage (:class:`PlainStages`) run on the kernel's own inputs.  ``z_e``,
    ``z_n``: bf16 on the card.  Returns the logits, which are the
    forward's.  Not counted."""
    dt, dev = z_e.dtype, z_e.device
    b, n = z_e.shape[:2]
    c, depth = gw.dim, gw.depth
    st = PlainStages(gw.weights, depth, dt, dev, heads=heads)
    out_n = torch.empty(b, n, gw.m_dim, dtype=dt, device=dev)
    out_e = torch.empty(b, n, n, gw.b_dim, dtype=dt, device=dev)
    for stage, d, node, ys, launch in _hopper_launches(gw, z_e, z_n, out_n, out_e, heads):
        if stage == "node":
            x1_in, agg_in = (node[0].clone(), node[4].clone()) if d else (None, None)
            launch()
            ref = st.node(d, z_n) if d == 0 else st.node(d, x1=x1_in, agg=agg_in)
            if d == depth:
                check(f"node pass {d}", out_n, ref)
            else:
                for i, r_ in enumerate(ref):
                    check(f"node pass {d}, output {i}", node[i], r_)
        elif stage == "attention":
            y_in = ys.clone().reshape(b, n, n, c) if d else None
            launch()
            s_ref, agg_ref = st.edge_attention(d, node[1], node[2], node[3], y=y_in, z_e=z_e)
            check(f"attention {d}, s", ys.reshape(b, n, n, c), s_ref)
            check(f"attention {d}, agg", node[4], agg_ref)
            del y_in, s_ref
        else:
            s_in = ys.clone().reshape(b, n, n, c)
            launch()
            check(f"tail {d}", out_e if d == depth - 1 else ys.reshape(b, n, n, c),
                  st.edge_tail(d, s_in))
            del s_in
    return out_n, out_e


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
    forward): on the Hopper route (:func:`hopper_route`) ``3 * depth + 1``
    device launches, else the generic kernels' ``2 * depth + 1``; or it
    raises."""
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
    z_e, z_n = z_e.contiguous(), z_n.contiguous()
    out_n = torch.empty(b, n, gw.m_dim, dtype=dt, device=dev)
    out_e = torch.empty(b, n, n, gw.b_dim, dtype=dt, device=dev)
    if b == 0:
        return out_n, out_e
    if hopper_route(n, c, h, dt, gw.b_dim):
        _hopper_forward(gw, z_e, z_n, out_n, out_e, heads)
        fused_generator_logits.launches += 1
        return out_n, out_e
    lib = _kernel_lib(c, h)
    bf16 = int(dt == torch.bfloat16)
    if lib.fused_generator_smem_bytes(n, gw.m_dim, gw.b_dim, bf16) > SMEM_LIMIT:
        raise ValueError(f"fused_generator_logits kernel at N={n}, dim {c}, hidden {h}, "
                         f"{dt} needs more than {SMEM_LIMIT:,} B of shared memory")
    pk = gw.packed(dt, dev)
    # node-stream scratch (x1, q, k, v, agg) and, between depths, the edge stream
    node = torch.empty(5, b, n, c, dtype=dt, device=dev)
    ys = torch.empty(b, n, n, c, dtype=dt, device=dev) if depth > 1 else node[0]
    index, stream = _stream(dev)
    fn = lib.fused_generator_bf16 if bf16 else lib.fused_generator_f32
    with torch.cuda.device(index):
        err = fn(z_n.data_ptr(), z_e.data_ptr(), pk.wts.data_ptr(), pk.vecs.data_ptr(),
                 pk.woff.data_ptr(), pk.voff.data_ptr(), out_n.data_ptr(), out_e.data_ptr(),
                 *(node[i].data_ptr() for i in range(5)), ys.data_ptr(),
                 b, n, gw.m_dim, gw.b_dim, c, h, depth, stream_scale(c // heads, dt), stream)
    if err != 0:
        raise RuntimeError(f"fused_generator_logits kernel launch failed: CUDA error {err}")
    fused_generator_logits.launches += 1
    return out_n, out_e


fused_generator_logits.launches = 0

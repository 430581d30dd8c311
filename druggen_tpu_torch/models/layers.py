"""Graph-transformer building blocks (port of ``druggen_tpu/models/layers.py``).

The attention is the reference's edge-modulated, per-channel construction,
not dot-product attention:

    q, k, v : [B, N, H, Dk]      e : [B, N, N, H, Dk]
    attn    = (q_i ⊙ k_j) / sqrt(Dk)          # ELEMENT-WISE, per channel
    attn    = attn * (e + 1) * e              # edge modulation
    edge'   = out_e(flatten(attn))            # PRE-softmax edge readout
    attn    = softmax(attn, axis=j)           # per channel (H, Dk)
    node'   = out_n(flatten(Σ_j attn ⊙ v_j))

dtype semantics follow flax's, which the JAX package runs under: with a
compute ``dtype`` (bf16) a :class:`Dense` multiplies bf16 inputs by
bf16-cast parameters, a :class:`LayerNorm` reduces in f32 with f32
parameters and returns ``dtype``, and the attention chain runs in the stream
dtype.  Parameters are stored f32 and named in the reference torch layout
(``druggen_tpu/interop/torch_ckpt.py``).

The compute dtype, ``fused_mlp`` (False, True or ``"block"``), ``use_pallas``
and ``f32_stats`` are plain attributes of the modules, so one set of ``Parameter`` objects runs
under several numerics (:func:`numerics`), as the JAX step's ``clone(...)``s
do.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from druggen_tpu_torch.ops.fused_attention import edge_modulated_attention_proj
from druggen_tpu_torch.ops.fused_block import fused_block_edge_stream
from druggen_tpu_torch.ops.fused_mlp import FusedLnMlpLn


class Dense(nn.Module):
    """``nn.Linear`` with a compute dtype (flax ``nn.Dense(dtype=...)``).

    Parameters are created uninitialised; :func:`init_torch_style_` fills
    them from an explicit ``torch.Generator``."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=...)``: f32 statistics and
    parameters, output in ``dtype`` (or the promoted input dtype).

    ``forward_mode``: compute it from differentiable primitives (mean,
    variance, ``rsqrt``) in place of ``F.layer_norm``, for a pass that is
    forward-differentiated and then differentiated in reverse (the
    gradient penalty's JVP pass): torch's forward-mode rule of
    ``F.layer_norm`` gives wrong parameter gradients upstream of it when
    reverse mode differentiates through it (``layer_norm(x * w)``: the
    gradient of ``w`` off by 0.75 relative on torch 2.13)."""

    def __init__(self, dim: int, dtype=None, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.forward_mode = False
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        out = self.dtype or torch.promote_types(x.dtype, torch.float32)
        if self.forward_mode:
            xf = x.float()
            xc = xf - xf.mean(-1, keepdim=True)
            var = (xc * xc).mean(-1, keepdim=True)
            y = xc * torch.rsqrt(var + self.eps) * self.weight.float() + self.bias.float()
            return y.to(out)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out)


@torch.no_grad()
def init_torch_style_(module: nn.Module, generator: torch.Generator) -> None:
    """Torch-style init of every :class:`Dense` below ``module`` (reference
    nn.Linear defaults: kernel and bias uniform in ±1/sqrt(fan_in)), drawn
    from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, Dense):
            bound = math.sqrt(1.0 / m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)


def get_activation(name: str) -> nn.Module:
    """Activation registry (reference models.py:39-46)."""
    acts = {
        "relu": nn.ReLU,
        "leaky": lambda: nn.LeakyReLU(negative_slope=0.01),
        "sigmoid": nn.Sigmoid,
        "tanh": nn.Tanh,
    }
    if name not in acts:
        raise ValueError(f"unsupported activation {name!r}")
    return acts[name]()


class MLP(nn.Module):
    """Two-layer ReLU MLP with output dropout (reference layers.py:7-54)."""

    def __init__(self, in_feat: int, hid_feat: int | None = None,
                 out_feat: int | None = None, dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        hid = hid_feat or in_feat
        out = out_feat or in_feat
        self.fc1 = Dense(in_feat, hid, dtype)
        self.fc2 = Dense(hid, out, dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        return self.drop(self.fc2(torch.relu(self.fc1(x))))


class GraphMHA(nn.Module):
    """Edge-modulated multi-head attention (reference MHA, layers.py:56-137).

    ``forward(node [B,N,D], edge [B,N,N,D])`` returns
    ``(node_out [B,N,D], edge_out [B,N,N,D])``; ``edge_out`` is None with
    ``need_edge=False`` (its ``out_e`` readout is skipped).  ``f32_stats``
    runs the softmax in f32 and casts it back (JAX ``layers.py:221-227``).

    ``use_pallas``: the fused path (JAX ``layers.py:196-215``): q, k, v, the
    raw edge stream and the f32 ``e`` / ``out_e`` parameters go to
    :func:`..ops.fused_attention.edge_modulated_attention_proj` (K5 forward,
    K6 backward where its rule sends the shape; first-order only), then
    ``out_n``.  Not with ``f32_stats`` (as in JAX).

    ``tail``: the megablock (JAX ``layers.py:164-187``), given by a block in
    ``fused_mlp="block"`` mode: the encoder block's ``ln4``, ``mlp2`` and
    ``ln6`` parameters (LayerNorm scale and bias, fc1 and fc2 weight
    [in, out] and bias).  q, k and v on the node stream, the raw edge stream
    and the f32 ``e`` / ``out_e`` parameters go with them to
    :func:`..ops.fused_block.fused_block_edge_stream` (K7 forward, K8
    backward where its rule sends the shape; first-order only), then
    ``out_n``; the returned edge stream is the block's new one."""

    def __init__(self, dim: int, heads: int, dtype=None,
                 f32_stats: bool = False, use_pallas: bool = False):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.dim = dim
        self.heads = heads
        self.f32_stats = f32_stats
        self.use_pallas = use_pallas
        for name in ("q", "k", "v", "e", "out_e", "out_n"):
            setattr(self, name, Dense(dim, dim, dtype))

    def forward(self, node, edge, need_edge: bool = True, tail=None):
        if self.use_pallas and self.f32_stats:
            raise ValueError("f32_stats requires the plain attention path "
                             "(use_pallas off), as in the JAX package")
        b, n, c = node.shape
        h = self.heads
        dk = c // h
        if tail is not None:
            y_out, node_agg = fused_block_edge_stream(
                self.q(node), self.k(node), self.v(node), edge,
                self.e.weight.t(), self.e.bias, self.out_e.weight.t(),
                self.out_e.bias, *tail, heads=h)
            return self.out_n(node_agg), y_out
        q = self.q(node).reshape(b, n, h, dk)
        k = self.k(node).reshape(b, n, h, dk)
        v = self.v(node).reshape(b, n, h, dk)
        if self.use_pallas:
            edge_out, node_agg = edge_modulated_attention_proj(
                q, k, v, edge, self.e.weight.t(), self.e.bias,
                self.out_e.weight.t(), self.out_e.bias)
            return self.out_n(node_agg), (edge_out if need_edge else None)
        e = self.e(edge).reshape(b, n, n, h, dk)
        # attn[b,i,j,h,dk] = q_i * k_j / sqrt(dk) * (e_ij + 1) * e_ij
        attn = q[:, :, None] * k[:, None]
        attn = attn / math.sqrt(dk)
        attn = attn * (e + 1.0) * e
        edge_pre = attn.reshape(b, n, n, c)         # read BEFORE the softmax
        if self.f32_stats:
            attn = torch.softmax(attn.float(), dim=2).to(v.dtype)
        else:
            attn = torch.softmax(attn, dim=2)       # over keys j, per channel
        node_agg = (attn * v[:, None]).sum(dim=2).reshape(b, n, c)
        return self.out_n(node_agg), (self.out_e(edge_pre) if need_edge else None)


class EncoderBlock(nn.Module):
    """Pre-LN attention + dual residual MLPs for the node and edge streams
    (reference Encoder_Block, layers.py:139-193).

    ``fused_mlp=True`` computes the edge tail ``ln6(ln4(y+y1) +
    mlp2(ln4(y+y1)))`` with the fused kernels (:mod:`..ops.fused_mlp`, K1
    forward and K2 backward under autograd, first-order only) whenever the
    tail's dropout is inactive and ``f32_stats`` is off (JAX
    ``layers.py:321-322``).  ``need_edge=False`` skips the edge stream's
    readout and tail and returns ``(x, None)``: the critic's last block,
    whose edge output nothing reads.  ``use_pallas`` goes to the attention
    (:class:`GraphMHA`); the fused tail follows it as usual.

    ``fused_mlp="block"`` runs the block's whole edge stream (attention and
    tail) through the megablock (:class:`GraphMHA` with ``tail``; K7/K8)
    when JAX ``layers.py:274-277`` would: the tail's dropout inactive, no
    ``use_pallas`` and no ``f32_stats``.  Otherwise ``"block"`` counts as
    ``True``: the fused tail (K1/K2).  With ``need_edge=False`` the
    megablock still runs (its node output is needed) and its edge output is
    dropped.  The parameters are the same in every mode."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 drop_rate: float = 0.0, dtype=None, fused_mlp: bool | str = False,
                 f32_stats: bool = False, use_pallas: bool = False):
        super().__init__()
        self.drop_rate = drop_rate
        self.fused_mlp = fused_mlp
        for i in (1, 3, 4, 5, 6):
            setattr(self, f"ln{i}", LayerNorm(dim, dtype))
        self.attn = GraphMHA(dim, heads, dtype, f32_stats, use_pallas)
        self.mlp = MLP(dim, dim * mlp_ratio, dim, drop_rate, dtype)
        self.mlp2 = MLP(dim, dim * mlp_ratio, dim, drop_rate, dtype)

    @property
    def f32_stats(self) -> bool:
        return self.attn.f32_stats

    def forward(self, x, y, need_edge: bool = True):
        x1 = self.ln1(x)
        dropout_off = self.drop_rate == 0.0 or not self.training
        if (self.fused_mlp == "block" and dropout_off and not self.attn.use_pallas
                and not self.f32_stats):
            tail = (self.ln4.weight, self.ln4.bias,
                    self.mlp2.fc1.weight.t(), self.mlp2.fc1.bias,
                    self.mlp2.fc2.weight.t(), self.mlp2.fc2.bias,
                    self.ln6.weight, self.ln6.bias)
            x2, y = self.attn(x1, y, tail=tail)
            x2 = self.ln3(x1 + x2)
            x = self.ln5(x2 + self.mlp(x2))
            return x, (y if need_edge else None)
        x2, y1 = self.attn(x1, y, need_edge)
        x2 = x1 + x2            # residual vs the *normed* input (sic,
        # reference layers.py:187: x2 = x1 + x2)
        x2 = self.ln3(x2)
        x = self.ln5(x2 + self.mlp(x2))
        if not need_edge:
            return x, None
        if not (self.fused_mlp and dropout_off and not self.f32_stats):
            y2 = self.ln4(y + y1)
            return x, self.ln6(y2 + self.mlp2(y2))
        y = FusedLnMlpLn.apply(
            y + y1,
            self.ln4.weight, self.ln4.bias,
            self.mlp2.fc1.weight.t(), self.mlp2.fc1.bias,
            self.mlp2.fc2.weight.t(), self.mlp2.fc2.bias,
            self.ln6.weight, self.ln6.bias)
        return x, y


class TransformerEncoder(nn.Module):
    """Stack of encoder blocks, unrolled (reference layers.py:195-234)."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: int = 4,
                 drop_rate: float = 0.0, dtype=None, fused_mlp: bool | str = False,
                 use_pallas: bool = False):
        super().__init__()
        self.Encoder_Blocks = nn.ModuleList(
            EncoderBlock(dim, heads, mlp_ratio, drop_rate, dtype, fused_mlp,
                         use_pallas=use_pallas)
            for _ in range(depth))

    def forward(self, x, y, need_last_edge: bool = True):
        last = len(self.Encoder_Blocks) - 1
        for i, block in enumerate(self.Encoder_Blocks):
            x, y = block(x, y, need_last_edge or i < last)
        return x, y


@contextlib.contextmanager
def numerics(model: nn.Module, dtype=..., fused_mlp=..., f32_stats=...,
             use_pallas=..., forward_mode=...):
    """Run ``model`` under other numerics, on the same ``Parameter``
    objects: ``dtype`` (None = the promoted input dtype, i.e. f32) for every
    :class:`Dense` and :class:`LayerNorm`, ``fused_mlp`` (False, True or
    ``"block"``) for every :class:`EncoderBlock`, ``f32_stats`` and ``use_pallas`` for every
    :class:`GraphMHA`, ``forward_mode`` for every :class:`LayerNorm`.
    An argument left out keeps the module's own value; all are restored on
    exit.  The counterpart of the JAX step's ``model.clone(...)``."""
    saved = []
    for m in model.modules():
        for attr, value, kinds in (("dtype", dtype, (Dense, LayerNorm)),
                                   ("fused_mlp", fused_mlp, (EncoderBlock,)),
                                   ("f32_stats", f32_stats, (GraphMHA,)),
                                   ("use_pallas", use_pallas, (GraphMHA,)),
                                   ("forward_mode", forward_mode, (LayerNorm,))):
            if value is not ... and isinstance(m, kinds):
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, value)
    try:
        yield model
    finally:
        for m, attr, value in reversed(saved):
            setattr(m, attr, value)

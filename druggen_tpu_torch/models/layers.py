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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from druggen_tpu_torch.ops.fused_mlp import fused_ln_mlp_ln


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
    parameters, output in ``dtype`` (or the promoted input dtype)."""

    def __init__(self, dim: int, dtype=None, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        out = self.dtype or torch.promote_types(x.dtype, torch.float32)
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
    ``(node_out [B,N,D], edge_out [B,N,N,D])``."""

    def __init__(self, dim: int, heads: int, dtype=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.dim = dim
        self.heads = heads
        for name in ("q", "k", "v", "e", "out_e", "out_n"):
            setattr(self, name, Dense(dim, dim, dtype))

    def forward(self, node, edge):
        b, n, c = node.shape
        h = self.heads
        dk = c // h
        q = self.q(node).reshape(b, n, h, dk)
        k = self.k(node).reshape(b, n, h, dk)
        v = self.v(node).reshape(b, n, h, dk)
        e = self.e(edge).reshape(b, n, n, h, dk)
        # attn[b,i,j,h,dk] = q_i * k_j / sqrt(dk) * (e_ij + 1) * e_ij
        attn = q[:, :, None] * k[:, None]
        attn = attn / math.sqrt(dk)
        attn = attn * (e + 1.0) * e
        edge_pre = attn.reshape(b, n, n, c)         # read BEFORE the softmax
        attn = torch.softmax(attn, dim=2)           # over keys j, per channel
        node_agg = (attn * v[:, None]).sum(dim=2).reshape(b, n, c)
        return self.out_n(node_agg), self.out_e(edge_pre)


class EncoderBlock(nn.Module):
    """Pre-LN attention + dual residual MLPs for the node and edge streams
    (reference Encoder_Block, layers.py:139-193).

    ``fused_mlp=True`` computes the edge tail ``ln6(ln4(y+y1) +
    mlp2(ln4(y+y1)))`` with the fused kernel (:mod:`..ops.fused_mlp`)
    whenever the tail's dropout is inactive."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 drop_rate: float = 0.0, dtype=None, fused_mlp: bool = False):
        super().__init__()
        self.drop_rate = drop_rate
        self.fused_mlp = fused_mlp
        for i in (1, 3, 4, 5, 6):
            setattr(self, f"ln{i}", LayerNorm(dim, dtype))
        self.attn = GraphMHA(dim, heads, dtype)
        self.mlp = MLP(dim, dim * mlp_ratio, dim, drop_rate, dtype)
        self.mlp2 = MLP(dim, dim * mlp_ratio, dim, drop_rate, dtype)

    def forward(self, x, y):
        x1 = self.ln1(x)
        x2, y1 = self.attn(x1, y)
        x2 = x1 + x2            # residual vs the *normed* input (sic,
        # reference layers.py:187: x2 = x1 + x2)
        x2 = self.ln3(x2)
        x = self.ln5(x2 + self.mlp(x2))
        if not (self.fused_mlp and (self.drop_rate == 0.0 or not self.training)):
            y2 = self.ln4(y + y1)
            return x, self.ln6(y2 + self.mlp2(y2))
        y = fused_ln_mlp_ln(
            y + y1,
            self.ln4.weight, self.ln4.bias,
            self.mlp2.fc1.weight.t(), self.mlp2.fc1.bias,
            self.mlp2.fc2.weight.t(), self.mlp2.fc2.bias,
            self.ln6.weight, self.ln6.bias)
        return x, y


class TransformerEncoder(nn.Module):
    """Stack of encoder blocks, unrolled (reference layers.py:195-234)."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: int = 4,
                 drop_rate: float = 0.0, dtype=None, fused_mlp: bool = False):
        super().__init__()
        self.Encoder_Blocks = nn.ModuleList(
            EncoderBlock(dim, heads, mlp_ratio, drop_rate, dtype, fused_mlp)
            for _ in range(depth))

    def forward(self, x, y):
        for block in self.Encoder_Blocks:
            x, y = block(x, y)
        return x, y

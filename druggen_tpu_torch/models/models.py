"""Generator (port of ``druggen_tpu/models/models.py:30-127``).

Same topology as the reference ``src/model/models.py:5-103``: node MLP
(m_dim->64->dim, act after each Linear) + edge MLP (b_dim->64->dim), edge
symmetrisation (e+eᵀ)/2, transformer stack, readouts dim->m_dim (nodes) and
dim->b_dim (edges).  Submodules carry the reference torch names
(``node_layers.0/.2``, ``edge_layers.0/.2``,
``TransformerEncoder.Encoder_Blocks.i.*``, ``readout_n``, ``readout_e``), so
a state_dict from :mod:`druggen_tpu_torch.interop.weights` loads as is.
"""

from __future__ import annotations

import torch
from torch import nn

from druggen_tpu_torch.models.layers import (
    Dense,
    TransformerEncoder,
    get_activation,
    init_torch_style_,
)


class _Trunk(nn.Module):
    """Shared front of the Generator: per-stream input MLPs, edge
    symmetrisation, transformer encoder.  A base class rather than a
    submodule, so that its parameters keep the reference's top-level names."""

    def __init__(self, act: str, edges: int, nodes: int, dropout: float,
                 dim: int, depth: int, heads: int, mlp_ratio: int,
                 dtype=None, fused_mlp: bool = False):
        super().__init__()
        # node_layers: Linear(nodes,64) act Linear(64,dim) act Dropout
        self.node_layers = nn.Sequential(
            Dense(nodes, 64, dtype), get_activation(act),
            Dense(64, dim, dtype), get_activation(act), nn.Dropout(dropout))
        # edge_layers: Linear(edges,64) act Linear(64,dim) act Dropout
        self.edge_layers = nn.Sequential(
            Dense(edges, 64, dtype), get_activation(act),
            Dense(64, dim, dtype), get_activation(act), nn.Dropout(dropout))
        self.TransformerEncoder = TransformerEncoder(
            dim, depth, heads, mlp_ratio, dropout, dtype, fused_mlp)

    def trunk(self, z_e, z_n):
        node = self.node_layers(z_n)
        edge = self.edge_layers(z_e)
        # symmetrise over the two vertex axes (reference models.py:94)
        edge = (edge + edge.transpose(1, 2)) / 2.0
        return self.TransformerEncoder(node, edge)


class Generator(_Trunk):
    """Graph-transformer generator (reference models.py:5-103).

    ``forward(z_e [B,N,N,b_dim], z_n [B,N,m_dim])`` ->
    ``(node [B,N,dim], edge [B,N,N,dim],
       node_logits [B,N,m_dim], edge_logits [B,N,N,b_dim])``.

    Parameters are initialised torch-style from ``generator`` (a fixed seed
    when none is given); load trained weights with ``load_state_dict``."""

    def __init__(self, act: str, vertexes: int, edges: int, nodes: int,
                 dropout: float, dim: int, depth: int, heads: int,
                 mlp_ratio: int, dtype=None, fused_mlp: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(act, edges, nodes, dropout, dim, depth, heads,
                         mlp_ratio, dtype, fused_mlp)
        self.vertexes = vertexes
        self.readout_n = Dense(dim, nodes, dtype)
        self.readout_e = Dense(dim, edges, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_torch_style_(self, generator)

    def forward(self, z_e, z_n):
        node, edge = self.trunk(z_e, z_n)
        return node, edge, self.readout_n(node), self.readout_e(edge)

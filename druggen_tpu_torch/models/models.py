"""Generator, Discriminator and SimpleDisc (port of
``druggen_tpu/models/models.py``).

Same topology as the reference ``src/model/models.py:5-103``: node MLP
(m_dim->64->dim, act after each Linear) + edge MLP (b_dim->64->dim), edge
symmetrisation (e+eᵀ)/2, transformer stack, readouts dim->m_dim (nodes) and
dim->b_dim (edges).  Submodules carry the reference torch names
(``node_layers.0/.2``, ``edge_layers.0/.2``,
``TransformerEncoder.Encoder_Blocks.i.*``, ``readout_n``, ``readout_e``; the critic's head ``node_mlp.{0,2,4,6}``;
SimpleDisc's ``predictor.{0,2,4,6,8,10}``),
so a state_dict from :mod:`druggen_tpu_torch.interop.weights` loads as is.
"""

from __future__ import annotations

import torch
from torch import nn

from druggen_tpu_torch.models.layers import (
    Dense,
    TransformerEncoder,
    distributed_edge_transpose,
    gather_node_rows,
    get_activation,
    init_torch_style_,
)


class _Trunk(nn.Module):
    """Shared front of the Generator: per-stream input MLPs, edge
    symmetrisation, transformer encoder.  A base class rather than a
    submodule, so that its parameters keep the reference's top-level names.

    ``node_axis`` (set through :func:`..models.layers.numerics`): the
    edge-partitioned mode (JAX ``models.py:54-79``): the inputs are this
    rank's vertex rows (``z_n [B, n, m]``, ``z_e [B, n, N, b]``), the
    symmetrisation's transpose is
    :func:`..models.layers.distributed_edge_transpose` and the attention
    gathers k/v.  The parameters are the unsharded model's."""

    def __init__(self, act: str, edges: int, nodes: int, dropout: float,
                 dim: int, depth: int, heads: int, mlp_ratio: int,
                 dtype=None, fused_mlp: bool | str = False, use_pallas: bool = False):
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
            dim, depth, heads, mlp_ratio, dropout, dtype, fused_mlp, use_pallas)
        self.node_axis = None

    def trunk(self, z_e, z_n, need_last_edge: bool = True):
        node = self.node_layers(z_n)
        edge = self.edge_layers(z_e)
        # symmetrise over the two vertex axes (reference models.py:94);
        # node-sharded: one distributed transpose
        if self.node_axis is not None:
            edge = (edge + distributed_edge_transpose(edge, self.node_axis)) / 2.0
        else:
            edge = (edge + edge.transpose(1, 2)) / 2.0
        return self.TransformerEncoder(node, edge, need_last_edge)


class Generator(_Trunk):
    """Graph-transformer generator (reference models.py:5-103).

    ``forward(z_e [B,N,N,b_dim], z_n [B,N,m_dim])`` ->
    ``(node [B,N,dim], edge [B,N,N,dim],
       node_logits [B,N,m_dim], edge_logits [B,N,N,b_dim])``.

    Parameters are initialised torch-style from ``generator`` (a fixed seed
    when none is given); load trained weights with ``load_state_dict``.
    ``use_pallas`` runs every block's attention through the fused edge
    attention (K5/K6, first-order only); the critic never does (JAX
    ``trainer.py:139-143``).  ``fused_mlp`` is False, True (the fused edge
    tail, K1/K2) or ``"block"`` (the megablock, K7/K8, where the block's
    rule allows it; JAX ``trainer.py:136-137``)."""

    def __init__(self, act: str, vertexes: int, edges: int, nodes: int,
                 dropout: float, dim: int, depth: int, heads: int,
                 mlp_ratio: int, dtype=None, fused_mlp: bool | str = False,
                 generator: torch.Generator | None = None,
                 use_pallas: bool = False):
        super().__init__(act, edges, nodes, dropout, dim, depth, heads,
                         mlp_ratio, dtype, fused_mlp, use_pallas)
        self.vertexes = vertexes
        self.readout_n = Dense(dim, nodes, dtype)
        self.readout_e = Dense(dim, edges, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_torch_style_(self, generator)

    def forward(self, z_e, z_n):
        node, edge = self.trunk(z_e, z_n)
        return node, edge, self.readout_n(node), self.readout_e(edge)


class Discriminator(_Trunk):
    """Graph-transformer critic (reference models.py:106-209; JAX
    ``models.py:131-182``).

    ``forward(z_e [B,N,N,b_dim], z_n [B,N,m_dim])`` -> logits ``[B, 1]``:
    the trunk's node stream flattened to ``[B, N*dim]`` through the head
    ``node_mlp`` (N*dim -> 64 -> 32 -> 16 -> 1, widths times ``head_mult``).
    The head reads only the node stream, so the last block's edge readout
    and tail are skipped (XLA drops them as dead code on the JAX side); in
    ``fused_mlp="block"`` mode the last block's megablock still runs and its
    edge output is dropped (the Pallas call is not dead code either)."""

    def __init__(self, act: str, vertexes: int, edges: int, nodes: int,
                 dropout: float, dim: int, depth: int, heads: int,
                 mlp_ratio: int, dtype=None, fused_mlp: bool | str = False,
                 head_mult: int = 1, generator: torch.Generator | None = None):
        super().__init__(act, edges, nodes, dropout, dim, depth, heads,
                         mlp_ratio, dtype, fused_mlp)
        self.vertexes = vertexes
        m = head_mult
        self.node_mlp = nn.Sequential(
            Dense(vertexes * dim, 64 * m, dtype), get_activation(act),
            Dense(64 * m, 32 * m, dtype), get_activation(act),
            Dense(32 * m, 16 * m, dtype), get_activation(act),
            Dense(16 * m, 1, dtype))
        if generator is None:
            generator = torch.Generator().manual_seed(1)
        init_torch_style_(self, generator)

    def forward(self, z_e, z_n, need_last_edge: bool = False):
        node, _ = self.trunk(z_e, z_n, need_last_edge)
        if self.node_axis is not None:
            # the head reads every node row of a sample: gather the small
            # node stream (replicated; the edge stream stays sharded)
            node = gather_node_rows(node, self.node_axis)
        return self.node_mlp(node.reshape(node.shape[0], -1))


class SimpleDisc(nn.Module):
    """Flat-feature MLP critic (reference simple_disc, models.py:212-269;
    JAX ``models.py:185-207``).

    ``forward(x [B, N*m_dim + N*N*b_dim])`` -> ``[B, 1]``: Linear layers of
    widths 256, 128, 64, 32, 16, 1 with the activation between them, under
    the reference's keys ``predictor.{0,2,4,6,8,10}``."""

    def __init__(self, act: str, m_dim: int, vertexes: int, b_dim: int,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        fan_in = vertexes * m_dim + vertexes ** 2 * b_dim
        layers = []
        for w in (256, 128, 64, 32, 16):
            layers += [Dense(fan_in, w, dtype), get_activation(act)]
            fan_in = w
        layers.append(Dense(fan_in, 1, dtype))
        self.predictor = nn.Sequential(*layers)
        if generator is None:
            generator = torch.Generator().manual_seed(2)
        init_torch_style_(self, generator)

    def forward(self, x):
        return self.predictor(x)

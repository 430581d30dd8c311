"""Model definitions of the port (mirrors ``druggen_tpu.models``)."""

from druggen_tpu_torch.models.layers import (
    MLP,
    Dense,
    EncoderBlock,
    GraphMHA,
    LayerNorm,
    TransformerEncoder,
    distributed_edge_transpose,
    gather_node_rows,
    get_activation,
    init_torch_style_,
    numerics,
)
from druggen_tpu_torch.models.models import Discriminator, Generator, SimpleDisc

__all__ = ["MLP", "Dense", "EncoderBlock", "GraphMHA", "LayerNorm",
           "TransformerEncoder", "Generator", "Discriminator", "SimpleDisc",
           "distributed_edge_transpose", "gather_node_rows", "get_activation",
           "init_torch_style_", "numerics"]

"""Entry point of the port (twin of ``__graft_entry__.py``'s
``entry``, :15-42).

:func:`entry` returns a forward step on the flagship model, the DrugGEN
Generator at its default config (dim 128, depth 1, 8 heads, mlp_ratio 3,
the ChEMBL vocabulary, N 45), with example arguments: its parameters and a
batch of 8 random one-hot graphs, on the device (``cuda`` unless the
caller asks for the CPU).  ``fn(params, z_e, z_n)`` -> ``(node_logits,
edge_logits)``, as the JAX function returns them; the parameters are the
Generator's state_dict, applied with ``torch.func.functional_call``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args) for a single-device Generator forward."""
    from druggen_tpu_torch.chem.vocab import CHEMBL_VOCAB
    from druggen_tpu_torch.infer.engine import resolve_device
    from druggen_tpu_torch.models import Generator

    device = resolve_device(device)
    vocab = CHEMBL_VOCAB
    vertexes, m_dim, b_dim = 45, vocab.m_dim, vocab.b_dim
    model = Generator(act="relu", vertexes=vertexes, edges=b_dim,
                      nodes=m_dim, dropout=0.0, dim=128, depth=1, heads=8,
                      mlp_ratio=3).to(device).eval()
    gen = torch.Generator().manual_seed(0)
    batch = 8
    z_e = F.one_hot(torch.randint(0, b_dim, (batch, vertexes, vertexes),
                                  generator=gen), b_dim).float().to(device)
    z_n = F.one_hot(torch.randint(0, m_dim, (batch, vertexes), generator=gen),
                    m_dim).float().to(device)
    params = dict(model.state_dict())

    def forward(params, z_e, z_n):
        _, _, node_logits, edge_logits = torch.func.functional_call(
            model, params, (z_e, z_n))
        return node_logits, edge_logits

    return forward, (params, z_e, z_n)

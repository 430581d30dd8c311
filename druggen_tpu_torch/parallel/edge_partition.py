"""Edge-partitioned giant-batch training (port of
``druggen_tpu/parallel/edge_partition.py``).

The memory of a step is the ``[B, N, N, dim]`` edge stream, so it is split:
the batch over a 'data' axis and the *query-vertex* (first N) axis over a
'node' axis.  Each rank holds a ``[B/dp, N/np, N, dim]`` edge block and the
matching ``[B/dp, N/np, dim]`` node rows; the models run in their
``node_axis`` mode (:mod:`druggen_tpu_torch.models.layers`):

- attention gathers the k/v rows (the small node stream),
- the trunk's symmetrisation is one distributed transpose of the edge block,
- the critic's head gathers the last node rows,
- the losses and the penalty's per-sample norms are ``psum``s.

Gradients follow the one rule of :mod:`..models.layers`: every rank computes
the global loss and differentiates it; its parameter gradients are its
partial sums, added over the whole mesh, except the critic head's, which
every 'node' rank computes whole on the gathered rows and which are
therefore counted once (divided by the 'node' size before the sum).  The
fused edge tail (K1/K2, ``--fused_mlp``) runs row by row on the rank's
block.

:class:`ShardedTrainStep` is the whole WGAN-GP iteration (JAX
``make_sharded_train_step`` :186-321): the Generator forward, the critic on
the real and fake blocks, the gradient penalty's double backward with the
global batch's eps, the D update, then the G update against the updated
critic, each through the port's AdamW behind its all-finite guard.  With
the same state, the same data and the same eps it computes the
single-device step (``tests/test_torch_port_parallel*.py``).
"""

from __future__ import annotations

import torch

from druggen_tpu_torch.models.layers import edge_attention, psum
from druggen_tpu_torch.parallel.mesh import Mesh, gradient_hook, shard
from druggen_tpu_torch.train.step import TrainStep, _dropout_rate, _grads

NODE_ROWS = ("data", "node", None)           # [B, N, m] blocks
EDGE_ROWS = ("data", "node", None, None)     # [B, N, N, b] blocks


def make_edge_mesh(dp: int, np_axis: int) -> Mesh:
    """2-D mesh ('data', 'node') over the first ``dp * np_axis`` ranks."""
    return Mesh({"data": dp, "node": np_axis})


def edge_partitioned_attention(mesh: Mesh, q, k, v, e, dk: int):
    """The attention on this rank's blocks (:func:`shard_inputs`): k/v
    gathered over 'node', through the models' own core
    (:func:`..models.layers.edge_attention`).  Returns this rank's edge_pre
    and node_agg blocks."""
    return edge_attention(q, k, v, e, dk, node_axis=mesh.axis("node"))


def reference_unsharded(q, k, v, e, dk: int):
    return edge_attention(q, k, v, e, dk)


def make_sharded_loss_grad(mesh: Mesh, dk: int):
    """``fn(q, k, v, e)`` on this rank's blocks -> (the global loss, the
    gradients of this rank's blocks); loss = the sum of squares of both
    outputs, summed over the mesh (for scaling measurements)."""
    def fn(q, k, v, e):
        inputs = [t.detach().requires_grad_() for t in (q, k, v, e)]
        ep, na = edge_partitioned_attention(mesh, *inputs, dk)
        local = (ep * ep).sum() + (na * na).sum()
        loss = psum(psum(local, mesh.axis("node")), mesh.axis("data"))
        return loss.detach(), torch.autograd.grad(loss, inputs)
    return fn


def shard_inputs(mesh: Mesh, q, k, v, e):
    """This rank's blocks of the global q/k/v ``[B, N, D]`` and e."""
    return (shard(mesh, q, NODE_ROWS), shard(mesh, k, NODE_ROWS),
            shard(mesh, v, NODE_ROWS), shard(mesh, e, EDGE_ROWS))


def shard_train_inputs(mesh: Mesh, *arrays):
    """This rank's blocks of label batches: x ``[B, N]`` over ('data',
    'node'), a ``[B, N, N]`` over ('data', 'node', None).  Each host passes
    its own batch; a host's ranks hold whole 'data' rows of the mesh (the
    trainer's guard)."""
    return tuple(shard(mesh, arr, ("data", "node") if arr.ndim == 2
                       else ("data", "node", None)) for arr in arrays)


class ShardedTrainStep(TrainStep):
    """The WGAN-GP step on a ('data', 'node') mesh.

    ``step(x, a, drug_x, drug_a, eps=None)`` takes this rank's label blocks
    (:func:`shard_train_inputs`) and returns ``{"d_loss", "g_loss"}`` (the
    global losses, the same on every rank) and this rank's logit blocks.
    ``eps`` is the global batch's penalty noise; drawn from ``generator``
    when None, every rank the same draw, of which it keeps its 'data' rows
    (JAX :152-158).  The Generator runs its numerics (``g_fused``: the fused
    edge tail K1/K2, or ``"block"``, which counts as the fused tail in this
    mode); the critic runs plain, as JAX's (its ``fused_critic`` and
    ``gp_mode`` apply to the single-device step); ``gp_f32`` and
    ``f32_stats`` as in :class:`TrainStep` (JAX :214-228).  Installs the
    gradient sums on both optimizers.  Dropout must be 0."""

    def __init__(self, G, D, g_opt, d_opt, mesh: Mesh, *, lambda_gp: float,
                 m_dim: int, b_dim: int, submodel: str = "DrugGEN",
                 compute_dtype=torch.float32, g_fused: bool | str = False,
                 gp_f32: bool = False, f32_stats: bool = False,
                 generator: torch.Generator | None = None):
        if _dropout_rate(G) or _dropout_rate(D):
            raise ValueError("edge-partitioned training requires dropout=0")
        self.data, self.node = mesh.axis("data"), mesh.axis("node")
        super().__init__(G, D, g_opt, d_opt, lambda_gp=lambda_gp, m_dim=m_dim,
                         b_dim=b_dim, submodel=submodel,
                         compute_dtype=compute_dtype, g_fused=g_fused,
                         gp_f32=gp_f32, f32_stats=f32_stats, generator=generator,
                         noise_rows=(self.data.index, self.data.size))
        for kw in (self.g_numerics, self.d_first, self.d_gp):
            kw["node_axis"] = self.node
        whole = mesh.whole
        g_opt.grad_hook = gradient_hook(whole)
        # the critic head's gradients are whole on every 'node' rank
        head = torch.cat([torch.full((p.numel(),), 1.0 / self.node.size
                                     if name.startswith("node_mlp.") else 1.0)
                          for name, p in zip(d_opt.names, d_opt.params)])
        d_opt.grad_hook = gradient_hook(whole, scale=head.to(d_opt.flat.device))

    def _mean(self, logits, b_glob: int):
        """The global batch mean of per-sample critic values."""
        return psum(logits.sum(), self.data) / b_glob

    def _penalty(self, real_node, real_edge, fake_node, fake_edge, eps_node,
                 eps_edge, b_glob: int):
        """The global gradient penalty from this rank's blocks (JAX
        ``_sharded_gradient_penalty`` :132-183): per-sample squared norms in
        f32 summed over 'node', the penalty over 'data'."""
        int_node = eps_node * real_node + (1.0 - eps_node) * fake_node
        int_edge = eps_edge * real_edge + (1.0 - eps_edge) * fake_edge
        if self.gp_cast is not None:
            int_node, int_edge = int_node.to(self.gp_cast), int_edge.to(self.gp_cast)
        int_node = int_node.detach().requires_grad_()
        int_edge = int_edge.detach().requires_grad_()
        g_node, g_edge = torch.autograd.grad(
            self._critic_gp(int_edge, int_node).sum(), (int_node, int_edge),
            create_graph=True)
        b = int_node.shape[0]
        sq = (g_node.reshape(b, -1).float().square().sum(dim=1)
              + g_edge.reshape(b, -1).float().square().sum(dim=1))
        norms = torch.sqrt(psum(sq, self.node) + 1e-12)
        return psum(((norms - 1.0) ** 2).sum(), self.data) / b_glob

    def __call__(self, x_labels, a_labels, drug_x_labels, drug_a_labels,
                 eps=None) -> dict:
        self.G.train()
        self.D.train()
        x, a, disc_x, disc_a = self._inputs(x_labels, a_labels, drug_x_labels,
                                            drug_a_labels)
        b = x.shape[0]
        b_glob = b * self.data.size
        if eps is None:
            eps = self._draw_noise(b, disc_x.dtype, x.device)
        else:
            eps = tuple(t[self.data.index * b:(self.data.index + 1) * b] for t in eps)
        outs = self._generate(a, x)
        fake_node, fake_edge = outs[2].detach(), outs[3].detach()
        # D update (reference train.py:352-368)
        lr = self._mean(self._critic(disc_a, disc_x), b_glob)
        lf = self._mean(self._critic(fake_edge, fake_node), b_glob)
        gp = self._penalty(disc_x, disc_a, fake_node, fake_edge, *eps, b_glob)
        d_loss = lf - lr + self.lambda_gp * gp
        self.d_opt.step(_grads(d_loss, self.d_params))
        # G update against the updated critic (train.py:370-384)
        node_logits, edge_logits = outs[2], outs[3]
        g_loss = -self._mean(self._critic(edge_logits, node_logits), b_glob)
        self.g_opt.step(_grads(g_loss, self.g_params))
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "node_logits": node_logits.detach(),
                "edge_logits": edge_logits.detach()}

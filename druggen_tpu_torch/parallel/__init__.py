"""Parallel training on ``torch.distributed`` (port of
``druggen_tpu/parallel``): meshes of ranks and the collectives
(:mod:`.mesh`), the edge-partitioned step (:mod:`.edge_partition`) and
tensor parallelism (:mod:`.tensor_parallel`)."""

from druggen_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
    shard_state,
)

__all__ = [
    "make_mesh",
    "replicated",
    "batch_sharding",
    "shard_batch",
    "shard_state",
]

"""MOSES-style molecular metrics (reference ``src/util/utils.py:472-611``).

Copied from ``druggen_tpu/metrics/__init__.py``; imports point at this package."""

from druggen_tpu_torch.metrics.molecular import (
    fraction_valid,
    fraction_unique,
    novelty,
    internal_diversity,
    average_agg_tanimoto,
    remove_invalid,
    max_component,
    mean_atom_type,
)

__all__ = [
    "fraction_valid",
    "fraction_unique",
    "novelty",
    "internal_diversity",
    "average_agg_tanimoto",
    "remove_invalid",
    "max_component",
    "mean_atom_type",
]

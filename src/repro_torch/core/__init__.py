"""Port of ``repro.core``: deltas, selection, adapter trees."""

from repro_torch.core.adapt import (
    DEFAULT_EXCLUDE,
    adaptable_shapes,
    count_total,
    count_trainable,
    init_adapters,
    is_adaptable,
    map_deltas,
    merge_adapters,
    trainable_fraction,
    zip_adapters,
)
from repro_torch.core.delta import (
    Delta,
    adapter_bytes,
    delta_matmul,
    init_delta,
    merge,
    scatter_to_dense,
    trainable_count,
)
from repro_torch.core.selection import STRATEGIES, k_for_budget, topk_indices

__all__ = [
    "Delta",
    "STRATEGIES",
    "DEFAULT_EXCLUDE",
    "adaptable_shapes",
    "adapter_bytes",
    "count_total",
    "count_trainable",
    "delta_matmul",
    "init_adapters",
    "init_delta",
    "is_adaptable",
    "k_for_budget",
    "map_deltas",
    "merge",
    "merge_adapters",
    "scatter_to_dense",
    "topk_indices",
    "trainable_count",
    "trainable_fraction",
    "zip_adapters",
]

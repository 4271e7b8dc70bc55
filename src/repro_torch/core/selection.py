"""Phase 1 of NeuroAda (Alg. 1): offline per-neuron top-k selection.

Port of ``repro.core.selection`` (magnitude strategy). A weight matrix is
stored ``(d_in, d_out)`` with ``y = x @ W``, so a *neuron* is an output
column and selection runs along axis ``-2`` independently per column.

Ties break toward the lower index, as ``lax.top_k`` does in the reference.
Selection runs through :func:`repro_torch.kernels.ops.topk_select`: one
kernel launch a stack on the card (|w| taken in the kernel, in w's own
dtype), a stable descending sort one matrix at a time on the CPU; both
return the same indices in the same order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

STRATEGIES = ("magnitude",)


def _per_unit_topk(w: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k of |w| along axis -2 per output unit: (..., d_in, d_out) ->
    (..., k, d_out) int32, by descending magnitude, ties toward the lower
    index."""
    d_in = w.shape[-2]
    if not 1 <= k <= d_in:
        raise ValueError(f"k={k} out of range for d_in={d_in}")
    return ops.topk_select(w, k)


def topk_indices(w: torch.Tensor, k: int, *, strategy: str = "magnitude") -> torch.Tensor:
    """Select k input-connection indices per output neuron of ``w``.

    w: (..., d_in, d_out). Returns (..., k, d_out) int32, unique per column.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    return _per_unit_topk(w, k)

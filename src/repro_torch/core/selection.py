"""Phase 1 of NeuroAda (Alg. 1): offline per-neuron top-k selection.

Port of ``repro.core.selection`` (magnitude strategy). A weight matrix is
stored ``(d_in, d_out)`` with ``y = x @ W``, so a *neuron* is an output
column and selection runs along axis ``-2`` independently per column.

Ties break toward the lower index, as ``lax.top_k`` does in the reference:
``torch.topk`` promises no order among equal values, so selection uses a
stable descending sort instead.
"""

from __future__ import annotations

import torch

STRATEGIES = ("magnitude",)


def _per_unit_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k along axis -2 per output unit: (..., d_in, d_out) -> (..., k, d_out)
    int32, by descending score, ties toward the lower index. Sorted one
    matrix at a time so a layer stack never needs a stack-sized sort."""
    d_in = scores.shape[-2]
    if not 1 <= k <= d_in:
        raise ValueError(f"k={k} out of range for d_in={d_in}")
    flat = scores.reshape(-1, *scores.shape[-2:])
    out = torch.empty((flat.shape[0], k, flat.shape[-1]), dtype=torch.int32,
                      device=scores.device)
    for i in range(flat.shape[0]):
        order = torch.sort(flat[i], dim=0, descending=True, stable=True).indices
        out[i] = order[:k].to(torch.int32)
    return out.reshape(*scores.shape[:-2], k, scores.shape[-1])


def topk_indices(w: torch.Tensor, k: int, *, strategy: str = "magnitude") -> torch.Tensor:
    """Select k input-connection indices per output neuron of ``w``.

    w: (..., d_in, d_out). Returns (..., k, d_out) int32, unique per column.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    return _per_unit_topk(w.abs().float(), k)

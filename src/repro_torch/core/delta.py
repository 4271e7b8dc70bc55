"""Sparse bypass deltas (Eq. 3–4) and the one-shot merge (Alg. 1 phase 3).

Port of ``repro.core.delta``. Storage is the paper's mask-free compact
form: per adapted matrix ``W (..., d_in, d_out)`` an ``idx (..., k, d_out)``
int32 tensor of positions along ``d_in`` and a ``val (..., k, d_out)``
tensor. The forward contribution is

    yΔ[..., o] = Σ_j val[j, o] · x[..., idx[j, o]]

:func:`delta_matmul` computes it in plain PyTorch (the reference's jnp
path; the model runs the kernels of ``repro_torch.kernels``), and
:func:`scatter_to_dense` materialises Δ for tests and the merge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Delta(NamedTuple):
    """A NeuroAda adapter for one weight matrix. ``idx`` is non-trainable."""

    idx: torch.Tensor  # (..., k, d_out) int32 — positions along d_in
    val: torch.Tensor  # (..., k, d_out)


class BatchedDelta(NamedTuple):
    """N stacked adapters for one matrix + a per-row adapter selection.

    ``idx``/``val`` stack N tenants' deltas along a leading axis (row 0 is
    the zero base) and ``aid`` names, for every batch row, which tenant's
    delta applies.
    """

    idx: torch.Tensor  # (N, k, d_out) int32
    val: torch.Tensor  # (N, k, d_out)
    aid: torch.Tensor  # (B,) int32 in [0, N)


def init_delta(idx: torch.Tensor, dtype=torch.float32) -> Delta:
    return Delta(idx=idx, val=torch.zeros(idx.shape, dtype=dtype, device=idx.device))


def merge(w: torch.Tensor, delta: Delta) -> torch.Tensor:
    """W[i, I_i] += Δ — returns a new tensor, ``w`` is left as it is."""
    idx = delta.idx.long()
    sel = torch.gather(w, -2, idx)
    return w.scatter(-2, idx, sel + delta.val.to(w.dtype))


def delta_matmul(x: torch.Tensor, delta: Delta) -> torch.Tensor:
    """Apply the bypass connections: x (..., d_in) -> (..., d_out), a gather
    along the feature axis and a sum over the k terms, in x's dtype."""
    idx, val = delta.idx, delta.val
    if idx.ndim != 2:
        raise ValueError(f"delta_matmul wants rank-2 idx (k, d_out); got {tuple(idx.shape)}")
    xg = x[..., idx.long()]  # (..., k, d_out)
    return (xg * val.to(x.dtype)).sum(dim=-2)


def scatter_to_dense(delta: Delta, d_in: int, dtype=None) -> torch.Tensor:
    """Δ as a dense (..., d_in, d_out) matrix (tests and merges only)."""
    idx, val = delta.idx, delta.val
    dtype = dtype or val.dtype
    dense = torch.zeros((*idx.shape[:-2], d_in, idx.shape[-1]), dtype=dtype, device=idx.device)
    return dense.scatter(-2, idx.long(), val.to(dtype))


def trainable_count(delta: Delta) -> int:
    return delta.val.numel()


def adapter_bytes(delta: Delta) -> int:
    """The paper's Table 1 accounting: the value bytes plus an int32 index
    for every selected weight."""
    return delta.val.numel() * (delta.val.element_size() + delta.idx.element_size())

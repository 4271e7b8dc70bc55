"""Phase 1 of NeuroAda (Alg. 1): offline per-neuron top-k selection.

Port of ``repro.core.selection``. A weight matrix is stored ``(d_in,
d_out)`` with ``y = x @ W``, so a *neuron* is an output column and
selection runs along axis ``-2`` independently per column, for any number
of leading stack axes.

Strategies (paper §4, Fig. 7), each through
:func:`repro_torch.kernels.ops.topk_select` — one kernel launch a stack on
the card, a stable sort one matrix at a time on the CPU, the same indices
in the same order:

* ``magnitude`` (the default): the k largest |w|, w read in its own dtype;
* ``reverse``: the k smallest |w|, ascending, ties to the lower row — the
  order of the reference's ``lax.top_k(-|w|)`` (the kernel's smallest-first
  mode);
* ``gradient``: the k largest |grad| (a warm-up batch's dL/dW, of w's
  shape), in float32;
* ``random``: the k largest of float32 uniforms drawn from a
  ``torch.Generator`` on w's device — top-k of noise is a uniform draw of k
  distinct rows a column. JAX's PRNG cannot be reproduced here, so a
  ``random`` selection matches the reference in distribution only.

Ties break toward the lower index, as ``lax.top_k`` does in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

STRATEGIES = ("magnitude", "gradient", "reverse", "random")


def _per_unit_topk(scores: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """Top-k of |scores| along axis -2 per output unit: (..., d_in, d_out)
    -> (..., k, d_out) int32, by descending |scores| (ascending for
    ``largest=False``), ties toward the lower index."""
    d_in = scores.shape[-2]
    if not 1 <= k <= d_in:
        raise ValueError(f"k={k} out of range for d_in={d_in}")
    return ops.topk_select(scores, k, largest)


def topk_indices(w, k: int, *, strategy: str = "magnitude",
                 rng: torch.Generator | None = None, grad=None) -> torch.Tensor:
    """Select k input-connection indices per output neuron of ``w``.

    w: (..., d_in, d_out). Returns (..., k, d_out) int32, unique per column.
    ``grad`` (w's shape) is required by ``gradient``, ``rng`` by ``random``
    (only w's shape and device are read then).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    if strategy in ("magnitude", "reverse"):
        return _per_unit_topk(w, k, largest=strategy == "magnitude")
    if strategy == "gradient":
        if grad is None:
            raise ValueError("strategy='gradient' requires grad=|dL/dW| array")
        if tuple(grad.shape) != tuple(w.shape):
            raise ValueError(f"grad shape {tuple(grad.shape)} != w shape {tuple(w.shape)}")
        # the selection takes |.| in float32 itself: a bf16 or float32 grad
        # goes in as it is (no stack-sized copy), any other dtype as float32
        scores = grad if grad.dtype in (torch.float32, torch.bfloat16) else grad.float()
    else:  # random
        if rng is None:
            raise ValueError("strategy='random' requires rng")
        scores = torch.rand(tuple(w.shape), generator=rng, device=w.device, dtype=torch.float32)
    return _per_unit_topk(scores, k)


def k_for_budget(total_params: int, adaptable: dict[str, tuple[int, ...]],
                 fraction: float) -> int:
    """Smallest k whose trainable fraction reaches ``fraction`` of
    ``total_params``: each matrix of shape (..., d_in, d_out) in
    ``adaptable`` contributes k values per output neuron of every stacked
    matrix; capped at the smallest d_in."""
    per_k = sum(math.prod(s) // s[-2] for s in adaptable.values())
    if per_k == 0:
        raise ValueError("no adaptable parameters")
    target = fraction * total_params
    k = max(1, int(-(-target // per_k)))  # ceil
    return min(k, min(s[-2] for s in adaptable.values()))

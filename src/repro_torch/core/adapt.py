"""Model-level NeuroAda: build/merge adapter trees over whole param trees.

Port of ``repro.core.adapt``. An adapter tree mirrors the nested-dict
param tree with ``None`` everywhere except at adapted matrices, split into
two aligned trees: ``indices`` (int32, frozen) and ``values`` (the only
trainables, zero-initialised). A packed (int8 or NF4) matrix is adaptable
like a dense one: selection reads its magnitudes off a transiently
dequantized copy, and merging dequantizes first.

The ``random`` strategy draws from one ``torch.Generator``, consumed leaf
by leaf in the tree's order (the reference splits its key into one key a
leaf), so a ``random`` selection matches the reference in distribution
only.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.delta import Delta, init_delta, merge
from repro_torch.core.selection import topk_indices
from repro_torch.quant.qtensor import (
    DEFAULT_QUANT_EXCLUDE,
    QuantizedTensor,
    any_quantized,
    dequantize,
    dequantize_tree,
    is_linear_weight,
)
from repro_torch.tree import flatten, map_leaves, path_str, with_paths

# Matrices never adapted: embeddings (rows are tokens, not neurons) and
# routers. Only ``…/w`` leaves of linear sub-layers are candidates; the
# same policy decides which matrices quantize.
DEFAULT_EXCLUDE = DEFAULT_QUANT_EXCLUDE


def is_adaptable(name: str, leaf, exclude=DEFAULT_EXCLUDE) -> bool:
    return is_linear_weight(name, leaf, exclude)


def adaptable_shapes(params, exclude=DEFAULT_EXCLUDE) -> dict[str, tuple[int, ...]]:
    """Path name -> logical shape of every adaptable matrix (a packed one's
    dequantized shape)."""
    return {path_str(p): tuple(leaf.shape) for p, leaf in flatten(params)
            if leaf is not None and is_adaptable(path_str(p), leaf, exclude)}


def _select(w, k: int, strategy: str, rng=None, grad=None) -> torch.Tensor:
    """Top-k indices of a dense or packed matrix or stack: one selection
    (one kernel launch) for a dense stack. A packed layer stack dequantizes
    one layer at a time, so selection never holds the whole dense stack,
    and selects layer by layer (``random`` draws its scores a layer at a
    time and dequantizes nothing)."""
    if not isinstance(w, QuantizedTensor):
        return topk_indices(w, k, strategy=strategy, rng=rng, grad=grad)
    if strategy == "gradient":
        raise ValueError(
            "strategy='gradient' on a packed (int8 / NF4) matrix: a frozen packed base has no "
            "dense |dL/dW| (nor can the reference form one for it); select on the dense base "
            "before quantize_base")
    if w.ndim > 2:
        return torch.stack([_select(w[i], k, strategy, rng) for i in range(w.shape[0])])
    return topk_indices(w if strategy == "random" else dequantize(w), k, strategy=strategy,
                        rng=rng)


def _tree_get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def init_adapters(params, k: int, *, strategy: str = "magnitude",
                  rng: torch.Generator | None = None, grads=None, dtype=torch.float32,
                  exclude=DEFAULT_EXCLUDE):
    """(indices_tree, values_tree) for every adaptable matrix; ``None``
    elsewhere. Values are zeros of ``dtype`` on the weights' device.
    ``rng`` (``random``) is consumed leaf by leaf; ``grads`` (``gradient``)
    is a tree holding dL/dW (or |dL/dW|) at every adaptable path."""

    def one(pl):
        path, w = pl
        if w is None or not is_adaptable(path_str(path), w, exclude):
            return (None, None)
        g = _tree_get(grads, path) if grads is not None else None
        d = init_delta(_select(w, min(k, w.shape[-2]), strategy, rng, g), dtype=dtype)
        return (d.idx, d.val)

    pairs = map_leaves(one, with_paths(params))
    return (map_leaves(lambda p: p[0], pairs),
            map_leaves(lambda p: p[1], pairs))


def zip_adapters(indices, values):
    """Aligned (indices, values) trees -> one tree of :class:`Delta` leaves;
    ``None`` where a matrix is not adapted (the training adapters)."""
    return map_leaves(lambda i, v: None if i is None else Delta(i, v), indices, values)


def count_trainable(values) -> int:
    return sum(v.numel() for _, v in flatten(values) if v is not None)


def count_total(params) -> int:
    return sum(p.numel() for _, p in flatten(params) if p is not None)


def trainable_fraction(params, values) -> float:
    return count_trainable(values) / max(count_total(params), 1)


def merge_adapters(params, indices, values):
    """Alg. 1 phase 3: fold every delta into its frozen matrix, in one pass.
    A packed base dequantizes first: the merged tree is dense in the
    logical dtype (merging into integer codes would round the deltas
    away)."""
    if any_quantized(params):
        params = dequantize_tree(params)
    return map_leaves(
        lambda w, i, v: w if i is None else merge(w, Delta(i, v)),
        params, indices, values,
    )


def map_deltas(fn: Callable[[str, Delta], Delta], indices, values):
    """Apply ``fn(name, Delta) -> Delta`` over an adapter tree; returns the
    new (indices, values) trees, ``None`` where a matrix is not adapted."""
    def one(pi, v):
        path, i = pi
        return (None, None) if i is None else tuple(fn(path_str(path), Delta(i, v)))

    pairs = map_leaves(one, with_paths(indices), values)
    return (map_leaves(lambda p: p[0], pairs), map_leaves(lambda p: p[1], pairs))

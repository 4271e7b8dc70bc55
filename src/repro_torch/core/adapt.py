"""Model-level NeuroAda: build/merge adapter trees over whole param trees.

Port of ``repro.core.adapt`` (magnitude selection). An adapter tree
mirrors the nested-dict param tree with ``None`` everywhere except at
adapted matrices, split into two aligned trees: ``indices`` (int32,
frozen) and ``values`` (the only trainables, zero-initialised).
"""

from __future__ import annotations

import re

import torch

from repro_torch.core.delta import Delta, init_delta, merge
from repro_torch.core.selection import topk_indices
from repro_torch.tree import map_leaves, path_str

# Matrices never adapted: embeddings (rows are tokens, not neurons) and
# routers — the reference's ``DEFAULT_QUANT_EXCLUDE``. Only ``…/w`` leaves
# of linear sub-layers are candidates.
DEFAULT_EXCLUDE = (r".*embed.*", r".*router.*")


def is_adaptable(name: str, leaf, exclude=DEFAULT_EXCLUDE) -> bool:
    if not name.endswith("/w") or not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2 or not leaf.is_floating_point():
        return False
    return not any(re.fullmatch(p, name) for p in exclude)


def _with_paths(tree, prefix=()):
    """Same structure as ``tree`` with each leaf replaced by (path, leaf)."""
    if not isinstance(tree, dict):
        return (prefix, tree)
    return {k: _with_paths(v, prefix + (k,)) for k, v in tree.items()}


def init_adapters(params, k: int, *, strategy: str = "magnitude",
                  dtype=torch.float32, exclude=DEFAULT_EXCLUDE):
    """(indices_tree, values_tree) for every adaptable matrix; ``None``
    elsewhere. Values are zeros of ``dtype`` on the weights' device."""

    def one(pl):
        path, w = pl
        if w is None or not is_adaptable(path_str(path), w, exclude):
            return (None, None)
        d = init_delta(topk_indices(w, min(k, w.shape[-2]), strategy=strategy),
                       dtype=dtype)
        return (d.idx, d.val)

    pairs = map_leaves(one, _with_paths(params))
    return (map_leaves(lambda p: p[0], pairs),
            map_leaves(lambda p: p[1], pairs))


def merge_adapters(params, indices, values):
    """Alg. 1 phase 3: fold every delta into its frozen matrix, in one pass."""
    return map_leaves(
        lambda w, i, v: w if i is None else merge(w, Delta(i, v)),
        params, indices, values,
    )

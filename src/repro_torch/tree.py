"""Nested-dict trees: the port's counterpart of the pytrees the reference
threads through its params, adapters and checkpoints.

A tree is a dict whose values are dicts or leaves; ``None`` is a leaf
(the reference keeps explicit ``None`` at non-adapted matrices so
adapter trees stay aligned with the param tree). :func:`flatten` also
opens named tuples (``AdamWState``, ``TrainState``) by field name, as the
reference's checkpoint paths do (``opt_state/mu/...``); :func:`unflatten`
rebuilds them as dicts.
"""

from __future__ import annotations


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)] in insertion order; a path is a tuple of keys (a
    named tuple's field names)."""
    if is_namedtuple(tree):
        tree = tree._asdict()
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key, sub in tree.items():
        out.extend(flatten(sub, prefix + (key,)))
    return out


def unflatten(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def map_leaves(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over aligned trees (``None`` leaves
    included: ``fn`` decides what to do with them)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def with_paths(tree, prefix: tuple = ()):
    """Same structure as ``tree`` with each leaf replaced by (path, leaf)."""
    if not isinstance(tree, dict):
        return (prefix, tree)
    return {k: with_paths(v, prefix + (k,)) for k, v in tree.items()}


def path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)

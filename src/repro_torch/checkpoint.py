"""npz trees in the reference's on-disk format (``repro.checkpoint.manager``).

A tree flattens to path-keyed arrays (``"blocks/wq/w"``). ``None`` leaves
are stored as the string ``"__none__"``; bf16 leaves, which numpy cannot
hold natively, as their raw bits in uint16 plus a ``"__dtype__/<key>"``
sidecar naming the dtype. Files written by either package load in the
other. Reading needs no ``ml_dtypes``: the uint16 bits are viewed as
``torch.bfloat16`` directly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.tree import flatten, path_str, unflatten

_SENTINEL_NONE = "__none__"
_DTYPE_KEY = "__dtype__"


def _to_numpy(leaf, flat: dict, key: str) -> None:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            flat[f"{_DTYPE_KEY}/{key}"] = np.array("bfloat16")
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            return
        flat[key] = t.numpy()
        return
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        flat[f"{_DTYPE_KEY}/{key}"] = np.array("bfloat16")
        flat[key] = arr.view(np.uint16)
    else:
        flat[key] = arr


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    """Atomic write of ``tree`` (torch tensors, numpy arrays or ``None``)."""
    flat: dict[str, np.ndarray] = {}
    for p, leaf in flatten(tree):
        key = path_str(p)
        if leaf is None:
            flat[key] = np.array(_SENTINEL_NONE)
        else:
            _to_numpy(leaf, flat, key)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if metadata is not None:
        mtmp = path + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, path + ".meta.json")


def load_pytree(path: str) -> dict:
    """-> nested dict of CPU torch tensors (``None`` where stored so)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    dtypes = {
        k[len(_DTYPE_KEY) + 1:]: str(v)
        for k, v in flat.items()
        if k.startswith(_DTYPE_KEY + "/")
    }
    pairs = []
    for key, val in flat.items():
        if key.startswith(_DTYPE_KEY + "/"):
            continue
        if val.dtype.kind == "U" and str(val) == _SENTINEL_NONE:
            leaf = None
        elif key in dtypes:
            if dtypes[key] != "bfloat16":
                raise ValueError(f"{path}: leaf {key} has unsupported dtype "
                                 f"{dtypes[key]!r}")
            leaf = torch.from_numpy(val.view(np.int16).copy()).view(torch.bfloat16)
        else:
            leaf = torch.from_numpy(np.ascontiguousarray(val))
        pairs.append((tuple(key.split("/")), leaf))
    return unflatten(pairs)

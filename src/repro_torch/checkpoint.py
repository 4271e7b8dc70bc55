"""npz trees in the reference's on-disk format (``repro.checkpoint.manager``).

A tree flattens to path-keyed arrays (``"blocks/wq/w"``). ``None`` leaves
are stored as the string ``"__none__"``; bf16 leaves, which numpy cannot
hold natively, as their raw bits in uint16 plus a ``"__dtype__/<key>"``
sidecar naming the dtype; a packed (int8 or NF4) leaf as ``<key>/data``
and ``<key>/scales`` plus a ``"__quant__/<key>"`` JSON sidecar holding
``[qdtype, block, dtype_name]``. Files written by either package load in
the other, packed leaves byte for byte. Reading needs no ``ml_dtypes``:
the uint16 bits are viewed as ``torch.bfloat16`` directly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.tree import flatten, path_str, unflatten

_SENTINEL_NONE = "__none__"
_DTYPE_KEY = "__dtype__"
_QUANT_KEY = "__quant__"


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
        elif isinstance(leaf, QuantizedTensor):
            flat[f"{_QUANT_KEY}/{key}"] = np.array(
                json.dumps([leaf.qdtype, leaf.block, leaf.dtype_name]))
            _to_numpy(leaf.data, flat, f"{key}/data")
            _to_numpy(leaf.scales, flat, f"{key}/scales")
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


def _sidecars(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: str(v) for k, v in flat.items()
            if k.startswith(prefix + "/")}


def load_pytree(path: str) -> dict:
    """-> nested dict of CPU torch tensors (``None`` where stored so, a
    :class:`QuantizedTensor` for a packed leaf)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    dtypes = _sidecars(flat, _DTYPE_KEY)
    quant = {k: json.loads(v) for k, v in _sidecars(flat, _QUANT_KEY).items()}
    pairs = []
    for key, val in flat.items():
        if key.startswith((_DTYPE_KEY + "/", _QUANT_KEY + "/")):
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
    tree = unflatten(pairs)
    for key, (qdtype, block, dtype_name) in quant.items():
        *parents, last = key.split("/")
        node = tree
        for p in parents:
            node = node[p]
        packed = node[last]  # {"data": …, "scales": …} built above
        node[last] = QuantizedTensor(packed["data"], packed["scales"], qdtype, int(block),
                                     dtype_name)
    return tree

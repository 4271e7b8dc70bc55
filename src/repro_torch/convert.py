"""Param and adapter trees between the reference's numpy form and the
port's tensors.

Both packages keep the same tree layout (``W (d_in, d_out)``, layer stacks
leading, ``None`` at non-adapted leaves), so conversion is leaf by leaf and
changes no value. bf16 arrays from JAX (numpy dtype ``bfloat16`` from
``ml_dtypes``) cross as their raw 16 bits, so the port needs no
``ml_dtypes`` of its own. A packed leaf — the reference's
``QuantizedTensor`` of numpy ``data`` and ``scales`` — becomes the port's
:class:`~repro_torch.quant.QuantizedTensor` with the same bytes, and back:
:func:`tree_to_numpy` gives each packed leaf as a :class:`PackedArrays`,
whose fields are the reference's in the reference's order, so
``QuantizedTensor(*leaf)`` there rebuilds it (the port imports nothing of
the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.tree import map_leaves


class PackedArrays(NamedTuple):
    """A packed leaf as numpy arrays, in the reference's field order."""

    data: np.ndarray
    scales: np.ndarray
    qdtype: str
    block: int
    dtype_name: str


def _is_packed(x) -> bool:
    # (``qdtype`` first: a bf16 ndarray's ``.data`` buffer raises)
    return hasattr(x, "qdtype") and all(hasattr(x, f) for f in PackedArrays._fields)


def to_tensor(arr, device=None) -> torch.Tensor:
    """numpy array (bf16 included) -> tensor with the same dtype and bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy. bf16 widens to float32, which is exact; the caller
    casts back where it wants bf16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _leaf_to_torch(x, device):
    if x is None:
        return None
    if _is_packed(x):
        return QuantizedTensor(to_tensor(x.data, device), to_tensor(x.scales, device),
                               x.qdtype, int(x.block), x.dtype_name)
    return to_tensor(x, device)


def tree_to_torch(tree, device=None):
    """Nested dict of arrays (``None`` leaves kept, packed leaves of numpy
    ``data``/``scales``) -> tensors and packed leaves on ``device``."""
    return map_leaves(lambda x: _leaf_to_torch(x, device), tree)


def tree_to_numpy(tree):
    """Tensors -> numpy; a packed leaf -> :class:`PackedArrays` of numpy
    arrays (codes and scales keep their dtypes, so no value changes)."""
    def one(x):
        if x is None:
            return None
        if isinstance(x, QuantizedTensor):
            return PackedArrays(to_numpy(x.data), to_numpy(x.scales), x.qdtype, x.block,
                                x.dtype_name)
        return to_numpy(x)

    return map_leaves(one, tree)

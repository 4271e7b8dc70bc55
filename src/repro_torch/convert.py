"""Param and adapter trees between the reference's numpy form and the
port's tensors.

Both packages keep the same tree layout (``W (d_in, d_out)``, layer stacks
leading, ``None`` at non-adapted leaves), so conversion is leaf by leaf and
changes no value. bf16 arrays from JAX (numpy dtype ``bfloat16`` from
``ml_dtypes``) cross as their raw 16 bits, so the port needs no
``ml_dtypes`` of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import map_leaves


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


def tree_to_torch(tree, device=None):
    """Nested dict of arrays (``None`` leaves kept) -> tensors on ``device``."""
    return map_leaves(lambda x: None if x is None else to_tensor(x, device), tree)


def tree_to_numpy(tree):
    return map_leaves(lambda x: None if x is None else to_numpy(x), tree)

"""Multi-tenant NeuroAda bypass apply: a hand-written CUDA kernel and its
plain PyTorch version.

    y[m, o] = Σ_j val[aid[m], j, o] · x[m, idx[aid[m], j, o]]

x (M, d_in) float32 or bf16; idx int32 and val (float32 or bf16) are
(N, k, d_out) adapter stacks with row 0 the zero base; aid (M,) int32.
Sums run in float32 and the result comes back in x's dtype.

Replaces ``src/repro/kernels/sparse_delta.py::sparse_delta_batched_pallas``.
The CUDA source (``csrc/sparse_delta.cu``) carries the design note: it is
memory-bound, and each row gathers only its own adapter's k entries from
a row tile of x staged in shared memory.

:func:`sparse_delta_batched` launches the kernel for a CUDA tensor and
uses the plain version only for a CPU tensor; a build or launch failure
raises. The plain version follows the kernel's rounding (float32 products
and sums, one cast at the end), not the jnp oracle's, which sums in x's
dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("sparse_delta_batched")
REPLACES = "src/repro/kernels/sparse_delta.py:104"
SOURCE = "src/repro_torch/kernels/csrc/sparse_delta.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sparse_delta_batched_plain(x, idx, val, aid):
    """Plain PyTorch version: gather each row's adapter, float32 sums."""
    counter.plain += 1
    return ref.sparse_delta_batched_ref(x, idx, val, aid)


def _check(x, idx, val, aid) -> None:
    if x.ndim != 2 or idx.ndim != 3 or val.shape != idx.shape:
        raise ValueError(
            f"want x (M, d_in), idx/val (N, k, d_out); got {tuple(x.shape)}, "
            f"{tuple(idx.shape)}, {tuple(val.shape)}"
        )
    if aid.shape != (x.shape[0],):
        raise ValueError(f"aid {tuple(aid.shape)} != ({x.shape[0]},)")
    if x.dtype not in _DTYPES or val.dtype not in _DTYPES:
        raise TypeError(f"x/val must be float32 or bfloat16, got {x.dtype}/{val.dtype}")
    if idx.dtype != torch.int32 or aid.dtype != torch.int32:
        raise TypeError(f"idx/aid must be int32, got {idx.dtype}/{aid.dtype}")
    for name, t in (("x", x), ("idx", idx), ("val", val), ("aid", aid)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sparse_delta_batched(x, idx, val, aid):
    """(M, d_in) × (N, k, d_out) stacks selected by aid (M,) -> (M, d_out)."""
    if not x.is_cuda:
        return sparse_delta_batched_plain(x, idx, val, aid)
    _check(x, idx, val, aid)
    m, d_in = x.shape
    n_ad, k, d_out = idx.shape
    y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    if m == 0 or d_out == 0:
        return y
    rc = build.library().rt_sparse_delta_batched(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), aid.data_ptr(), y.data_ptr(),
        m, d_in, d_out, n_ad, k, _DTYPES[x.dtype], _DTYPES[val.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta_batched")
    counter.kernel += 1
    return y

"""NeuroAda bypass kernels: the multi-tenant apply of serving, the
single-tenant apply of training on an untied head or an expert stack, and
the value gradient of training, each a hand-written CUDA kernel beside its
plain PyTorch version and its own launch counter.

    y[m, o] = Σ_j val[aid[m], j, o] · x[m, idx[aid[m], j, o]]

x (M, d_in) float32 or bf16; idx int32 and val (float32 or bf16) are
(N, k, d_out) adapter stacks with row 0 the zero base; aid (M,) int32.
Sums run in float32 and the result comes back in x's dtype.
:func:`sparse_delta_batched` replaces
``src/repro/kernels/sparse_delta.py::sparse_delta_batched_pallas``.

    y[b, m, o] = Σ_j val[b, j, o] · x[b, m, idx[b, j, o]]

x (B, M, d_in), idx/val (B, k, d_out) -> (B, M, d_out): B is the expert
count of an expert stack (the reference vmaps its kernel over the experts;
here the whole stack is one launch) or 1 for a single matrix.
:func:`sparse_delta` replaces ``sparse_delta.py::sparse_delta_pallas``.
Both run one CUDA kernel (``csrc/sparse_delta.cu``), which finds a row's
adapter in ``aid`` or as the row's batch index; the source carries the
design note: it is memory-bound, and each row gathers only its own
adapter's k entries from a row tile of x staged in shared memory.

A wrapper launches the kernel for a CUDA tensor and uses the plain version
only for a CPU tensor; a build or launch failure raises. The plain versions
follow the kernel's rounding (float32 products and sums, one cast at the
end), not the jnp oracle's, which sums in x's dtype.

    dval[b, j, o] = Σ_m dy[b, m, o] · x[b, m, idx[b, j, o]]

x (B, M, d_in) and dy (B, M, d_out) float32 or bf16 (the same dtype), idx
(B, k, d_out) int32; dval comes back (B, k, d_out) float32; without the
leading axis (x (M, d_in), idx (k, d_out), dy (M, d_out)) it is the B = 1
call, bit for bit. Replaces ``sparse_delta.py::sparse_delta_dval_pallas``;
the CUDA source (``csrc/sparse_delta_dval.cu``) splits B × M across blocks
and sums the float32 partials in a fixed order, so the result repeats bit
for bit. :func:`sparse_delta_dval` launches it for a CUDA tensor and uses
:func:`sparse_delta_dval_plain` only for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("sparse_delta_batched")
REPLACES = "src/repro/kernels/sparse_delta.py:104"
SOURCE = "src/repro_torch/kernels/csrc/sparse_delta.cu"

delta_counter = LaunchCounter("sparse_delta")
DELTA_REPLACES = "src/repro/kernels/sparse_delta.py:52"

dval_counter = LaunchCounter("sparse_delta_dval")
DVAL_REPLACES = "src/repro/kernels/sparse_delta.py:137"
DVAL_SOURCE = "src/repro_torch/kernels/csrc/sparse_delta_dval.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DVAL_COLS = 128  # output columns per block (csrc/sparse_delta_dval.cu kCols)


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


# ------------------------------------------------------ single-tenant apply


def sparse_delta_plain(x, idx, val):
    """Plain PyTorch version: gather each batch's columns, float32 sums."""
    delta_counter.plain += 1
    return ref.sparse_delta_ref(x, idx, val)


def _check_delta(x, idx, val) -> None:
    if x.ndim != 3 or idx.ndim != 3 or val.shape != idx.shape:
        raise ValueError(
            f"want x (B, M, d_in), idx/val (B, k, d_out); got {tuple(x.shape)}, "
            f"{tuple(idx.shape)}, {tuple(val.shape)}")
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"x has batch {x.shape[0]}, idx/val {idx.shape[0]}")
    if x.shape[2] == 0:
        raise ValueError("x has no columns (d_in = 0)")
    if x.dtype not in _DTYPES or val.dtype not in _DTYPES:
        raise TypeError(f"x/val must be float32 or bfloat16, got {x.dtype}/{val.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("x", x), ("idx", idx), ("val", val)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sparse_delta(x, idx, val):
    """(B, M, d_in) × (B, k, d_out) bypasses, batch b on its own -> (B, M, d_out)."""
    if not x.is_cuda:
        return sparse_delta_plain(x, idx, val)
    _check_delta(x, idx, val)
    b, m, d_in = x.shape
    k, d_out = idx.shape[1:]
    y = torch.empty((b, m, d_out), dtype=x.dtype, device=x.device)
    if b == 0 or m == 0 or d_out == 0:
        return y
    rc = build.library().rt_sparse_delta(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), y.data_ptr(), b, m, d_in, d_out, k,
        _DTYPES[x.dtype], _DTYPES[val.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta")
    delta_counter.kernel += 1
    return y


# ------------------------------------------------------------ value gradient


def sparse_delta_dval_plain(x, idx, dy):
    """Plain PyTorch version: gather, float32 products and sums."""
    dval_counter.plain += 1
    return ref.sparse_delta_dval_ref(x, idx, dy)


def _check_dval(x, idx, dy) -> None:
    if x.ndim == idx.ndim == dy.ndim == 2:  # the B = 1 call without the axis
        x, idx, dy = x[None], idx[None], dy[None]
    if x.ndim != 3 or idx.ndim != 3 or dy.ndim != 3:
        raise ValueError(f"want x (B, M, d_in), idx (B, k, d_out), dy (B, M, d_out); got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, {tuple(dy.shape)}")
    if idx.shape[0] != x.shape[0] or dy.shape != (x.shape[0], x.shape[1], idx.shape[2]):
        raise ValueError(f"dy {tuple(dy.shape)} != ({x.shape[0]}, {x.shape[1]}, "
                         f"{idx.shape[2]}), or idx batch {idx.shape[0]} != {x.shape[0]}")
    if x.shape[2] == 0:
        raise ValueError("x has no columns (d_in = 0)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch {x.shape[0]} outside the grid's 1..65535")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"x/dy must share float32 or bfloat16, got {x.dtype}/{dy.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("x", x), ("idx", idx), ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dval_split(m: int, d_out: int, sms: int, batch: int = 1) -> tuple[int, int]:
    """(rows_per_split, n_split): split M so that the batches times the
    column tiles times the row ranges put about four blocks on each of
    ``sms`` SMs."""
    tiles = batch * -(-d_out // _DVAL_COLS)
    want = max(1, min(m, -(-4 * sms // tiles)))
    rows = -(-m // want)
    return rows, -(-m // rows)


def sparse_delta_dval(x, idx, dy):
    """(B, M, d_in), (B, k, d_out) indices, (B, M, d_out) -> (B, k, d_out)
    float32; without the leading axis, (M, d_in), (k, d_out), (M, d_out) ->
    (k, d_out)."""
    if not x.is_cuda:
        return sparse_delta_dval_plain(x, idx, dy)
    _check_dval(x, idx, dy)
    if x.ndim == 2:
        return sparse_delta_dval(x[None], idx[None], dy[None])[0]
    b, m, d_in = x.shape
    k, d_out = idx.shape[1:]
    dval = torch.empty((b, k, d_out), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0 or d_out == 0:
        return dval.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, n_split = dval_split(m, d_out, sms, b)
    part = torch.empty((b, n_split, k, d_out), dtype=torch.float32, device=x.device)
    rc = build.library().rt_sparse_delta_dval(
        x.data_ptr(), idx.data_ptr(), dy.data_ptr(), part.data_ptr(), dval.data_ptr(),
        b, m, d_in, d_out, k, rows, n_split, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta_dval")
    dval_counter.kernel += 1
    return dval

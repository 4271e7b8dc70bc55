"""NeuroAda bypass kernels: the multi-tenant apply of serving, the
single-tenant apply of training on an untied head or an expert stack, and
the value gradient of training, each a hand-written CUDA kernel beside its
plain PyTorch version and its own launch counter.

    y[m, o] = Σ_j val[aid[m // R], j, o] · x[m, idx[aid[m // R], j, o]]

x (M, d_in) float32 or bf16; idx int32 and val (float32 or bf16) are
(N, k, d_out) adapter stacks with row 0 the zero base; aid (M // R,) int32,
one id for every R = ``rows_per_id`` consecutive rows (1: an id a row; S:
the engine's per-sequence ids of (B, S) rows, with no (M,) copy). Sums run
in float32 and the result comes back in x's dtype. Given the base product
``y`` (M, d_out) in x's dtype, the kernel adds the bypass into it in place
and then ``bias``: the bits of ``y + delta`` then ``+ bias.to(y.dtype)``, in
one launch where those were three (serving only: a ``y`` that requires
grad is refused). :func:`sparse_delta_batched` replaces
``src/repro/kernels/sparse_delta.py::sparse_delta_batched_pallas``.

    y[b, m, o] = Σ_j val[b, j, o] · x[b, m, idx[b, j, o]]

x (B, M, d_in), idx/val (B, k, d_out) -> (B, M, d_out): B is the expert
count of an expert stack (the reference vmaps its kernel over the experts;
here the whole stack is one launch) or 1 for a single matrix.
:func:`sparse_delta` replaces ``sparse_delta.py::sparse_delta_pallas``.
Both run one CUDA source (``csrc/sparse_delta.cu``), which finds a row's
adapter in ``aid`` or as the row's batch index, on one of two routes that
:func:`delta_plan` picks by rows: ``rows`` (decode steps: a thread a row
and 8 columns, x gathered from L1/L2) or ``tiles`` (a block for each
column span and row range, staging the range's x rows in shared memory by
double-buffered bulk copies).
Each launch counts under its route, ``-fused`` added for the epilogue.

    dval[b, j, o] = Σ_m dy[b, m, o] · x[b, m, idx[b, j, o]]

x (B, M, d_in) and dy (B, M, d_out) float32 or bf16 (the same dtype), idx
(B, k, d_out) int32; dval comes back (B, k, d_out) in ``out_dtype``
(float32, or the values' dtype: one rounding of the float32 sum, as
``.to(val.dtype)`` would); without the leading axis (x (M, d_in), idx (k,
d_out), dy (M, d_out)) it is the B = 1 call, bit for bit. Replaces
``sparse_delta.py::sparse_delta_dval_pallas``; the CUDA source
(``csrc/sparse_delta_dval.cu``) splits B × M into row ranges over blocks
that stage x's rows once and stream dy, and merges the ranges' float32
partials in a fixed order in the same launch (route ``single``), so the
result repeats bit for bit. :func:`dval_plan` sizes it.

A wrapper launches the kernel for a CUDA tensor and uses the plain version
only for a CPU tensor; a build or launch failure raises. The plain versions
follow the kernel's rounding (float32 products and sums, one cast at the
end), not the jnp oracle's, which sums in x's dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.decode_attention import sm_count, tickets

counter = LaunchCounter("sparse_delta_batched")
REPLACES = "src/repro/kernels/sparse_delta.py:104"
SOURCE = "src/repro_torch/kernels/csrc/sparse_delta.cu"

delta_counter = LaunchCounter("sparse_delta")
DELTA_REPLACES = "src/repro/kernels/sparse_delta.py:52"

dval_counter = LaunchCounter("sparse_delta_dval")
DVAL_REPLACES = "src/repro/kernels/sparse_delta.py:137"
DVAL_SOURCE = "src/repro_torch/kernels/csrc/sparse_delta_dval.cu"
DVAL_ROUTE = "single"  # one launch a call: the ranges merge in the kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COLS = 8  # output columns a thread owns (the kernels' kCols)
ROW_THREADS = 128  # block of the rows route, at most (kRowThreads)
APPLY_THREADS = 256  # block of the apply's tiles route, at most (its kMaxThreads)
DVAL_THREADS = 512  # block of the gradient, at most (its kMaxThreads)
ROWS_MAX = 64  # the rows route takes up to this many rows
RANGE_ROWS = 32  # the tiles route puts 4 blocks an SM while each range keeps this many rows
SMEM_MAX = 232448 - 1024  # the kernels' cap: 227 KB less room for their static barriers
MERGE_GROUP = 16  # ranges one merge ticket covers (the gradient's kGroup)


class DeltaPlan(NamedTuple):
    route: str  # "rows" or "tiles"
    threads: int
    blocks: int  # tiles: spans x row ranges
    tile_rows: int = 0  # tiles: rows a staged tile holds
    groups: int = 0  # tiles: 8-column groups of a span
    lanes: int = 0  # tiles: row lanes (threads that share a column group)
    spans: int = 0  # tiles: column spans (a block takes one)
    stages: int = 0  # tiles: staging buffers (2: the next tile's copy flies)
    smem: int = 0  # dynamic shared memory bytes


class DvalPlan(NamedTuple):
    threads: int
    groups: int  # 8-column groups of a span
    lanes: int
    spans: int
    ranges: int  # row ranges of each batch entry, one block each (and span)
    rows_per_range: int
    tile_rows: int  # rows a staged tile holds
    stages: int
    smem: int


def stage_bytes(rows: int, d_in: int, es: int) -> int:
    """A staging buffer of ``rows`` x rows: the run rounded up to 16 bytes,
    and 16 for a run that starts off 16-byte alignment."""
    return -(-rows * d_in * es // 16) * 16 + 16


def span_shape(d_out: int, max_threads: int, span_threads: int) -> tuple[int, int, int, int]:
    """(8-column groups a span, row lanes, spans, threads): d_out in the
    fewest spans of at most ``max_threads`` groups; a span of fewer groups
    than ``span_threads`` takes that many threads, as row lanes."""
    groups = -(-d_out // COLS)
    spans = -(-groups // max_threads)
    gb = -(-groups // spans)
    lanes = max(1, span_threads // gb)
    return gb, lanes, spans, -(-lanes * gb // 32) * 32


def _rows_fit(d_in: int, es: int, stages: int, blocks_per_sm: int, extra: int = 0) -> int:
    """x rows a staging buffer holds when ``stages`` of them (and ``extra``
    bytes) fit ``blocks_per_sm`` blocks on an SM."""
    budget = SMEM_MAX // blocks_per_sm - extra
    return max(0, (budget // stages - 31) // (d_in * es))


@functools.lru_cache(maxsize=4096)
def delta_plan(m: int, d_in: int, d_out: int, es: int, sms: int, *, rows_max: int = ROWS_MAX,
               blocks_per_sm: int | None = None, tile_rows: int | None = None, stages: int = 2,
               max_threads: int = APPLY_THREADS) -> DeltaPlan:
    """The apply kernel's launch for ``m`` rows of ``d_in`` elements of
    ``es`` bytes -> ``d_out`` columns on ``sms`` SMs.

    Up to ``rows_max`` rows (decode steps), or rows too wide to stage, take
    the ``rows`` route: one thread a (row, 8 columns), no shared memory,
    blocks of 32-128 threads spread over as many SMs as the work fills.
    Otherwise ``tiles``: d_out in the fewest column spans of at most
    ``max_threads`` 8-column groups (row lanes fill a narrow span's block),
    M in row ranges until spans x ranges is about ``blocks_per_sm`` blocks
    an SM (by default 4 where every range still gets RANGE_ROWS rows, as on
    an expert stack or a wide head, else 2), a block for each (span,
    range); a range staged in tiles that ``stages`` buffers fit for
    ``blocks_per_sm`` blocks an SM, about two a range (the second copy flies
    while the first is used). The keywords are for timing other plans."""
    if m <= rows_max or _rows_fit(d_in, es, stages, 1) < 1:
        # blocks of 32-128 threads, at least one an SM where the work allows
        work = m * -(-d_out // COLS)
        threads = min(ROW_THREADS, max(32, work // sms // 32 * 32))
        return DeltaPlan("rows", threads, max(1, -(-work // threads)))
    gb, lanes, spans, threads = span_shape(d_out, max_threads, APPLY_THREADS)
    if blocks_per_sm is None:  # more blocks an SM where each still gets many rows
        blocks_per_sm = 4 if m * spans >= RANGE_ROWS * 4 * sms else 2
    fit = _rows_fit(d_in, es, stages, blocks_per_sm)
    if fit < 1:
        fit = _rows_fit(d_in, es, stages, 1)
    ranges = max(1, min(-(-m // lanes), -(-blocks_per_sm * sms // spans)))
    rows = -(-m // ranges)
    if tile_rows is None:
        tile_rows = max(lanes, -(-rows // 2))
    tile_rows = max(1, min(tile_rows, fit, rows))
    return DeltaPlan("tiles", threads, spans * ranges, tile_rows, gb, lanes, spans, stages,
                     stages * stage_bytes(tile_rows, d_in, es))


@functools.lru_cache(maxsize=4096)
def dval_plan(b: int, m: int, d_in: int, d_out: int, es: int, sms: int, *,
              blocks_per_sm: int = 1, tile_rows: int | None = None, stages: int = 2,
              max_threads: int = DVAL_THREADS) -> DvalPlan:
    """The gradient kernel's launch for ``b`` batch entries of ``m`` rows
    (x's rows ``d_in`` elements of ``es`` bytes) and ``d_out`` columns.

    d_out in the fewest spans of at most ``max_threads`` 8-column groups
    (all of it up to 4096 columns; row lanes fill a narrow span's block up
    to DVAL_THREADS threads); M cut into row ranges until b x spans x
    ranges is about ``blocks_per_sm`` blocks an SM (at least one row a
    range); a range's rows staged in tiles that ``stages`` buffers (and the
    lanes' reduction) fit, about two tiles a range. Raises where one x row
    does not fit a block's shared memory. The keywords are for timing other
    plans."""
    gb, lanes, spans, threads = span_shape(d_out, max_threads, DVAL_THREADS)
    red = lanes * gb * COLS * 4 if lanes > 1 else 0
    fit = _rows_fit(d_in, es, stages, blocks_per_sm, red)
    if fit < 1:
        fit = _rows_fit(d_in, es, stages, 1, red)
    if fit < 1:
        raise ValueError(f"an x row of {d_in} x {es} bytes does not fit a block's shared memory")
    want = max(1, -(-blocks_per_sm * sms // (b * spans)))
    ranges = max(1, min(m, want))
    rows = -(-m // ranges)
    ranges = -(-m // rows)
    if tile_rows is None:
        tile_rows = max(lanes, -(-rows // 2))
    tile_rows = max(1, min(tile_rows, fit, rows))
    return DvalPlan(threads, gb, lanes, spans, ranges, rows, tile_rows, stages,
                    stages * stage_bytes(tile_rows, d_in, es) + red)


# ------------------------------------------------------- multi-tenant apply


def sparse_delta_batched_plain(x, idx, val, aid, rows_per_id: int = 1, y=None, bias=None):
    """Plain PyTorch version: gather each row's adapter, float32 sums; with
    ``y``, ``y += delta`` then ``y += bias.to(y.dtype)`` in place. An id
    outside the stacks raises here; the kernel would read past them."""
    counter.plain += 1
    if aid.numel() and not bool(((aid >= 0) & (aid < idx.shape[0])).all()):
        raise IndexError(f"adapter ids {int(aid.min())}..{int(aid.max())} outside the "
                         f"{idx.shape[0]} stacks")
    if rows_per_id != 1:
        aid = aid.repeat_interleave(rows_per_id)
    delta = ref.sparse_delta_batched_ref(x, idx, val, aid)
    if y is None:
        return delta
    y.add_(delta)
    if bias is not None:
        y.add_(bias.to(y.dtype))
    return y


def _check(x, idx, val, aid, rows_per_id: int = 1, y=None, bias=None) -> None:
    if x.ndim != 2 or idx.ndim != 3 or val.shape != idx.shape:
        raise ValueError(
            f"want x (M, d_in), idx/val (N, k, d_out); got {tuple(x.shape)}, "
            f"{tuple(idx.shape)}, {tuple(val.shape)}"
        )
    if rows_per_id < 1 or aid.ndim != 1 or aid.shape[0] * rows_per_id != x.shape[0]:
        raise ValueError(f"aid {tuple(aid.shape)} x {rows_per_id} rows an id != {x.shape[0]} rows")
    if x.dtype not in _DTYPES or val.dtype not in _DTYPES:
        raise TypeError(f"x/val must be float32 or bfloat16, got {x.dtype}/{val.dtype}")
    if idx.dtype != torch.int32 or aid.dtype != torch.int32:
        raise TypeError(f"idx/aid must be int32, got {idx.dtype}/{aid.dtype}")
    named = [("x", x), ("idx", idx), ("val", val), ("aid", aid)]
    if y is not None:
        if y.shape != (x.shape[0], idx.shape[2]) or y.dtype != x.dtype:
            raise ValueError(f"y {tuple(y.shape)} {y.dtype} is not x's rows by d_out in "
                             f"x's dtype {x.dtype}")
        named.append(("y", y))
    if bias is not None:
        if y is None:
            raise ValueError("a bias goes with the base product y")
        if bias.shape != (idx.shape[2],) or bias.dtype != x.dtype:
            raise ValueError(f"bias {tuple(bias.shape)} {bias.dtype} is not ({idx.shape[2]},) "
                             f"in x's dtype")
        named.append(("bias", bias))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sparse_delta_batched(x, idx, val, aid, rows_per_id: int = 1, y=None, bias=None):
    """(M, d_in) × (N, k, d_out) stacks selected by aid (M // rows_per_id,)
    -> (M, d_out); with ``y`` (M, d_out) the bypass and then ``bias`` are
    added into ``y`` in place, which comes back."""
    if y is not None and y.requires_grad:
        raise ValueError("the in-place epilogue does not take a y that requires grad "
                         "(BatchedDelta is serving-only)")
    if not x.is_cuda:
        return sparse_delta_batched_plain(x, idx, val, aid, rows_per_id, y, bias)
    if bias is not None:
        bias = bias.to(x.dtype)
    _check(x, idx, val, aid, rows_per_id, y, bias)
    m, d_in = x.shape
    plan = delta_plan(m, d_in, idx.shape[2], x.element_size(), sm_count(x.device))
    return launch_batched(x, idx, val, aid, rows_per_id, y, bias, plan)


def launch_batched(x, idx, val, aid, rows_per_id: int, y, bias, plan: DeltaPlan):
    """One launch of the apply on checked CUDA inputs, sized by ``plan``."""
    m, d_in = x.shape
    n_ad, k, d_out = idx.shape
    fused = y is not None
    if not fused:
        y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    if m == 0 or d_out == 0:
        return y
    rc = build.library().rt_sparse_delta_batched(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), aid.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, d_in, d_out, n_ad, k,
        rows_per_id, int(fused), _DTYPES[x.dtype], _DTYPES[val.dtype], *_plan_ints(plan),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta_batched")
    counter.launched(plan.route + ("-fused" if fused else ""))
    return y


def _plan_ints(plan: DeltaPlan) -> tuple:
    return (0 if plan.route == "rows" else 1, plan.threads, plan.blocks, plan.tile_rows,
            plan.groups, plan.lanes, plan.spans, plan.stages)


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
    plan = delta_plan(b * m, d_in, idx.shape[2], x.element_size(), sm_count(x.device))
    return launch_single(x, idx, val, plan)


def launch_single(x, idx, val, plan: DeltaPlan):
    """One launch of the single-tenant apply on checked CUDA inputs."""
    b, m, d_in = x.shape
    k, d_out = idx.shape[1:]
    y = torch.empty((b, m, d_out), dtype=x.dtype, device=x.device)
    if b == 0 or m == 0 or d_out == 0:
        return y
    rc = build.library().rt_sparse_delta(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), y.data_ptr(), b, m, d_in, d_out, k,
        _DTYPES[x.dtype], _DTYPES[val.dtype], *_plan_ints(plan),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta")
    delta_counter.launched(plan.route)
    return y


# ------------------------------------------------------------ value gradient


def sparse_delta_dval_plain(x, idx, dy, out_dtype=torch.float32):
    """Plain PyTorch version: gather, float32 products and sums, one cast."""
    dval_counter.plain += 1
    return ref.sparse_delta_dval_ref(x, idx, dy).to(out_dtype)


def _check_dval(x, idx, dy, out_dtype=torch.float32) -> None:
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
    if out_dtype not in _DTYPES:
        raise TypeError(f"dval comes back in float32 or bfloat16, not {out_dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("x", x), ("idx", idx), ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sparse_delta_dval(x, idx, dy, out_dtype=torch.float32):
    """(B, M, d_in), (B, k, d_out) indices, (B, M, d_out) -> (B, k, d_out)
    in ``out_dtype``; without the leading axis, (M, d_in), (k, d_out), (M,
    d_out) -> (k, d_out)."""
    if not x.is_cuda:
        return sparse_delta_dval_plain(x, idx, dy, out_dtype)
    _check_dval(x, idx, dy, out_dtype)
    if x.ndim == 2:
        return sparse_delta_dval(x[None], idx[None], dy[None], out_dtype)[0]
    b, m, d_in = x.shape
    plan = dval_plan(b, m, d_in, idx.shape[2], x.element_size(), sm_count(x.device))
    return launch_dval(x, idx, dy, out_dtype, plan)


def launch_dval(x, idx, dy, out_dtype, plan: DvalPlan):
    """One launch of the gradient on checked 3-D CUDA inputs, sized by ``plan``."""
    b, m, d_in = x.shape
    k, d_out = idx.shape[1:]
    dval = torch.empty((b, k, d_out), dtype=out_dtype, device=x.device)
    if m == 0 or k == 0 or d_out == 0:
        return dval.zero_()
    groups = -(-plan.ranges // MERGE_GROUP)
    part = gpart = dval  # unused unless the ranges (and their groups) are several
    if plan.ranges > 1:
        part = torch.empty((b, plan.ranges, k, d_out), dtype=torch.float32, device=x.device)
    if groups > 1:
        gpart = torch.empty((b, groups, k, d_out), dtype=torch.float32, device=x.device)
    tk = tickets(x.device, b * plan.spans * (groups + 1))
    rc = build.library().rt_sparse_delta_dval(
        x.data_ptr(), idx.data_ptr(), dy.data_ptr(), part.data_ptr(), gpart.data_ptr(),
        dval.data_ptr(), tk.data_ptr(), b, m, d_in, d_out, k, _DTYPES[x.dtype],
        _DTYPES[out_dtype], plan.threads, plan.rows_per_range, plan.ranges, plan.tile_rows,
        plan.groups, plan.lanes, plan.spans, plan.stages,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "sparse_delta_dval")
    dval_counter.launched(DVAL_ROUTE)
    return dval


"""Fused dequant × matmul + NeuroAda bypass on a packed frozen base: a
hand-written CUDA kernel and its plain PyTorch version.

    y[m, n] = Σ_c x[m, c] · deq(c, n) + Σ_j val[j, n] · x[m, idx[j, n]] (+ b[n])
    deq(c, n) = code(c, n) · scales[c // block, n]

``data`` is int8 ``(K, N)`` or NF4-packed uint8 ``(K/2, N)``, ``scales``
float32 ``(ceil(K/block), N)``; x (M, K) and the bias are float32 or bf16
(the same dtype), idx int32 and val (float32 or bf16) are (k, N), or both
None for no bypass (the serving base matmul). The weight is dequantized in
float32 and cast to x's dtype; products and sums run in float32 and the
result is cast once to x's dtype.

Replaces ``src/repro/kernels/quant_linear.py::fused_linear_q_pallas`` and,
through :func:`matmul_q_cols_sharded`, its tensor-parallel dispatch
``matmul_q_cols_sharded`` (the kernel with no bypass on one rank's columns
of a packed head). The CUDA source (``csrc/fused_linear_q.cu``) carries the design note. The dense
weight never exists in device memory, over any M, N and K and any even
scale block (the Pallas kernel needs K to divide by its 512-deep tile,
which qwen2-1.5b's ``wdown``, K = 8960, does not). :func:`route` picks one
of four kernels by shape before the launch: bf16 decode rows (M <=
:data:`SKINNY_ROWS`) go to a split-K kernel that dequantizes in registers
into swapped mma.sync operands, with K chunks from :func:`skinny_split`
that a thread-block cluster sums in a fixed order; more bf16 rows, where
TMA can describe x and the codes, to the Hopper mainloop of
``csrc/linear.cuh`` (the codes by TMA, dequantized by the consumer
warpgroups into wgmma operands while the previous tile's products run;
tiles from :func:`repro_torch.kernels.fused_linear.linear_plan`); other
bf16 shapes to a 128 × 128 WMMA tile that dequantizes in shared memory;
float32 to an FMA kernel.

:func:`fused_linear_q` launches a kernel for a CUDA tensor and uses the
plain version only for a CPU tensor; a build or launch failure raises.
The gradient lives in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.decode_attention import sm_count
from repro_torch.kernels.fused_linear import linear_plan

counter = LaunchCounter("fused_linear_q")
tp_counter = LaunchCounter("matmul_q_cols_sharded")
REPLACES = "src/repro/kernels/quant_linear.py:86"
TP_REPLACES = "src/repro/kernels/quant_linear.py:145"
SOURCE = "src/repro_torch/kernels/csrc/fused_linear_q.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QDTYPES = {"int8": (0, torch.int8), "nf4": (1, torch.uint8)}

# Rows up to which bf16 takes the split-K kernel: the decode megastep and the
# dense engine's decode steps run M = slots (8) rows, which fill the n = 8
# side of one swapped m16n8k16 product; up to 16 rows take two. Above, the
# 128-row tile of the tiled kernel is no longer mostly padding.
SKINNY_ROWS = 16
# the split-K kernel's geometry (csrc/fused_linear_q.cu): a block covers
# 128 columns with 8 warps, each warp 16 K rows a step; an SM holds two
# such blocks (128 registers a thread); the K chunks of a column tile form
# one thread-block cluster, at most 16 blocks (Hopper's largest)
SKINNY_COLS, SKINNY_WARPS, SKINNY_STEP, SKINNY_BLOCKS_PER_SM = 128, 8, 16, 2
SKINNY_MAX_SPLIT = 16


def route(m: int, k: int, n: int, dtype: torch.dtype, ptrs=()) -> str:
    """Which kernel serves x (m, k) on packed codes of n columns on the
    card: ``"skinny"`` (bf16 decode rows), ``"wgmma"`` (more bf16 rows where
    TMA can describe x and the codes: ``k`` a multiple of 8, the codes' row
    stride ``n`` of 16 bytes, every pointer in ``ptrs`` — x, codes, scales —
    16-byte aligned), ``"tiled"`` (other bf16 shapes) or ``"f32"``. Chosen
    by shape before the launch, never as a fallback."""
    if dtype == torch.float32:
        return "f32"
    if m <= SKINNY_ROWS:
        return "skinny"
    if k % 8 == 0 and n % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "tiled"


def skinny_split(n: int, k: int, sms: int) -> tuple[int, int, int]:
    """(n_tile, k_chunk, n_split) of the split-K kernel: as many K chunks as
    fit the 128-column tiles into one wave of blocks (two 8-warp blocks on
    each of ``sms`` SMs: a second, partial wave would double the time of
    the SMs it lands on), as far as every warp keeps a 16-row step of its
    own and the chunks of a tile fit one cluster (:data:`SKINNY_MAX_SPLIT`).
    Chunks are multiples of 16 rows, so each starts at an even row (an NF4
    byte's two rows never straddle chunks), and every row of K lies in
    exactly one. The chunks' partials stay in the cluster's shared memory,
    so neither M nor the code type changes the plan."""
    tiles = -(-n // SKINNY_COLS)
    steps = -(-k // SKINNY_STEP)
    one_wave = max(1, SKINNY_BLOCKS_PER_SM * sms // tiles)
    n_split = max(1, min(one_wave, steps // SKINNY_WARPS, SKINNY_MAX_SPLIT))
    k_chunk = -(-steps // n_split) * SKINNY_STEP
    return SKINNY_COLS, k_chunk, -(-k // k_chunk)


def fused_linear_q_plain(x, data, scales, idx=None, val=None, bias=None, *, qdtype: str,
                         block: int):
    """Plain PyTorch version: dequantize, float32 product, bypass and bias,
    one cast."""
    counter.plain += 1
    return ref.fused_linear_q_ref(x, data, scales, idx, val, bias, qdtype=qdtype, block=block)


def _check(x, data, scales, idx, val, bias, qdtype: str, block: int) -> None:
    if qdtype not in _QDTYPES:
        raise ValueError(f"qdtype {qdtype!r} not in {tuple(_QDTYPES)}")
    if block < 2 or block % 2:
        raise ValueError(f"block must be even and >= 2, got {block}")
    if x.ndim != 2 or data.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"want x (M, K), data and scales 2-d; got {tuple(x.shape)}, "
                         f"{tuple(data.shape)}, {tuple(scales.shape)}")
    m, kd = x.shape
    n = data.shape[1]
    if kd == 0:
        raise ValueError("x has no columns (K = 0)")
    rows = kd // 2 if qdtype == "nf4" else kd
    if (qdtype == "nf4" and kd % 2) or data.shape[0] != rows:
        raise ValueError(f"{qdtype} data {tuple(data.shape)} does not hold K = {kd} rows")
    if scales.shape != (-(-kd // block), n):
        raise ValueError(f"scales {tuple(scales.shape)} != ({-(-kd // block)}, {n}) for "
                         f"K = {kd}, block {block}")
    if (idx is None) != (val is None):
        raise ValueError("idx and val come together (both None for no bypass)")
    if idx is not None and (idx.ndim != 2 or val.shape != idx.shape or idx.shape[1] != n):
        raise ValueError(f"idx/val {tuple(idx.shape)}/{tuple(val.shape)} != (k, {n})")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
    if x.dtype not in _DTYPES or (val is not None and val.dtype not in _DTYPES):
        raise TypeError(f"x/val must be float32 or bfloat16, got {x.dtype}/"
                        f"{None if val is None else val.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError(f"bias must have x's dtype {x.dtype}")
    if data.dtype != _QDTYPES[qdtype][1] or scales.dtype != torch.float32:
        raise TypeError(f"{qdtype} wants {_QDTYPES[qdtype][1]} data and float32 scales, "
                        f"got {data.dtype}/{scales.dtype}")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("x", x), ("data", data), ("scales", scales), ("idx", idx), ("val", val),
                    ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_linear_q(x, data, scales, idx=None, val=None, bias=None, *, qdtype: str,
                   block: int):
    """(M, K) @ dequant(packed (K[/2], N)) + bypass of (k, N) idx/val
    (+ bias (N,)) -> (M, N); ``idx = val = None`` for no bypass."""
    if not x.is_cuda:
        return fused_linear_q_plain(x, data, scales, idx, val, bias, qdtype=qdtype,
                                    block=block)
    _check(x, data, scales, idx, val, bias, qdtype, block)
    m, kd = x.shape
    n = data.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    k = 0 if idx is None else idx.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    v_dtype = _DTYPES[x.dtype if val is None else val.dtype]
    r = route(m, kd, n, x.dtype, (x.data_ptr(), data.data_ptr(), scales.data_ptr()))
    if r == "wgmma":
        _, rows, _, _ = linear_plan(m, n, kd, sm_count(x.device))
        rc = build.library().rt_fused_linear_q_wgmma(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(),
            None if idx is None else idx.data_ptr(), None if val is None else val.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            m, n, kd, k, block, _QDTYPES[qdtype][0], v_dtype, rows, stream,
        )
        build.check(rc, "fused_linear_q")
        counter.launched(r)
        return y
    if r == "skinny":
        _, k_chunk, n_split = skinny_split(n, kd, sm_count(x.device))
        rc = build.library().rt_fused_linear_q_skinny(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(),
            None if idx is None else idx.data_ptr(), None if val is None else val.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            m, n, kd, k, block, _QDTYPES[qdtype][0], v_dtype, k_chunk, n_split, stream,
        )
        build.check(rc, "fused_linear_q")
        counter.launched(r)
        return y
    rc = build.library().rt_fused_linear_q(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        None if idx is None else idx.data_ptr(), None if val is None else val.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        m, n, kd, k, block, _QDTYPES[qdtype][0], _DTYPES[x.dtype], v_dtype, stream,
    )
    build.check(rc, "fused_linear_q")
    counter.launched(r)
    return y


def matmul_q_cols_sharded(x, data, scales, *, qdtype: str, block: int):
    """Column-sharded ``x @ dequant(Wq)`` for the vocab-sharded serving
    head (port of the reference's ``matmul_q_cols_sharded``): x (M, K)
    whole, ``data``/``scales`` one rank's columns of the packed head (both
    carry ``d_out`` last, so they split together); the kernel with no
    bypass. Returns the rank's (M, N / tp) columns; the sampler's
    all-gather rebuilds the row."""
    y = fused_linear_q(x, data, scales, qdtype=qdtype, block=block)
    tp_counter.count(x)
    return y

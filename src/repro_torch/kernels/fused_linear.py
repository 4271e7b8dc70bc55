"""Fused frozen-base linear + NeuroAda bypass: a hand-written CUDA kernel
and its plain PyTorch version.

    y[m, n] = Σ_c x[m, c] · W[c, n] + Σ_j val[j, n] · x[m, idx[j, n]] (+ b[n])

x (M, K) and W (K, N) float32 or bf16 (the same dtype, as is the bias);
idx int32 and val (float32 or bf16) are (k, N). Products and sums run in
float32 and the result is cast once to x's dtype.

Replaces ``src/repro/kernels/fused_linear.py::fused_linear_pallas``. The
CUDA source (``csrc/fused_linear.cu``) carries the design note: the
product is computed in the kernel itself over any M, N and K — the Pallas
kernel needs K to divide by its 512-wide tile, which qwen2-1.5b's
``wdown`` (K = 8960) does not — and the bypass is added in the epilogue.
:func:`route` picks one of three kernels by shape before the launch:
bf16 that TMA can describe (K and N multiples of 8, x and W 16-byte
aligned) takes the Hopper mainloop of ``csrc/linear.cuh`` (TMA ring,
producer warp, wgmma consumer warpgroups) with tiles from
:func:`linear_plan`; other bf16 shapes a WMMA kernel; float32 an FMA
kernel.

:func:`fused_linear` launches the kernel for a CUDA tensor and uses the
plain version only for a CPU tensor; a build or launch failure raises.
The gradient lives in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.decode_attention import sm_count

counter = LaunchCounter("fused_linear")
REPLACES = "src/repro/kernels/fused_linear.py:54"
SOURCE = "src/repro_torch/kernels/csrc/fused_linear.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The Hopper mainloop's geometry (csrc/linear.cuh): a block owns TMA_COLS
# weight columns (two consumer warpgroups of 64, the wgmma M side) and one
# of TMA_ROWS rows of x (the wgmma N side, a multiple of 8 up to 256; one
# compiled kernel each), and walks K in TMA_BK-deep tiles. Its shared
# memory holds one block an SM.
TMA_COLS, TMA_BK, TMA_BLOCKS_PER_SM = 128, 64, 1
TMA_ROWS = (32, 64, 128, 192, 256)
# The plan's cost model, in units of one x row's share of a K tile's
# products: a tile also costs about 64 rows' worth (the weight tile's load,
# and on a packed base its dequantize, do not shrink with the rows), a block
# about 4 tiles' worth to start and finish (pipeline fill, epilogue).
_TILE_COST, _BLOCK_COST = 64, 256


def linear_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int, int]:
    """(tile_cols, tile_rows, col_tiles, row_tiles) of the Hopper mainloop
    for x (m, k) @ W (k, n) on ``sms`` SMs: the tile_rows of TMA_ROWS whose
    blocks finish soonest, counting whole waves (a block an SM), each block
    ``ceil(k / 64) * (tile_rows + 64) + 256`` in the units above; a tie
    takes the taller tile. So qwen2-1.5b's N = 1536 projections at M = 2048
    make 12 x 11 blocks of 192 rows (one wave), its N = 256 ones 2 x 64 of
    32 rows, N = 8960 70 x 11 of 192. Every output element lies in exactly
    one tile; the kernel masks the ragged edges."""
    if min(m, n, k, sms) < 1:
        raise ValueError(f"linear_plan needs positive sizes, got m={m} n={n} k={k} sms={sms}")
    col_tiles = -(-n // TMA_COLS)
    tiles_k = -(-k // TMA_BK)
    resident = TMA_BLOCKS_PER_SM * sms

    def cost(rows):
        blocks = col_tiles * -(-m // rows)
        return -(-blocks // resident) * (tiles_k * (rows + _TILE_COST) + _BLOCK_COST), -rows

    rows = min(TMA_ROWS, key=cost)
    return TMA_COLS, rows, col_tiles, -(-m // rows)


def route(m: int, k: int, n: int, dtype: torch.dtype, ptrs=()) -> str:
    """Which kernel serves x (m, k) @ W (k, n) on the card: ``"wgmma"``
    (bf16 where TMA can describe x and W: row strides ``k`` and ``n``
    multiples of 8 elements, every pointer in ``ptrs`` 16-byte aligned),
    ``"wmma"`` (other bf16 shapes) or ``"f32"``. Chosen by shape before the
    launch, never as a fallback."""
    if dtype == torch.float32:
        return "f32"
    if k % 8 == 0 and n % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "wmma"


def encode_ns(x, w, tile_rows: int, iters: int = 1000) -> float:
    """Host nanoseconds of the two tensor-map encodes one ``"wgmma"``
    launch makes for x and W (the mean of ``iters``)."""
    m, kd = x.shape
    total = build.library().rt_linear_encode_ns(x.data_ptr(), w.data_ptr(), m, w.shape[1], kd,
                                                tile_rows, iters)
    if total < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the tensor maps")
    return total / iters



def fused_linear_plain(x, w, idx, val, bias=None):
    """Plain PyTorch version: float32 product, bypass and bias, one cast."""
    counter.plain += 1
    return ref.fused_linear_ref(x, w, idx, val, bias)


def _check(x, w, idx, val, bias) -> None:
    if x.ndim != 2 or w.ndim != 2 or idx.ndim != 2 or val.shape != idx.shape:
        raise ValueError(
            f"want x (M, K), w (K, N), idx/val (k, N); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(idx.shape)}, {tuple(val.shape)}"
        )
    if x.shape[1] == 0:
        raise ValueError("x has no columns (K = 0)")
    if w.shape[0] != x.shape[1] or idx.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and idx "
                         f"{tuple(idx.shape)} do not chain")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} != ({w.shape[1]},)")
    if x.dtype not in _DTYPES or val.dtype not in _DTYPES:
        raise TypeError(f"x/val must be float32 or bfloat16, got {x.dtype}/{val.dtype}")
    if w.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"w and bias must have x's dtype {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("x", x), ("w", w), ("idx", idx), ("val", val), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_linear(x, w, idx, val, bias=None):
    """(M, K) @ (K, N) + bypass of (k, N) idx/val (+ bias (N,)) -> (M, N)."""
    if not x.is_cuda:
        return fused_linear_plain(x, w, idx, val, bias)
    _check(x, w, idx, val, bias)
    m, kd = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    r = route(m, kd, n, x.dtype, (x.data_ptr(), w.data_ptr()))
    if r == "wgmma":
        _, rows, _, _ = linear_plan(m, n, kd, sm_count(x.device))
        rc = build.library().rt_fused_linear_wgmma(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), val.data_ptr(), bias_ptr, y.data_ptr(),
            m, n, kd, idx.shape[0], rows, _DTYPES[val.dtype], stream,
        )
    else:
        rc = build.library().rt_fused_linear(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), val.data_ptr(), bias_ptr, y.data_ptr(),
            m, n, kd, idx.shape[0], _DTYPES[x.dtype], _DTYPES[val.dtype], stream,
        )
    build.check(rc, "fused_linear")
    counter.launched(r)
    return y

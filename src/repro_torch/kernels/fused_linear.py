"""Fused frozen-base linear + NeuroAda bypass: a hand-written CUDA kernel
and its plain PyTorch version.

    y[m, n] = Σ_c x[m, c] · W[c, n] + Σ_j val[j, n] · x[m, idx[j, n]] (+ b[n])

x (M, K) and W (K, N) float32 or bf16 (the same dtype, as is the bias);
idx int32 and val (float32 or bf16) are (k, N). Products and sums run in
float32 and the result is cast once to x's dtype.

Replaces ``src/repro/kernels/fused_linear.py::fused_linear_pallas``. The
CUDA source (``csrc/fused_linear.cu``) carries the design note: the
product is computed in the kernel itself (WMMA bf16 fragments with
float32 accumulators, or plain float32 FMA), over any M, N and K — the
Pallas kernel needs K to divide by its 512-wide tile, which qwen2-1.5b's
``wdown`` (K = 8960) does not — and the bypass is added in the epilogue.

:func:`fused_linear` launches the kernel for a CUDA tensor and uses the
plain version only for a CPU tensor; a build or launch failure raises.
The gradient lives in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("fused_linear")
REPLACES = "src/repro/kernels/fused_linear.py:54"
SOURCE = "src/repro_torch/kernels/csrc/fused_linear.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    rc = build.library().rt_fused_linear(
        x.data_ptr(), w.data_ptr(), idx.data_ptr(), val.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        m, n, kd, idx.shape[0], _DTYPES[x.dtype], _DTYPES[val.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "fused_linear")
    counter.kernel += 1
    return y

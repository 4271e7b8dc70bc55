"""Per-neuron top-k magnitude selection (NeuroAda phase 1): a hand-written
CUDA kernel and its plain PyTorch version.

w (B, d_in, d_out), float32 or bf16 -> (B, k, d_out) int32: for each
column of each matrix the k rows of largest |w|, by descending |w| with
ties to the lower row — the order of a stable descending sort and of the
reference's ``lax.top_k``, so the card and the CPU select the same bytes.
With ``largest=False`` the k rows of smallest |w|, by ascending |w|, ties
again to the lower row (a stable ascending sort; ``lax.top_k(-|w|)``, the
reference's ``reverse`` strategy). The ``gradient`` and ``random``
strategies pass their float32 scores as ``w``: they are non-negative, so
|score| is the score.

Replaces ``src/repro/kernels/topk_select.py::topk_select_pallas`` (body
``_topk_kernel``): one launch a whole stack, w read in its own dtype (no
float32 copy), any d_in, d_out and 1 <= k <= d_in (the Pallas kernel needs
d_in % min(1024, d_in) == 0), and a fixed order where the Pallas kernel
leaves it unspecified. The CUDA source (``csrc/topk_select.cu``) carries
the design note.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("topk_select")
REPLACES = "src/repro/kernels/topk_select.py:59"
SOURCE = "src/repro_torch/kernels/csrc/topk_select.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def topk_select_plain(w, k: int, largest: bool = True):
    """Plain PyTorch version: a stable sort of |w| in float32 (descending,
    or ascending for ``largest=False``), one matrix at a time."""
    counter.plain += 1
    return ref.topk_select_ref(w, k, largest)


def _check(w, k: int) -> None:
    if w.ndim != 3:
        raise ValueError(f"want w (B, d_in, d_out), got {tuple(w.shape)}")
    if not 1 <= w.shape[0] <= 65535:
        raise ValueError(f"batch {w.shape[0]} outside the grid's 1..65535")
    if not 1 <= k <= w.shape[1]:
        raise ValueError(f"k={k} out of range for d_in={w.shape[1]}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


def topk_select(w, k: int, largest: bool = True):
    """(B, d_in, d_out) -> (B, k, d_out) int32, sorted per column (largest
    |w| first, or smallest first for ``largest=False``)."""
    if not w.is_cuda:
        return topk_select_plain(w, k, largest)
    _check(w, k)
    b, d_in, d_out = w.shape
    idx = torch.empty((b, k, d_out), dtype=torch.int32, device=w.device)
    if d_out == 0:
        return idx
    rc = build.library().rt_topk_select(
        w.data_ptr(), idx.data_ptr(), b, d_in, d_out, k, _DTYPES[w.dtype], int(not largest),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    build.check(rc, "topk_select")
    counter.kernel += 1
    return idx

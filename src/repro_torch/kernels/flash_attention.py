"""Flash-attention forward of long-context training: a hand-written CUDA
kernel and its plain PyTorch version.

q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd) in the model layout, query
head ``h`` reading kv head ``h // (H // Hkv)``. Returns ``(out, lse)``:
``out`` (B, Sq, H, hd) in q's dtype, the causal (``q_pos >= k_pos``) or full
softmax(q kᵀ / √hd) v, and ``lse`` (B, H, Sq) float32, each row's
logsumexp, from which the backward recomputes the softmax. Scores,
softmax and sums in float32.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_fwd_pallas``
(body ``_flash_fwd_kernel``) with its GQA wrapper
``flash_attention_gqa_pallas``: any Sq and Skv (the Pallas kernel needs
multiples of 128), GQA by head index where the wrapper repeats k and v, q,
k and v read through their strides, and the logsumexp as a second output.
Bound by operations (51.5 GFLOP a causal qwen2-1.5b layer at S = 4096).

Three routes, chosen by shape in :func:`route` and counted under their
names in ``counter.routes``; a route that fails raises, it never gives way
to another. ``wgmma`` (bf16, hd 64 and 128, the path's): FlashAttention-3's
forward — a producer warp feeding Q, K and V by TMA through tensor maps over
the strided views into an mbarrier ring, two consumer warpgroups of 64 query
rows on ``wgmma`` (Q Kᵀ from shared memory, P V with P in registers).
``mma`` (bf16 at the other head dims): FlashAttention-2's split on
``mma.sync``, 64-row blocks of 4 warps, cp.async tiles. ``fma`` (float32):
a plain FMA kernel. The CUDA source (``csrc/flash_attention.cu``) carries
the design notes.

Rounding: the bf16 kernels run q kᵀ and p·v on the tensor cores with
float32 accumulators, and round p to bf16 before the p·v product (the
Pallas body multiplies p·v in float32); the row sum adds the unrounded p.
So bf16 agrees with the plain version to bf16 rounding (2e-2), float32
(the FMA kernel) to 2e-5.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("flash_attention_fwd")
REPLACES = "src/repro/kernels/flash_attention.py:75"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = tuple(range(16, 129, 16))
WGMMA_HEAD_DIMS = (64, 128)
# the wgmma route's key tile and ring depth (chip_smoke.py
# --attention-variants times the others the kernel is built for)
BLOCK_KEYS, STAGES = 128, 2


def flash_attention_fwd_plain(q, k, v, *, causal: bool):
    """Plain PyTorch version: dense float32 scores, masked softmax, lse."""
    counter.plain += 1
    return ref.flash_attention_fwd_ref(q, k, v, causal=causal)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} must be a multiple of 16 up to 128")
    if not 1 <= b <= 65535 or not 1 <= h <= 65535 or k.shape[1] == 0:
        raise ValueError(f"B={b}, H={h} outside the grid's 1..65535, or Skv = 0")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be unit-stride, strides {t.stride()}")
        # bf16 tiles move in 16-byte chunks: 8-element strides, aligned rows
        if t.dtype == torch.bfloat16 and (any(s % 8 for s in t.stride()[:3])
                                          or t.data_ptr() % 16):
            raise ValueError(f"{name}: bf16 rows must be 16-byte aligned, strides {t.stride()}")


def route(q, k, v) -> str:
    """``wgmma`` for bf16 at hd 64 / 128, ``mma`` for the other bf16 head
    dims, ``fma`` for float32. Every bf16 input ``_check`` passes is a view
    a tensor map can describe (strides whole multiples of 16 bytes, the
    head dim unit-stride, pointers 16-byte aligned)."""
    if q.dtype == torch.float32:
        return "fma"
    return "wgmma" if q.shape[3] in WGMMA_HEAD_DIMS else "mma"


def flash_attention_fwd(q, k, v, *, causal: bool):
    """-> (out (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32)."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    path = route(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library()
    if path == "wgmma":
        rc = lib.rt_flash_attention_fwd_wgmma(*ptrs, b, sq, skv, h, hkv, hd, int(causal),
                                              *strides, BLOCK_KEYS, STAGES, stream)
    else:
        rc = lib.rt_flash_attention_fwd(*ptrs, b, sq, skv, h, hkv, hd, int(causal),
                                        _DTYPES[q.dtype], *strides, stream)
    build.check(rc, f"flash_attention_fwd ({path})")
    counter.launched(path)
    return out, lse

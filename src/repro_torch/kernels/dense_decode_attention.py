"""Dense decode attention: a hand-written CUDA kernel and its plain
PyTorch version.

q (B, 1, H, hd) — one query token per slot — against a dense slot cache
k/v (B, Smax, Hkv, hd) with a per-slot frontier ``kv_valid_len`` (B,):
cache rows ``>= kv_valid_len[b]`` are invisible. Softmax in float32,
output in q's dtype; a slot with ``kv_valid_len = 0`` gets zeros.

With ``k_scale``/``v_scale`` (B, Smax // 16, Hkv) float32 the cache is int8
codes with one scale per (slot, 16-row group, kv-head), dequantized in
float32 (``code * scale``) before the softmax; Smax is then a whole number
of groups. The fp body counts on ``decode_attention``, the int8 body on
``decode_attention_q``, each launch under the paged decode's route ``ring``.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention_pallas``
(fp body ``_decode_attn_kernel``, int8 body ``_decode_attn_q_kernel``) and,
through :func:`decode_attention_sharded` (here, beside its kernel, where
the reference keeps it in ``decode_attention.py``), its tensor-parallel
dispatch ``decode_attention_sharded``. The CUDA source
(``csrc/dense_decode_attention.cu``) carries the design note: the paged
decode's kernel (warps with their own cp.async rings, ranges
merged in the block that finishes last) with each row tile's block resolved
by arithmetic instead of a table, tiles of 16 rows (the int8 scale group),
copied only up to the frontier, so Smax need not divide by the tile. The
launch is sized by the paged decode's ``decode_plan`` over the row tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.decode_attention import (
    DTYPES,
    ROUTE,
    check_kv,
    check_tp_heads,
    decode_plan,
    scratch,
    sm_count,
)

counter = LaunchCounter("decode_attention")
q_counter = LaunchCounter("decode_attention_q")
tp_counter = LaunchCounter("decode_attention_sharded")
REPLACES = "src/repro/kernels/decode_attention.py:135"
Q_REPLACES = "src/repro/kernels/decode_attention.py:87"
TP_REPLACES = "src/repro/kernels/decode_attention.py:412"
SOURCE = "src/repro_torch/kernels/csrc/dense_decode_attention.cu"

TILE = 16  # cache rows staged per step; the int8 cache's scale group


def decode_attention_plain(q, k, v, kv_valid_len, k_scale=None, v_scale=None):
    """Plain PyTorch version: (dequantize,) masked float32 softmax."""
    if k_scale is None:
        counter.plain += 1
        return ref.decode_attention_ref(q, k, v, kv_valid_len)
    q_counter.plain += 1
    return ref.decode_attention_q_ref(q, k, v, k_scale, v_scale, kv_valid_len)


def _check(q, k, v, vl, k_scale=None, v_scale=None) -> None:
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention needs q (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"cache {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    smax, hkv = k.shape[1], k.shape[2]
    if h % hkv or h // hkv > 32:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}, at most 32 per group")
    if hd > 256:
        raise ValueError(f"head dim {hd} > 256")
    if vl.shape != (b,) or vl.dtype != torch.int32:
        raise ValueError(f"kv_valid_len must be ({b},) int32")
    if k_scale is not None and smax % TILE:
        raise ValueError(f"an int8 cache needs Smax={smax} in whole groups of {TILE}")
    check_kv(q, k, v, k_scale, v_scale, (b, smax // TILE, hkv))
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_valid_len", vl)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention(q, k, v, kv_valid_len, k_scale=None, v_scale=None):
    """-> (B, 1, H, hd). ``kv_valid_len`` is a (B,) int32 tensor; with
    ``k_scale``/``v_scale`` the cache is int8."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, kv_valid_len, k_scale, v_scale)
    _check(q, k, v, kv_valid_len, k_scale, v_scale)
    b, _, h, hd = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    tiles = -(-smax // TILE)
    if b == 0 or smax == 0:
        return out.zero_()
    plan = decode_plan(b, hkv, h // hkv, tiles, sm_count(q.device), k.dtype, hd, TILE)
    part, tk = scratch(q, hkv, plan)
    tail = (b, smax, TILE, hkv, hd, h // hkv, plan.heads, plan.per, plan.ranges, plan.stages,
            plan.threads // 32, plan.smem, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = build.library()
    if k_scale is None:
        rc = lib.rt_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     kv_valid_len.data_ptr(), out.data_ptr(), part.data_ptr(),
                                     tk.data_ptr(), *tail)
        build.check(rc, "decode_attention")
        counter.launched(ROUTE)
        return out
    rc = lib.rt_decode_attention_q(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                                   v_scale.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(),
                                   part.data_ptr(), tk.data_ptr(), *tail)
    build.check(rc, "decode_attention_q")
    q_counter.launched(ROUTE)
    return out


def decode_attention_sharded(q, k, v, kv_valid_len, tp: int, heads: tuple[int, int],
                             k_scale=None, v_scale=None):
    """Tensor-parallel dispatch of the dense decode (port of the reference's
    ``decode_attention_sharded``): one rank's q heads (B, 1, H / tp, hd)
    against its kv-head slice of the slot cache (B, Smax, KV / tp, hd) and
    of the scales (B, Smax // 16, KV / tp). Returns the rank's heads; no
    collective runs here."""
    check_tp_heads(q, k, tp, heads, "decode_attention_sharded")
    out = decode_attention(q, k, v, kv_valid_len, k_scale, v_scale)
    tp_counter.count(q)
    return out

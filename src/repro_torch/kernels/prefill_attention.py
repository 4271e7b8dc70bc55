"""Paged chunked-prefill attention: a hand-written CUDA kernel and its
plain PyTorch version.

q (B, C, H, hd) — a chunk of C queries per slot — against k/v block pools
(N, P, Hkv, hd) through a (B, n_pages) int32 block table. Query ``i`` of
slot ``b`` sits at logical position ``q_offset[b] + i`` and sees column
``c`` iff ``c <= q_offset[b] + i`` and ``c < kv_valid_len[b]``; rows with
no visible column (idle slots) return zeros. Softmax in float32, output
in q's dtype. Pad rows past a slot's real chunk are well-defined and
discarded by the caller.

With ``k_scale``/``v_scale`` (N, Hkv) float32 the pools are int8 codes
(the int8 KV cache), each page dequantized in float32 before the softmax;
that body counts on ``paged_prefill_attention_q``.

Replaces ``src/repro/kernels/prefill_attention.py::paged_prefill_attention_pallas``
(fp body ``_paged_prefill_attn_kernel``, int8 body ``_paged_prefill_attn_q_kernel``),
and, through :func:`paged_prefill_attention_sharded`, its tensor-parallel
dispatch ``paged_prefill_attention_sharded`` (the same kernel on one rank's
heads and kv-head slice of the pools).
The CUDA source (``csrc/prefill_attention.cu``) carries the design note:
in bf16 the C·G folded rows of a (slot, kv-head) split into 64-row tiles
on the tensor cores (mma.sync, an online softmax in registers, 64-column
K/V tiles gathered page by page through the table by cp.async, each block
stopping at its rows' frontier); an int8 pool's codes are staged as int8
and widened to bf16 in shared memory, its scales applied to the scores
and to p. float32 keeps one warp per row.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.decode_attention import DTYPES, check_kv, check_tp_heads

counter = LaunchCounter("paged_prefill_attention")
q_counter = LaunchCounter("paged_prefill_attention_q")
tp_counter = LaunchCounter("paged_prefill_attention_sharded")
REPLACES = "src/repro/kernels/prefill_attention.py:150"
Q_REPLACES = "src/repro/kernels/prefill_attention.py:101"
TP_REPLACES = "src/repro/kernels/prefill_attention.py:242"
SOURCE = "src/repro_torch/kernels/csrc/prefill_attention.cu"


def paged_prefill_attention_plain(q, k_pool, v_pool, table, q_offset, kv_valid_len,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version: gather (and dequantize) pages, two-sided
    masked float32 softmax."""
    if k_scale is None:
        counter.plain += 1
        return ref.paged_prefill_attention_ref(
            q, k_pool, v_pool, table, q_offset, kv_valid_len
        )
    q_counter.plain += 1
    return ref.paged_prefill_attention_q_ref(q, k_pool, v_pool, k_scale, v_scale, table,
                                             q_offset, kv_valid_len)


def _check(q, k_pool, v_pool, table, qoff, vl, k_scale=None, v_scale=None) -> None:
    if q.ndim != 4:
        raise ValueError(f"prefill attention needs q (B, C, H, hd), got {tuple(q.shape)}")
    b, c, h, hd = q.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs hd {hd}")
    hkv = k_pool.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if hd > 256:
        raise ValueError(f"head dim {hd} > 256")
    if table.shape[0] != b or qoff.shape != (b,) or vl.shape != (b,):
        raise ValueError("table / q_offset / kv_valid_len must have B rows")
    check_kv(q, k_pool, v_pool, k_scale, v_scale, (k_pool.shape[0], hkv))
    if table.dtype != torch.int32 or qoff.dtype != torch.int32 or vl.dtype != torch.int32:
        raise TypeError("table, q_offset and kv_valid_len must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
                    ("q_offset", qoff), ("kv_valid_len", vl)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len, k_scale=None,
                            v_scale=None):
    """-> (B, C, H, hd). ``q_offset``/``kv_valid_len`` are (B,) int32 tensors;
    with ``k_scale``/``v_scale`` the pools are int8."""
    if not q.is_cuda:
        return paged_prefill_attention_plain(q, k_pool, v_pool, table, q_offset, kv_valid_len,
                                             k_scale, v_scale)
    _check(q, k_pool, v_pool, table, q_offset, kv_valid_len, k_scale, v_scale)
    b, c, h, hd = q.shape
    n, page, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0 or c == 0:
        return out
    ints = (b, c, n, page, hkv, hd, h // hkv, table.shape[1], DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = build.library()
    if k_scale is None:
        rc = lib.rt_paged_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            q_offset.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(), *ints)
        build.check(rc, "paged_prefill_attention")
        counter.kernel += 1
        return out
    rc = lib.rt_paged_prefill_attention_q(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), table.data_ptr(), q_offset.data_ptr(), kv_valid_len.data_ptr(),
        out.data_ptr(), *ints)
    build.check(rc, "paged_prefill_attention_q")
    q_counter.kernel += 1
    return out


def paged_prefill_attention_sharded(q, k_pool, v_pool, table, q_offset, kv_valid_len,
                                    tp: int, heads: tuple[int, int], k_scale=None,
                                    v_scale=None):
    """Tensor-parallel dispatch of the paged prefill (port of the
    reference's ``paged_prefill_attention_sharded``): one rank's query chunk
    (B, C, H / tp, hd) against its kv-head slice of the pools and scales;
    table, offsets and frontiers whole. Returns the rank's heads; no
    collective runs here."""
    check_tp_heads(q, k_pool, tp, heads, "paged_prefill_attention_sharded")
    out = paged_prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len, k_scale,
                                  v_scale)
    tp_counter.count(q)
    return out

"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch version.

q (B, 1, H, hd) — one query token per slot — against k/v block pools
(N, P, Hkv, hd) routed through a (B, n_pages) int32 block table, with a
per-slot frontier ``kv_valid_len`` (B,): cache positions ``>=
kv_valid_len[b]`` are invisible. Table entries out of range (the engine's
sentinel ``num_blocks``) mark unallocated pages; they always lie past the
frontier. Softmax in float32; output in q's dtype; a slot with
``kv_valid_len = 0`` gets zeros.

With ``k_scale``/``v_scale`` (N, Hkv) float32 the pools are int8 codes with
one scale per (block, kv-head) (the int8 KV cache): each page dequantizes in
float32, ``code * scale``, before the softmax. The int8 body has its own
counter, ``paged_decode_attention_q``, so a run shows which body served it.

Replaces ``src/repro/kernels/decode_attention.py::paged_decode_attention_pallas``
(fp body ``_paged_decode_attn_kernel``, int8 body ``_paged_decode_attn_q_kernel``).
The CUDA source (``csrc/decode_attention.cu``) carries the design note:
grid (slot, kv-head, page range), a warp per GQA row, pages swept only up to
the frontier, then a pass merging the ranges; bound by the K/V bytes read.
The wrapper sizes the page ranges to the card and allocates the float32
scratch for the partial results.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.counters import LaunchCounter

counter = LaunchCounter("paged_decode_attention")
q_counter = LaunchCounter("paged_decode_attention_q")
REPLACES = "src/repro/kernels/decode_attention.py:319"
Q_REPLACES = "src/repro/kernels/decode_attention.py:271"
SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_plain(q, k_pool, v_pool, table, kv_valid_len, k_scale=None,
                                 v_scale=None):
    """Plain PyTorch version: gather (and dequantize) pages, masked float32
    softmax."""
    if k_scale is None:
        counter.plain += 1
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, kv_valid_len)
    q_counter.plain += 1
    return ref.paged_decode_attention_q_ref(q, k_pool, v_pool, k_scale, v_scale, table,
                                            kv_valid_len)


def check_kv(q, k, v, k_scale, v_scale, scale_shape) -> None:
    """k/v share q's dtype, or are int8 with both float32 scales of
    ``scale_shape``; every tensor contiguous on q's device."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                            f"{q.dtype}/{k.dtype}/{v.dtype}")
        return
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"a scaled cache must be int8, got {k.dtype}/{v.dtype}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(scale_shape):
            raise ValueError(f"{name} must be float32 {tuple(scale_shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")


def _check(q, k_pool, v_pool, table, vl, k_scale=None, v_scale=None) -> None:
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention needs q (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs hd {hd}")
    hkv = k_pool.shape[2]
    if h % hkv or h // hkv > 32:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}, at most 32 per group")
    if hd > 256:
        raise ValueError(f"head dim {hd} > 256")
    if table.shape[0] != b or vl.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / kv_valid_len {tuple(vl.shape)} vs B={b}")
    check_kv(q, k_pool, v_pool, k_scale, v_scale, (k_pool.shape[0], hkv))
    if table.dtype != torch.int32 or vl.dtype != torch.int32:
        raise TypeError("table and kv_valid_len must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("kv_valid_len", vl)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def page_split(b: int, hkv: int, n_pages: int, sms: int) -> tuple[int, int]:
    """(pages per range, ranges): enough (slot, kv-head, range) blocks for
    about two per SM, every page covered (the dense decode splits its row
    tiles the same way)."""
    n_split = max(1, min(n_pages, -(-2 * sms // max(b * hkv, 1))))
    per = -(-n_pages // n_split)
    return per, -(-n_pages // per)


def paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len, k_scale=None,
                           v_scale=None):
    """-> (B, 1, H, hd). ``kv_valid_len`` is a (B,) int32 tensor; with
    ``k_scale``/``v_scale`` the pools are int8."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, table, kv_valid_len,
                                            k_scale, v_scale)
    _check(q, k_pool, v_pool, table, kv_valid_len, k_scale, v_scale)
    b, _, h, hd = q.shape
    n, page, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    n_pages = table.shape[1]
    if b == 0 or n_pages == 0:
        return out.zero_()
    per, n_split = page_split(b, hkv, n_pages, sm_count(q.device))
    part = torch.empty(b * h * n_split * (hd + 2), dtype=torch.float32, device=q.device)
    ints = (b, n, page, hkv, hd, h // hkv, n_pages, per, n_split, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = build.library()
    if k_scale is None:
        rc = lib.rt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            kv_valid_len.data_ptr(), out.data_ptr(), part.data_ptr(), *ints)
        build.check(rc, "paged_decode_attention")
        counter.kernel += 1
        return out
    rc = lib.rt_paged_decode_attention_q(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), table.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), *ints)
    build.check(rc, "paged_decode_attention_q")
    q_counter.kernel += 1
    return out

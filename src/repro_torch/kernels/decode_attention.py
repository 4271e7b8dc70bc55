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
Bound by the K/V bytes up to the frontiers, so the design is about bytes in
flight; the CUDA source (``csrc/decode_attention.cu``, the kernel in
``csrc/paged_attention.cuh``) carries the note: grid (slot x kv-head x
head chunk, page range), blocks of 4 warps whatever the GQA group, each warp
its own pages copied by cp.async into a ring of page stages in the pool's
own type, lanes split as (column, hd slice), the ranges merged in index
order by the block that finishes last. :func:`decode_plan` sizes it to the
card; every launch counts under the route ``ring``. The wrapper allocates
the float32 scratch of the ranges' partial results, and keeps the ticket
counters (zero between launches; the kernel resets them) per device: one
decode at a time on a device, as the engine runs them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


SMEM_MAX = 232448  # dynamic shared memory a block may use (227 KB)
BLOCKS_PER_SM = 16  # the grid's target: this many blocks for every SM
HEADS = 1  # query heads a block serves, at most
CODE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
ROUTE = "ring"


class DecodePlan(NamedTuple):
    threads: int  # 32 x warps
    per: int  # pages (row tiles) a range
    ranges: int
    stages: int  # pages a warp keeps in flight
    smem: int  # dynamic shared memory bytes of a block
    heads: int  # query heads a block serves
    head_chunks: int  # blocks that share a (slot, kv-head) and range: ceil(g / heads)


def decode_plan(b: int, hkv: int, g: int, n_pages: int, sms: int, pool_dtype: torch.dtype,
                hd: int, page: int = 16, *, blocks_per_sm: int = BLOCKS_PER_SM,
                max_stages: int = 4, max_warps: int = 4, max_heads: int = HEADS) -> DecodePlan:
    """The decode kernel's launch for a (b, ·, hkv · g, hd) query over
    ``n_pages`` pages of ``page`` rows a slot (the table's width: the
    frontiers are on the card, and reading them would wait for it).

    A block serves at most ``max_heads`` query heads of a GQA group: a
    warp's work a page grows with its heads (every column is scored and
    folded once a head), so a large group is split over blocks that each
    read the pages again, from L2. Each warp needs at least one page, so a
    range holds at least ``warps`` pages; within that, ranges are cut until
    the grid has about ``blocks_per_sm`` blocks an SM. A warp keeps up to
    ``max_stages`` of its pages in flight (as many as it has, and as fit in
    shared memory). The kernel (``launch_decode`` in
    ``csrc/paged_attention.cuh``) picks the hd slice of a lane as this does,
    and refuses a launch whose shared memory is short of its own reckoning.
    The keywords are for timing other plans."""
    e = 8 if hd <= 128 else 16
    gh = min(g, max_heads, 8 if e == 8 else 4)
    reg_heads = 1 << (gh - 1).bit_length()  # the kernel's register capacity: 1, 2, 4 or 8
    hc = -(-g // gh)
    pairs = b * hkv * hc
    rs = -(-hd // 16) * 16
    stage = 2 * page * rs * CODE_BYTES[pool_dtype] + 16
    warps = max_warps
    while warps > 1 and warps * stage > SMEM_MAX:
        warps //= 2
    if warps * stage > SMEM_MAX:
        raise ValueError(f"a page of {page} rows x hd {hd} ({pool_dtype}) does not fit a block")
    ranges = max(1, min(-(-n_pages // warps), -(-blocks_per_sm * sms // max(pairs, 1))))
    per = -(-n_pages // ranges)
    ranges = -(-n_pages // per)
    stages = max(1, min(max_stages, -(-per // warps), SMEM_MAX // (warps * stage)))
    smem = max(warps * stages * stage, warps * reg_heads * (rs + 2) * 4)
    return DecodePlan(32 * warps, per, ranges, stages, smem, gh, hc)


_TICKETS: dict[torch.device, torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters on ``device``, zero between
    launches (each launch's last blocks reset theirs)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def scratch(q, hkv: int, plan: DecodePlan):
    """(the float32 partial results of the ranges, the ticket counters: one
    for each (slot, kv-head, head chunk)) of one launch."""
    b, _, h, hd = q.shape
    part = torch.empty(b * h * plan.ranges * (hd + 2), dtype=torch.float32, device=q.device)
    return part, tickets(q.device, b * hkv * plan.head_chunks)


def paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len, k_scale=None,
                           v_scale=None):
    """-> (B, 1, H, hd). ``kv_valid_len`` is a (B,) int32 tensor; with
    ``k_scale``/``v_scale`` the pools are int8."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, table, kv_valid_len,
                                            k_scale, v_scale)
    _check(q, k_pool, v_pool, table, kv_valid_len, k_scale, v_scale)
    b, _, h, hd = q.shape
    _, page, hkv, _ = k_pool.shape
    if b == 0 or table.shape[1] == 0:
        return torch.zeros_like(q)
    plan = decode_plan(b, hkv, h // hkv, table.shape[1], sm_count(q.device), k_pool.dtype, hd,
                       page)
    return launch(q, k_pool, v_pool, table, kv_valid_len, k_scale, v_scale, plan)


def launch(q, k_pool, v_pool, table, kv_valid_len, k_scale, v_scale, plan: DecodePlan):
    """One launch of the kernel on checked CUDA inputs, sized by ``plan``."""
    b, _, h, hd = q.shape
    n, page, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    part, tk = scratch(q, hkv, plan)
    tail = (b, n, page, hkv, hd, h // hkv, plan.heads, table.shape[1], plan.per, plan.ranges,
            plan.stages, plan.threads // 32, plan.smem, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = build.library()
    if k_scale is None:
        rc = lib.rt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            kv_valid_len.data_ptr(), out.data_ptr(), part.data_ptr(), tk.data_ptr(), *tail)
        build.check(rc, "paged_decode_attention")
        counter.launched(ROUTE)
        return out
    rc = lib.rt_paged_decode_attention_q(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), table.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), tk.data_ptr(), *tail)
    build.check(rc, "paged_decode_attention_q")
    q_counter.launched(ROUTE)
    return out

"""Attention of the port (port of ``repro.models.attention``).

Serving: paged prefill and decode and dense decode dispatch to the
hand-written kernels for CUDA tensors and to their plain versions for CPU
tensors (see :mod:`repro_torch.kernels.ops`); an int8 cache passes its
scales along and the kernels dequantize tile by tile. The dense engine's
chunk step is no kernel in the reference either: :func:`chunk_attention`
dequantizes the cache view (cast to q's dtype, as the reference does) and
runs :func:`dense_attention`.

Training: :func:`dense_attention`, plain PyTorch with a float32 softmax, as
the reference's training attention is no Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

_MASKED = -1e30


def dense_attention(q, k, v, *, causal: bool, q_offset=None, kv_valid_len=None):
    """q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd) -> (B, Sq, H, hd). Scores
    and softmax in float32, the weights cast to v's dtype for the value
    product. ``causal`` masks column ``c > q_offset[b] + i`` for query ``i``
    (``q_offset`` (B,), default 0); ``kv_valid_len`` (B,) masks columns
    ``>= kv_valid_len[b]``."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd**-0.5
    col = torch.arange(skv, device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)
        if q_offset is None:
            mask = qpos[:, None] >= col[None, :]  # (Sq, Skv)
        else:
            qpos = q_offset.to(q.device)[:, None] + qpos[None, :]  # (B, Sq)
            mask = (qpos[:, :, None] >= col)[:, None, None]  # (B, 1, 1, Sq, Skv)
    if kv_valid_len is not None:
        vmask = col < kv_valid_len.to(q.device)[:, None, None, None, None]
        mask = vmask if mask is None else mask & vmask
    if mask is not None:
        s = s.masked_fill(~mask, _MASKED)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def train_attention(q, k, v, cfg):
    """Causal self-attention of a training forward. The reference takes
    :func:`dense_attention` below ``cfg.flash_threshold`` and a flash scan
    with its own backward at or above it; the scan is not ported yet."""
    if k.shape[1] >= cfg.flash_threshold:
        raise NotImplementedError(
            f"training at sequence length {k.shape[1]} >= flash_threshold "
            f"{cfg.flash_threshold} needs the flash scan with its custom backward, "
            "which the port does not have yet (ROADMAP.md §1, 'flash attention for "
            "training')")
    return dense_attention(q, k, v, causal=True)


def paged_prefill_attention(q, k_pool, v_pool, table, *, q_offset, kv_valid_len,
                            k_scale=None, v_scale=None):
    """Query chunk (B, C, H, hd) against (num_blocks, P, Hkv, hd) pools, with
    the intra-chunk causal mask from ``q_offset`` and the post-write
    frontier ``kv_valid_len``; int8 pools bring their (num_blocks, Hkv)
    scales."""
    return ops.prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len,
                                 k_scale, v_scale)


def paged_attention(q, k_pool, v_pool, table, *, kv_valid_len, k_scale=None, v_scale=None):
    """One decode token per slot (B, 1, H, hd) against the paged pools."""
    return ops.paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len, k_scale,
                                      v_scale)


def attention(q, k, v, *, kv_valid_len, k_scale=None, v_scale=None):
    """One decode token per slot (B, 1, H, hd) against the dense slot cache
    (B, Smax, Hkv, hd): the dense decode kernel (the reference's decode
    dispatch to ``decode_attention_pallas``); an int8 cache brings its
    (B, Smax // 16, Hkv) scales."""
    return ops.decode_attention(q, k, v, kv_valid_len, k_scale, v_scale)


def chunk_attention(q, k, v, *, q_offset, kv_valid_len, k_scale=None, v_scale=None):
    """Chunked-prefill attention against the dense slot cache (B, Smax, Hkv,
    hd), whose rows the chunk has just written: the two-sided masked dense
    softmax. An int8 cache dequantizes its view first and casts it to q's
    dtype, as the reference does (no kernel here in the reference either)."""
    if k_scale is not None:
        k = ref.dequant_dense_kv(k, k_scale).to(q.dtype)
        v = ref.dequant_dense_kv(v, v_scale).to(q.dtype)
    return dense_attention(q, k, v, causal=True, q_offset=q_offset, kv_valid_len=kv_valid_len)

"""Attention of the port (port of ``repro.models.attention``).

Serving: paged prefill and decode and dense decode dispatch to the
hand-written kernels for CUDA tensors and to their plain versions for CPU
tensors (see :mod:`repro_torch.kernels.ops`); an int8 cache passes its
scales along and the kernels dequantize tile by tile. The dense engine's
chunk step is no kernel in the reference either: :func:`chunk_attention`
dequantizes the cache view (cast to q's dtype, as the reference does) and
runs :func:`dense_attention`.

Training: :func:`train_attention` takes :func:`dense_attention` (plain
PyTorch with a float32 softmax) below ``cfg.flash_threshold`` and
:func:`flash_attention` at or above it, as the reference does, causal or
not (the encoder-decoder's encoder and cross-attention). The flash
forward is the hand-written kernel (its plain version on the CPU); its
backward is the reference's FlashAttention-2 scan (``_flash_core_bwd``) in
plain PyTorch, as the reference leaves it to XLA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd

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


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool, block: int):
    """The reference's ``_flash_core_bwd`` in plain PyTorch: per KV block of
    ``block`` keys, p recomputed from the forward's ``lse`` and dq, dk, dv
    formed in float32 — O(S·block) memory, never S². Returns dq in q's
    dtype, dk and dv in k's and v's. ``delta = Σ dout·out`` reads ``out`` in
    q's dtype (the reference keeps the scan's float32 out: the same in
    float32). The same sums in another order: q is scaled by hd^-0.5 once
    (so s needs no scaling pass and dk none after), only p is masked (a
    masked p is 0 either way), and query rows before a causal block's first
    key, which see none of it, are skipped."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = hd**-0.5

    def grouped(t):  # (B, S, H, hd) -> (B, Hkv, G, S, hd) float32
        return t.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).float()

    qs_all, do = grouped(q) * scale, grouped(dout)
    delta = (do * grouped(out)).sum(dim=-1)  # (B, Hkv, G, Sq)
    lse = lse.reshape(b, hkv, g, sq)
    dq = torch.zeros_like(qs_all)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    qpos = torch.arange(sq, device=q.device)
    for start in range(0, skv, block):
        kb = k[:, start:start + block].float()
        vb = v[:, start:start + block].float()
        r0 = min(start, sq) if causal else 0
        qs, dos = qs_all[..., r0:, :], do[..., r0:, :]
        p = torch.exp(torch.einsum("bkgqh,bskh->bkgqs", qs, kb) - lse[..., r0:, None])
        if causal:
            p.masked_fill_(qpos[r0:, None] < torch.arange(start, start + kb.shape[1],
                                                          device=q.device)[None, :], 0.0)
        # dv and dk per query head, the groups summed after: B·H products of
        # (block, hd), not B·Hkv with a (group x rows)-long contraction
        dv[:, start:start + block] = torch.einsum(
            "bkgqs,bkgqh->bkgsh", p, dos).sum(dim=2).transpose(1, 2).to(v.dtype)
        ds = torch.einsum("bkgqh,bskh->bkgqs", dos, vb).sub_(delta[..., r0:, None]).mul_(p)
        dq[..., r0:, :] += torch.einsum("bkgqs,bskh->bkgqh", ds, kb)
        dk[:, start:start + block] = torch.einsum(
            "bkgqs,bkgqh->bkgsh", ds, qs).sum(dim=2).transpose(1, 2).to(k.dtype)
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return dq.to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel (out and the row logsumexp). Backward:
    :func:`flash_attention_bwd`, the reference's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block):
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block = causal, block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         block=ctx.block)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool, block: int):
    """Online-softmax attention with a flash backward (port of the
    reference's ``flash_attention`` at ``q_offset`` 0): q (B, Sq, H, hd), k/v
    (B, Skv, Hkv, hd) -> (B, Sq, H, hd) in q's dtype, differentiable in q, k
    and v. Like the reference it refuses an Skv that ``block`` does not
    divide (the backward's KV blocks)."""
    skv = k.shape[1]
    if skv % block:
        raise ValueError(f"Skv={skv} must be a multiple of block={block}")
    return _FlashAttention.apply(q, k, v, causal, block)


def train_attention(q, k, v, cfg, *, causal: bool = True):
    """Attention of a whole-sequence forward (training, prefill; the
    reference's dispatch for ``Sq > 1`` without ``kv_valid_len``):
    :func:`flash_attention` with ``cfg.flash_block`` from
    ``cfg.flash_threshold`` keys on, :func:`dense_attention` below it or for
    a single query row. ``causal=False`` is the encoder's self-attention and
    the cross-attention (Sq may differ from Skv there)."""
    if q.shape[1] > 1 and k.shape[1] >= cfg.flash_threshold:
        return flash_attention(q, k, v, causal=causal, block=cfg.flash_block)
    return dense_attention(q, k, v, causal=causal)


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

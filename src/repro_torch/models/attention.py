"""Attention of the port (port of ``repro.models.attention``).

Serving: paged prefill and decode dispatch to the hand-written kernels for
CUDA tensors and to their plain versions for CPU tensors (see
:mod:`repro_torch.kernels.ops`); the reference's jnp fallback — gather the
pages, dense masked softmax — is what the plain versions compute.

Training: :func:`dense_attention`, plain PyTorch with a float32 softmax, as
the reference's training attention is no Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

_MASKED = -1e30


def dense_attention(q, k, v, *, causal: bool):
    """q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd) -> (B, Sq, H, hd). Scores
    and softmax in float32, the weights cast to v's dtype for the value
    product; ``causal`` masks column ``c > i`` for query ``i``."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd**-0.5
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(
            skv, device=q.device)[None, :]
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


def paged_prefill_attention(q, k_pool, v_pool, table, *, q_offset, kv_valid_len):
    """Query chunk (B, C, H, hd) against (num_blocks, P, Hkv, hd) pools, with
    the intra-chunk causal mask from ``q_offset`` and the post-write
    frontier ``kv_valid_len``."""
    return ops.prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len)


def paged_attention(q, k_pool, v_pool, table, *, kv_valid_len):
    """One decode token per slot (B, 1, H, hd) against the paged pools."""
    return ops.paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len)

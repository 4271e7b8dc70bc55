"""Paged attention of the serving path (port of
``repro.models.attention.paged_prefill_attention`` / ``paged_attention``).

Both dispatch to the hand-written kernels for CUDA tensors and to their
plain versions for CPU tensors (see :mod:`repro_torch.kernels.ops`); the
reference's jnp fallback — gather the pages, dense masked softmax — is
what the plain versions compute.
"""

from __future__ import annotations

from repro_torch.kernels import ops


def paged_prefill_attention(q, k_pool, v_pool, table, *, q_offset, kv_valid_len):
    """Query chunk (B, C, H, hd) against (num_blocks, P, Hkv, hd) pools, with
    the intra-chunk causal mask from ``q_offset`` and the post-write
    frontier ``kv_valid_len``."""
    return ops.prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len)


def paged_attention(q, k_pool, v_pool, table, *, kv_valid_len):
    """One decode token per slot (B, 1, H, hd) against the paged pools."""
    return ops.paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len)

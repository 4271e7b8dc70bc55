"""Public entry points of the serving kernels (port of the matching
wrappers in ``repro.kernels.ops``).

Each reshapes and broadcasts its arguments to the kernel's contract and
calls the kernel module's wrapper, which launches the CUDA kernel for a
CUDA tensor and the plain PyTorch version for a CPU tensor. There is no
backend switch: the tensor's device decides. Offsets and lengths are (B,)
int32 tensors, as the engine builds them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import paged_decode_attention as _decode
from repro_torch.kernels.prefill_attention import paged_prefill_attention as _prefill
from repro_torch.kernels.sparse_delta import sparse_delta_batched


def delta_apply_batched(x, idx, val, aid):
    """Multi-tenant bypass: x (..., d_in) × stacks (N, k, d_out) selected per
    row by ``aid`` -> (..., d_out). ``aid`` broadcasts left-aligned against
    ``x.shape[:-1]`` (the engine passes (B,) ids for (B, S, d_in) rows)."""
    lead = x.shape[:-1]
    aid = aid.reshape(tuple(aid.shape) + (1,) * (len(lead) - aid.ndim))
    aid = aid.expand(lead).reshape(-1).to(torch.int32).contiguous()
    y = sparse_delta_batched(x.reshape(-1, x.shape[-1]).contiguous(), idx, val, aid)
    return y.reshape(*lead, idx.shape[-1])


def paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len):
    """q (B, 1, H, hd) against (N, P, Hkv, hd) pools through a (B, n_pages)
    table; ``kv_valid_len`` (B,) int32."""
    return _decode(q.contiguous(), k_pool, v_pool, table.contiguous(), kv_valid_len)


def prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len):
    """Query chunk q (B, C, H, hd) against the paged pools with the
    two-sided (causal × frontier) mask; offsets and lengths (B,) int32."""
    return _prefill(q.contiguous(), k_pool, v_pool, table.contiguous(), q_offset,
                    kv_valid_len)

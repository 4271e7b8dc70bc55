"""Public entry points of the kernels (port of the matching wrappers in
``repro.kernels.ops``).

Each reshapes and broadcasts its arguments to the kernel's contract and
calls the kernel module's wrapper, which launches the CUDA kernel for a
CUDA tensor and the plain PyTorch version for a CPU tensor. There is no
backend switch: the tensor's device decides. Offsets and lengths are (B,)
int32 tensors, as the engine builds them. :func:`fused_linear` carries the
training gradient (the reference's ``custom_vjp``) as a
``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_linear as _fl
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import paged_decode_attention as _decode
from repro_torch.kernels.prefill_attention import paged_prefill_attention as _prefill
from repro_torch.kernels.sparse_delta import sparse_delta_batched, sparse_delta_dval


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


class _FusedLinear(torch.autograd.Function):
    """Forward: the fused kernel. Backward, as the reference's
    ``_fused_bwd``: ``dx = dy @ Wᵀ`` (a plain matmul, as the reference
    leaves it to XLA) plus the sparse scatter of the bypass (plain
    ``index_add_``, as the reference's ``sparse_delta_dx_ref``); ``dval``
    from the value-gradient kernel, cast to the values' dtype; ``dbias =
    Σ_m dy``; a ``dw`` only for a W declared trainable. Gradients are
    computed only for the inputs that need them."""

    @staticmethod
    def forward(ctx, x2d, w, idx, val, bias, w_frozen):
        ctx.save_for_backward(x2d, w, idx, val)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.w_frozen = w_frozen
        return _fl.fused_linear(x2d, w, idx, val, bias)

    @staticmethod
    def backward(ctx, dy):
        x2d, w, idx, val = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, need_w, _, need_val, need_b, _ = ctx.needs_input_grad
        dx = dw = dval = dbias = None
        if need_x:
            dx = dy @ w.T + ref.sparse_delta_dx_ref(idx, val, dy, x2d.shape[1]).to(x2d.dtype)
        if need_w and not ctx.w_frozen:
            dw = (x2d.T @ dy).to(w.dtype)
        if need_val:
            dval = sparse_delta_dval(x2d, idx, dy).to(val.dtype)
        if need_b:
            dbias = dy.sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, None, dval, dbias, None


def fused_linear(x, w, idx, val, bias=None, *, w_frozen: bool = False):
    """y = x @ W (+ bias) + bypass through the fused kernel, differentiable
    in x, the values and the bias. ``w_frozen=True`` declares W
    non-trainable (the NeuroAda contract): the backward never forms a
    ``dw``. x is (..., K); idx/val (k, N) -> (..., N)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    y = _FusedLinear.apply(x2d, w, idx, val, bias, w_frozen)
    return y.reshape(*lead, w.shape[-1])

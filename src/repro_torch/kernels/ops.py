"""Public entry points of the kernels (port of the matching wrappers in
``repro.kernels.ops``).

Each reshapes and broadcasts its arguments to the kernel's contract and
calls the kernel module's wrapper, which launches the CUDA kernel for a
CUDA tensor and the plain PyTorch version for a CPU tensor. There is no
backend switch: the tensor's device decides. Offsets and lengths are (B,)
int32 tensors, as the engine builds them. :func:`delta_apply`,
:func:`fused_linear` and :func:`fused_linear_q` carry the training
gradient (the reference's ``custom_vjp``) as ``torch.autograd.Function``
classes; :func:`matmul_q` is the base matmul of a plain or packed weight;
:func:`topk_select` is the selection of NeuroAda's phase 1. (Long-context
training attention, whose backward is plain PyTorch, is an autograd
function in ``models.attention`` around ``kernels.flash_attention``.)
:func:`keep_linear_outputs` is the ``context_fn`` of the ``dots``
recomputation: the fused linears' outputs are kept from the forward and
handed back when the layer is recomputed, so their kernels launch once.
"""

from __future__ import annotations

import collections
import math

import torch

from repro_torch.kernels import fused_linear as _fl
from repro_torch.kernels import quant_linear as _ql
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import paged_decode_attention as _decode
from repro_torch.kernels.dense_decode_attention import decode_attention as _dense_decode
from repro_torch.kernels.prefill_attention import paged_prefill_attention as _prefill
from repro_torch.kernels.sparse_delta import sparse_delta, sparse_delta_batched, sparse_delta_dval
from repro_torch.kernels.topk_select import topk_select as _topk_select
from repro_torch.quant.qtensor import QuantizedTensor, dequantize


def delta_apply_batched(x, idx, val, aid, y=None, bias=None):
    """Multi-tenant bypass: x (..., d_in) × stacks (N, k, d_out) selected per
    row by ``aid`` -> (..., d_out). ``aid`` broadcasts left-aligned against
    ``x.shape[:-1]`` (the engine passes (B,) ids for (B, S, d_in) rows): where
    its shape leads x's, the kernel reads one id for every row it covers, and
    no per-row copy is made. With ``y`` (..., d_out), the base product x @ W
    in x's dtype, the bypass and then ``bias`` are added into ``y`` in place
    in the kernel's epilogue — the bits of ``y + delta`` then ``+
    bias.to(y.dtype)``, one launch — and ``y`` comes back (serving only: a
    ``y`` that requires grad is refused)."""
    lead = x.shape[:-1]
    if tuple(aid.shape) == tuple(lead[:aid.ndim]):  # an id for every row or sequence
        rows_per_id = math.prod(lead[aid.ndim:])
    else:
        aid = aid.reshape(tuple(aid.shape) + (1,) * (len(lead) - aid.ndim)).expand(lead)
        rows_per_id = 1
    aid = aid.reshape(-1).to(torch.int32).contiguous()
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if y is None:
        out = sparse_delta_batched(x2d, idx, val, aid, rows_per_id)
        return out.reshape(*lead, idx.shape[-1])
    sparse_delta_batched(x2d, idx, val, aid, rows_per_id, y.view(-1, y.shape[-1]), bias)
    return y


class _DeltaApply(torch.autograd.Function):
    """Forward: the single-tenant bypass kernel over a leading batch axis.
    Backward, as the reference's ``_delta_bwd``: ``dval`` from the
    value-gradient kernel (one launch for the whole batch), written in the
    values' dtype; ``dx`` by the plain scatter of ``sparse_delta_dx_ref``."""

    @staticmethod
    def forward(ctx, x3, idx, val):
        ctx.save_for_backward(x3, idx, val)
        return sparse_delta(x3, idx, val)

    @staticmethod
    def backward(ctx, dy):
        x3, idx, val = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, _, need_val = ctx.needs_input_grad
        dx = dval = None
        if need_x:
            dx = ref.sparse_delta_dx_ref(idx, val, dy, x3.shape[2]).to(x3.dtype)
        if need_val:
            dval = sparse_delta_dval(x3, idx, dy, val.dtype)
        return dx, None, dval


def delta_apply(x, idx, val):
    """Single-tenant NeuroAda bypass, differentiable in x and the values:
    x (..., d_in) × Delta (k, d_out) -> (..., d_out), or an expert stack
    x (E, ..., d_in) × (E, k, d_out) -> (E, ..., d_out), each expert on its
    own rows. Either way one kernel launch."""
    if idx.ndim == 2:
        y = delta_apply(x.reshape(1, -1, x.shape[-1]), idx[None], val[None])
        return y.reshape(*x.shape[:-1], idx.shape[-1])
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
    y = _DeltaApply.apply(x3, idx.contiguous(), val.contiguous())
    return y.reshape(*x.shape[:-1], idx.shape[-1])


def decode_attention(q, k, v, kv_valid_len, k_scale=None, v_scale=None):
    """q (B, 1, H, hd) against a dense (B, Smax, Hkv, hd) slot cache;
    ``kv_valid_len`` (B,) int32. With ``k_scale``/``v_scale`` (B, Smax // 16,
    Hkv) the cache is int8."""
    return _dense_decode(q.contiguous(), k, v, kv_valid_len, k_scale, v_scale)


def paged_decode_attention(q, k_pool, v_pool, table, kv_valid_len, k_scale=None,
                           v_scale=None):
    """q (B, 1, H, hd) against (N, P, Hkv, hd) pools through a (B, n_pages)
    table; ``kv_valid_len`` (B,) int32. With ``k_scale``/``v_scale`` (N, Hkv)
    the pools are int8."""
    return _decode(q.contiguous(), k_pool, v_pool, table.contiguous(), kv_valid_len,
                   k_scale, v_scale)


def prefill_attention(q, k_pool, v_pool, table, q_offset, kv_valid_len, k_scale=None,
                      v_scale=None):
    """Query chunk q (B, C, H, hd) against the paged pools with the
    two-sided (causal × frontier) mask; offsets and lengths (B,) int32. With
    ``k_scale``/``v_scale`` (N, Hkv) the pools are int8."""
    return _prefill(q.contiguous(), k_pool, v_pool, table.contiguous(), q_offset,
                    kv_valid_len, k_scale, v_scale)


_KEEP = None  # (deque, recording) inside a ``dots`` recomputation's contexts


class _KeepOutputs:
    """One of :func:`keep_linear_outputs`'s two contexts."""

    def __init__(self, store, recording: bool):
        self.store, self.recording = store, recording

    def __enter__(self):
        global _KEEP
        self.prev, _KEEP = _KEEP, (self.store, self.recording)

    def __exit__(self, *exc):
        global _KEEP
        _KEEP = self.prev


def keep_linear_outputs():
    """The (forward, recompute) contexts of ``torch.utils.checkpoint`` for
    the ``dots`` policy: in the forward every fused linear (dense or packed)
    keeps its output; in the recomputation each takes its kept output back,
    in order, instead of launching its kernel. Selective checkpointing by
    operator cannot do this: the kernels are launched through ``ctypes``
    inside autograd functions, which the dispatcher never sees."""
    store = collections.deque()
    return _KeepOutputs(store, True), _KeepOutputs(store, False)


def _kept(launch):
    """``launch()``, or the output the ``dots`` forward kept for it."""
    if _KEEP is None:
        return launch()
    store, recording = _KEEP
    if not recording:
        return store.popleft()
    y = launch()
    store.append(y.detach())
    return y


class _FusedLinear(torch.autograd.Function):
    """Forward: the fused kernel. Backward, as the reference's
    ``_fused_bwd``: ``dx = dy @ Wᵀ`` (a plain matmul, as the reference
    leaves it to XLA) plus the sparse scatter of the bypass (the plain,
    deterministic ``sparse_delta_dx_ref``); ``dval``
    from the value-gradient kernel, written in the values' dtype; ``dbias =
    Σ_m dy``; a ``dw`` only for a W declared trainable. Gradients are
    computed only for the inputs that need them."""

    @staticmethod
    def forward(ctx, x2d, w, idx, val, bias, w_frozen):
        ctx.save_for_backward(x2d, w, idx, val)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.w_frozen = w_frozen
        return _kept(lambda: _fl.fused_linear(x2d, w, idx, val, bias))

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
            dval = sparse_delta_dval(x2d, idx, dy, val.dtype)
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


class _FusedLinearQ(torch.autograd.Function):
    """Forward: the fused dequant kernel. Backward, as the reference's
    ``_fused_q_bwd``: no gradient for the packed codes or scales (the base is
    frozen by construction); ``dx = dy @ dequant(W)ᵀ`` with a plain
    dequantize and a plain matmul (the reference leaves it to XLA) plus the
    sparse scatter of the bypass; ``dval`` from the value-gradient kernel;
    ``dbias = Σ_m dy``.

    Only the packed ``data`` and ``scales`` are saved, never a dense weight:
    ``dx``'s weight is dequantized transiently, in the weight's logical dtype
    (``dtype_name``), and the product runs in the promotion of that dtype and
    dy's. In float32 that is exactly the reference's float32 product; on a
    bf16 base it is a bf16 × bf16 matmul with float32 accumulation where the
    reference multiplies by the float32 dequantized weight — the weight
    rounds once more, to bf16 (relative 2⁻⁹ per element), which bf16
    training tolerances (2e-2) cover, and it spares the card a float32 GEMM
    of 2048 × 8960 × 1536 per projection."""

    @staticmethod
    def forward(ctx, x2d, data, scales, idx, val, bias, qdtype, block, dtype_name):
        ctx.save_for_backward(x2d, data, scales, idx, val)
        ctx.meta = (qdtype, block, dtype_name)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _kept(lambda: _ql.fused_linear_q(x2d, data, scales, idx, val, bias,
                                                qdtype=qdtype, block=block))

    @staticmethod
    def backward(ctx, dy):
        x2d, data, scales, idx, val = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, _, _, _, need_val, need_b = ctx.needs_input_grad[:6]
        dx = dval = dbias = None
        if need_x:
            w = dequantize(QuantizedTensor(data, scales, *ctx.meta))
            ct = torch.promote_types(dy.dtype, w.dtype)
            dx = (dy.to(ct) @ w.to(ct).T).to(x2d.dtype)
            if idx is not None:
                dx = dx + ref.sparse_delta_dx_ref(idx, val, dy, x2d.shape[1]).to(x2d.dtype)
        if need_val:
            dval = sparse_delta_dval(x2d, idx, dy, val.dtype)
        if need_b:
            dbias = dy.sum(dim=0).to(ctx.bias_dtype)
        return dx, None, None, None, dval, dbias, None, None, None


def fused_linear_q(x, qw: QuantizedTensor, idx, val, bias=None):
    """y = x @ dequant(Wq) (+ bias) + bypass through the fused dequant
    kernel, differentiable in x, the values and the bias; the packed base
    never gets a gradient. x is (..., K); idx/val (k, N) -> (..., N)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    y = _FusedLinearQ.apply(x2d, qw.data, qw.scales, idx, val, bias, qw.qdtype, qw.block,
                            qw.dtype_name)
    return y.reshape(*lead, qw.shape[-1])


def matmul_q(x, w):
    """x @ W for a plain or packed W, with no bypass: the base matmul of a
    serving step. A packed W runs the fused dequant kernel with ``k = 0``
    (the reference's zero bypass), differentiable in x; a plain W goes to
    ``x @ w``. Where no gradient is wanted (serving), the kernel's wrapper is
    called directly: an autograd Function costs the host more than the
    decode-row kernel costs the card."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        y = _FusedLinearQ.apply(x2d, w.data, w.scales, None, None, None, w.qdtype, w.block,
                                w.dtype_name)
    else:
        y = _ql.fused_linear_q(x2d, w.data, w.scales, qdtype=w.qdtype, block=w.block)
    return y.reshape(*lead, w.shape[-1])


class _PackedBmm(torch.autograd.Function):
    """``eh @ dequant(Wq)`` over an expert stack, as the reference's MoE
    computes it in plain jnp: the packed stack is dequantized per call to
    eh's dtype and multiplied by ``torch.bmm``. Only the codes and scales
    are saved; the backward dequantizes the same transient dense stack again
    for ``dx = dy @ Wᵀ``, and no gradient reaches the codes."""

    @staticmethod
    def forward(ctx, eh, data, scales, qdtype, block, dtype_name):
        ctx.save_for_backward(data, scales)
        ctx.meta = (qdtype, block, dtype_name)
        return torch.bmm(eh, dequantize(QuantizedTensor(data, scales, *ctx.meta)).to(eh.dtype))

    @staticmethod
    def backward(ctx, dy):
        data, scales = ctx.saved_tensors
        w = dequantize(QuantizedTensor(data, scales, *ctx.meta)).to(dy.dtype)
        return torch.bmm(dy, w.transpose(1, 2)), None, None, None, None, None


def bmm_q(eh, w):
    """eh (E, R, d_in) @ w (E, d_in, d_out) for a plain or packed expert
    stack, differentiable in eh; a packed stack never gets a gradient."""
    if not isinstance(w, QuantizedTensor):
        return torch.bmm(eh, w)
    if torch.is_grad_enabled() and eh.requires_grad:
        return _PackedBmm.apply(eh, w.data, w.scales, w.qdtype, w.block, w.dtype_name)
    return torch.bmm(eh, dequantize(w).to(eh.dtype))


def topk_select(w, k: int, largest: bool = True):
    """Per-column top-k of |w| over a stack (..., d_in, d_out) -> (..., k,
    d_out) int32, by descending |w| with ties to the lower row (ascending
    for ``largest=False``): one launch for the whole stack, w read in its
    own dtype."""
    lead, (d_in, d_out) = w.shape[:-2], w.shape[-2:]
    idx = _topk_select(w.reshape(-1, d_in, d_out).contiguous(), k, largest)
    return idx.reshape(*lead, k, d_out)

"""Building blocks of the dense decoder: norm, RoPE, the adapter-aware
linear, the paged cache writers and the training loss (port of the
matching functions in ``repro.models.layers``).

Sentinel writes. A block table marks unallocated pages, shared prefix
pages (in the write table), pads and idle slots with the out-of-range
block id ``num_blocks``; the reference drops such writes with
``mode="drop"``. Here the pool carries one extra *trash* block at index
``num_blocks`` (``(num_blocks + 1, page, KV, hd)``): a sentinel write
lands there, and attention never reads it — the attention callers pass
``pool[:num_blocks]``, and reads clamp into that range. The writers
update the pool in place (one pool per layer, no copy per step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.delta import Delta
from repro_torch.kernels import ops
from repro_torch.quant.qtensor import QuantizedTensor


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, then scale by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def alinear(p: dict, a, name: str, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ bypass) (+ b). ``p[name]`` is ``{"w": (d_in, d_out),
    ["b": (d_out,)]}``; ``a`` maps projection names to a
    :class:`~repro_torch.core.delta.BatchedDelta` (serving: every row's
    tenant), to a :class:`~repro_torch.core.delta.Delta` — or an adapter
    leaf ``{"w": Delta, ...}`` beside the bias slot — (training: the fused
    kernel, W frozen), or is ``None``.

    W may be a :class:`~repro_torch.quant.QuantizedTensor` (an int8 or NF4
    frozen base): the matmul then runs the fused dequant kernel
    (``ops.fused_linear_q`` with a Delta, ``ops.matmul_q`` otherwise) and
    the dense weight never exists."""
    leaf = p[name]
    w, b = leaf["w"], leaf.get("b")
    d = a.get(name) if a else None
    if isinstance(d, dict):
        d = d.get("w")
    if isinstance(d, Delta):
        if isinstance(w, QuantizedTensor):
            return ops.fused_linear_q(x, w, d.idx, d.val, b)
        # a Delta bypass implies the NeuroAda contract: W is frozen
        return ops.fused_linear(x, w, d.idx, d.val, b, w_frozen=True)
    y = ops.matmul_q(x, w)
    if d is not None:
        y = y + ops.delta_apply_batched(x, d.idx, d.val, d.aid)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def silu_mlp(p: dict, a, x: torch.Tensor) -> torch.Tensor:
    return alinear(p, a, "wdown", F.silu(alinear(p, a, "wgate", x)) * alinear(p, a, "wup", x))


# ------------------------------------------------------------ paged writes


def decode_slots(table, pos, page: int):
    """Pool coordinates ``(blk, off)``, each (B, 1) int64, of each slot's
    write position ``pos`` (B,) through its table; sentinel entries name the
    trash block."""
    pg = (pos // page).clamp(max=table.shape[1] - 1).long()
    return torch.gather(table, 1, pg[:, None]).long(), (pos % page).long()[:, None]


def chunk_slots(table, q_offset, q_len, page: int, trash: int, c: int):
    """Pool coordinates ``(blk, off)``, each (B, C) int64, of chunk column
    ``i`` of slot ``b`` at position ``q_offset[b] + i`` through the *write*
    table; columns ``i >= q_len[b]`` (pads, idle slots) and sentinel pages
    (unallocated, or shared with another request) name the trash block."""
    i = torch.arange(c, device=table.device)[None, :]
    pos = q_offset[:, None] + i  # (B, C)
    pg = (pos // page).clamp(max=table.shape[1] - 1).long()
    blk = torch.where(i < q_len[:, None], torch.gather(table, 1, pg), trash).long()
    return blk, (pos % page).long()


def paged_write(cache: torch.Tensor, new: torch.Tensor, slots) -> None:
    """``cache[blk, off] = new`` in place; ``slots`` from :func:`decode_slots`
    or :func:`chunk_slots` (computed once per forward, shared by every layer
    and by k and v)."""
    cache[slots] = new.to(cache.dtype)


def paged_cache_update(cache: torch.Tensor, new: torch.Tensor, table, pos) -> None:
    """Write ``new`` (B, 1, KV, hd) into the pool ``cache`` (num_blocks + 1,
    P, KV, hd) at each slot's position ``pos`` (B,), through its block
    table (B, n_pages). Sentinel entries land in the trash block."""
    paged_write(cache, new, decode_slots(table, pos, cache.shape[1]))


def paged_chunk_cache_update(cache: torch.Tensor, new: torch.Tensor, table,
                             q_offset, q_len) -> None:
    """Write a per-slot chunk ``new`` (B, C, KV, hd) through each slot's
    *write* table (see :func:`chunk_slots`)."""
    slots = chunk_slots(table, q_offset, q_len, cache.shape[1], cache.shape[0] - 1,
                        new.shape[1])
    paged_write(cache, new, slots)


# --------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, inv_freq: torch.Tensor):
    """(cos, sin) of shape (B, S, 1, hd/2) for positions (B, S) — computed
    once per forward and shared by every layer."""
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate halves (not interleaved pairs) of x (B, S, H, hd) in float32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """(B, 1) rope positions from per-slot positions (B,)."""
    return pos[:, None]


# --------------------------------------------------------------------- loss


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None,
                          real_vocab: int | None = None) -> torch.Tensor:
    """Mean negative log-likelihood in float32. Columns ``>= real_vocab``
    (vocab padding) are masked out of the normaliser; with ``mask`` the
    mean runs over its weights (at least 1)."""
    lg = logits.float()
    v = lg.shape[-1]
    if real_vocab is not None and real_vocab < v:
        pad = torch.arange(v, device=lg.device) >= real_vocab
        lg = lg.masked_fill(pad, -1e30)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()

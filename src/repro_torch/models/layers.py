"""Building blocks of the dense decoder: norm, RoPE, the adapter-aware
linear, the KV cache writers and the training loss (port of the matching
functions in ``repro.models.layers``).

Sentinel writes. A block table marks unallocated pages, shared prefix
pages (in the write table), pads and idle slots with the out-of-range
block id ``num_blocks``; the reference drops such writes with
``mode="drop"``. Here the pool carries one extra *trash* block at index
``num_blocks`` (``(num_blocks + 1, page, KV, hd)``): a sentinel write
lands there, and attention never reads it — the attention callers pass
``pool[:num_blocks]``, and reads clamp into that range. The dense slot
cache carries a trash *slot* the same way (``(slots + 1, Smax, KV, hd)``):
chunk pads and idle rows, which the reference drops, land in slot
``slots``. The scales of an int8 cache get the trash row as well. The
writers update the caches in place (one per layer, no copy per step).

int8 KV (DESIGN §15). A paged pool keeps one float32 absmax scale per
(block, kv-head), a dense cache one per (slot, 16-row group, kv-head). Every
write rebuilds each page or group it touches — dequantize, overlay the new
rows, zero the rows at and past the new frontier, requantize under a fresh
scale — in plain PyTorch, as the reference computes it in XLA outside any
kernel. The arithmetic is the reference's op for op (float32, a true
divide by 127 on a device tensor, round half to even), so codes and scales
are byte-identical for the same float input, and a replayed write sequence
gives the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.kernels import ops
from repro_torch.quant.qtensor import QuantizedTensor


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, then scale by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


LORA_KEYS = frozenset({"A", "B", "scale"})


def is_lora(leaf) -> bool:
    """A LoRA adapter leaf: ``{"A": (..., d_in, r), "B": (..., r, d_out),
    "scale": (...)}``."""
    return isinstance(leaf, dict) and set(leaf) == LORA_KEYS


def adapter_leaf(a, name: str):
    """The adapter of projection ``name`` in the adapter dict ``a``: a
    :class:`~repro_torch.core.delta.Delta`, a
    :class:`~repro_torch.core.delta.BatchedDelta`, a LoRA leaf (see
    :func:`is_lora`) or ``None``. An adapter nested beside the bias slot
    (``{"w": leaf, "b": None}``, the shape of a training adapter tree) is
    opened. Any other leaf raises: no adapter is dropped silently."""
    d = a.get(name) if a else None
    if isinstance(d, dict) and "w" in d:
        d = d["w"]
    if d is None or isinstance(d, (Delta, BatchedDelta)) or is_lora(d):
        return d
    raise TypeError(f"adapter leaf of {name!r} is neither a Delta, a BatchedDelta nor a LoRA "
                    f"{{'A', 'B', 'scale'}} dict: {type(d).__name__}")


def alinear(p: dict, a, name: str, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ bypass | LoRA) (+ b). ``p[name]`` is ``{"w": (d_in,
    d_out), ["b": (d_out,)]}``; ``a`` maps projection names to adapter
    leaves (:func:`adapter_leaf`):

    * a :class:`~repro_torch.core.delta.Delta` (NeuroAda training): the
      fused kernel, W frozen;
    * a :class:`~repro_torch.core.delta.BatchedDelta` (serving: every row's
      tenant): the base matmul, then the bypass and the bias in the bypass
      kernel's epilogue;
    * a LoRA leaf: ``x @ W + (x @ A @ B) · scale`` with ``scale`` a
      constant (no gradient), then the bias, as the reference;
    * ``None``: the base matmul and the bias.

    W may be a :class:`~repro_torch.quant.QuantizedTensor` (an int8 or NF4
    frozen base): the matmul then runs the fused dequant kernel
    (``ops.fused_linear_q`` with a Delta, ``ops.matmul_q`` otherwise — at
    zero bypass, differentiable in x: QLoRA's base product) and the dense
    weight never exists."""
    leaf = p[name]
    w, b = leaf["w"], leaf.get("b")
    d = adapter_leaf(a, name)
    if isinstance(d, Delta):
        if isinstance(w, QuantizedTensor):
            return ops.fused_linear_q(x, w, d.idx, d.val, b)
        # a Delta bypass implies the NeuroAda contract: W is frozen
        return ops.fused_linear(x, w, d.idx, d.val, b, w_frozen=True)
    y = ops.matmul_q(x, w)
    if isinstance(d, BatchedDelta):  # the bypass and the bias in the kernel's epilogue, into y
        return ops.delta_apply_batched(x, d.idx, d.val, d.aid, y, b)
    if d is not None:  # LoRA
        y = y + (x @ d["A"]) @ d["B"] * d["scale"].detach()
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class Filler:
    """Random and constant tensors for a model's init on one device: normal
    draws from one ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions, not its bits: parity tests convert the reference's
    params), zeros and ones."""

    def __init__(self, seed: int, device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, device=self.device) * scale).to(dtype)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def linear(self, d_in: int, d_out: int, dtype, bias: bool = False, stack=()) -> dict:
        """``{"w": normal · d_in^-0.5 (*stack, d_in, d_out)[, "b": zeros]}``."""
        out = {"w": self.normal((*stack, d_in, d_out), d_in**-0.5, dtype)}
        if bias:
            out["b"] = self.zeros((*stack, d_out), dtype)
        return out


def index_tree(node, i: int):
    """``node[i]`` leaf by leaf over a nested dict of stacked leaves: one
    layer's (or group's) view of a stack. A packed leaf
    (:class:`~repro_torch.quant.QuantizedTensor`) slices its codes and
    scales on the same axis."""
    if isinstance(node, dict):
        return {k: index_tree(v, i) for k, v in node.items()}
    return None if node is None else node[i]


def adapter_slice(a, i: int) -> dict:
    """Stack index ``i`` of a training adapter dict ``{name: leaf}``:
    ``Delta(idx[i], val[i])`` or a LoRA leaf's ``A``, ``B`` and ``scale``
    each at ``i`` (slicing keeps the autograd link to the stacked
    trainables). A tenant stack has no place in training and raises, as any
    leaf :func:`adapter_leaf` does not know."""
    out = {}
    for name in a or {}:
        d = adapter_leaf(a, name)
        if d is None:
            continue
        if isinstance(d, BatchedDelta):
            raise TypeError(f"training adapters hold a tenant stack at {name!r}")
        out[name] = (Delta(d.idx[i], d.val[i]) if isinstance(d, Delta)
                     else {key: t[i] for key, t in d.items()})
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, the reference's
    ``jax.nn.softplus`` (no linear cut-off above a threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def silu_mlp(p: dict, a, x: torch.Tensor) -> torch.Tensor:
    return alinear(p, a, "wdown", F.silu(alinear(p, a, "wgate", x)) * alinear(p, a, "wup", x))


# ------------------------------------------------------------ cache writes


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


def dense_chunk_slots(q_offset, q_len, smax: int, trash: int, c: int):
    """Dense cache coordinates ``(slot, row)``, each (B, C) int64, of chunk
    column ``i`` of slot ``b`` at row ``q_offset[b] + i``; columns ``i >=
    q_len[b]`` and rows past the cache (dropped by the reference) name row 0
    of the trash slot."""
    b = q_offset.shape[0]
    i = torch.arange(c, device=q_offset.device)[None, :]
    pos = q_offset[:, None] + i  # (B, C)
    ok = (i < q_len[:, None]) & (pos < smax)
    slot = torch.where(ok, torch.arange(b, device=pos.device)[:, None], trash)
    return slot.long(), torch.where(ok, pos, 0).long()


def scatter_write(cache: torch.Tensor, new: torch.Tensor, slots) -> None:
    """``cache[slots] = new`` in place; ``slots`` from one of the ``*_slots``
    functions above (computed once per forward, shared by every layer and by
    k and v)."""
    cache[slots] = new.to(cache.dtype)


def paged_cache_update(cache: torch.Tensor, new: torch.Tensor, table, pos) -> None:
    """Write ``new`` (B, 1, KV, hd) into the pool ``cache`` (num_blocks + 1,
    P, KV, hd) at each slot's position ``pos`` (B,), through its block
    table (B, n_pages). Sentinel entries land in the trash block."""
    slots = chunk_slots(table, pos, torch.ones_like(pos), cache.shape[1], cache.shape[0] - 1, 1)
    scatter_write(cache, new, slots)


def paged_chunk_cache_update(cache: torch.Tensor, new: torch.Tensor, table,
                             q_offset, q_len) -> None:
    """Write a per-slot chunk ``new`` (B, C, KV, hd) through each slot's
    *write* table (see :func:`chunk_slots`)."""
    slots = chunk_slots(table, q_offset, q_len, cache.shape[1], cache.shape[0] - 1,
                        new.shape[1])
    scatter_write(cache, new, slots)


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, 1, KV, hd) into the dense cache ``cache`` (B + 1,
    Smax, KV, hd) at each slot's row ``pos`` (B,)."""
    slots = dense_chunk_slots(pos, torch.ones_like(pos), cache.shape[1], cache.shape[0] - 1, 1)
    scatter_write(cache, new, slots)


def chunk_cache_update(cache: torch.Tensor, new: torch.Tensor, q_offset, q_len) -> None:
    """Write a per-slot chunk ``new`` (B, C, KV, hd) into the dense cache at
    rows ``q_offset[b] .. q_offset[b] + q_len[b] - 1`` (see
    :func:`dense_chunk_slots`)."""
    slots = dense_chunk_slots(q_offset, q_len, cache.shape[1], cache.shape[0] - 1,
                              new.shape[1])
    scatter_write(cache, new, slots)


# ----------------------------------------------------- int8 KV (DESIGN §15)

# rows per dense-cache scale group (the dense twin of a paged pool's page)
KV_QUANT_GROUP = 16


def quant_kv_page(page: torch.Tensor):
    """Symmetric absmax int8 over a ``(…, rows, KV, hd)`` page view: one
    scale per kv-head, ``s = absmax / 127`` over rows × head dim (a true
    divide), codes ``round(x / s)`` (half to even) clipped to ±127, an
    all-zero page with scale 0 and codes 0. Returns ``(codes int8 (…, rows,
    KV, hd), scales float32 (…, KV))``."""
    page = page.float()
    absmax = page.abs().amax(dim=(-3, -1))
    # a divide by a host scalar becomes a multiply by its reciprocal on the
    # card, which can differ in the last bit from the reference's divide
    s = absmax / torch.full((), 127.0, device=page.device)
    safe = torch.where(s > 0, s, 1.0)[..., None, :, None]
    codes = torch.round(page / safe).clamp(-127, 127)
    return codes.to(torch.int8), s


def dequant_kv_page(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_kv_page`: ``(…, rows, KV, hd)`` float32."""
    return codes.float() * scales.float()[..., None, :, None]


class QuantWrite(NamedTuple):
    """Where one quantize-on-write lands; computed once per forward and
    shared by every layer and by k and v. ``read`` indexes the pages (or
    groups) to rebuild, ``write`` where they go back (the trash block or slot
    for those the write does not cover); ``ci`` (B, T·rows) is the chunk
    column each of their rows would take, ``put``/``keep`` (B, T, rows, 1,
    1) whether it takes it or keeps its value (neither: zeroed)."""
    read: tuple
    write: tuple
    ci: torch.Tensor
    put: torch.Tensor
    keep: torch.Tensor


def _overlay(lp, q_offset, q_len, c: int):
    """(ci, put, keep) of rows at logical positions ``lp`` (B, T, rows) for a
    chunk of ``c`` columns at ``q_offset`` (B,) with ``q_len`` (B,) real
    ones: rows in ``[q_offset, q_offset + q_len)`` take the chunk, rows
    below keep their values, rows at or past the new frontier are zeroed.
    They hold a prior owner's rows and must stay out of the recomputed
    absmax: that makes the content a pure function of the committed write
    sequence (a preempted request re-prefills to the same bits)."""
    b = lp.shape[0]
    qo = q_offset.reshape(b, 1, 1)
    end = (q_offset + q_len).reshape(b, 1, 1)
    ci = (lp - qo).clamp(0, c - 1).reshape(b, -1).long()
    return ci, ((lp >= qo) & (lp < end))[..., None, None], (lp < qo)[..., None, None]


def paged_quant_write(table, q_offset, q_len, n: int, page: int, c: int) -> QuantWrite:
    """The pages a chunk of ``c`` columns (``c = 1``: a decode token at
    ``q_offset``) touches through each slot's table (the *write* table for a
    chunk): ``T = (c - 1) // page + 2`` logical pages per slot from the one
    holding ``q_offset``; pages past ``q_offset + q_len`` or the table, idle
    slots and sentinel entries write into the trash block ``n``."""
    n_pages, dev = table.shape[1], table.device
    t = (c - 1) // page + 2 if c > 1 else 1
    tpg = (q_offset // page)[:, None] + torch.arange(t, device=dev)[None, :]  # (B, T)
    blk = torch.gather(table, 1, tpg.clamp(max=n_pages - 1).long()).long()
    covered = (q_len > 0)[:, None] & (tpg * page < (q_offset + q_len)[:, None]) \
        & (tpg < n_pages)
    lp = tpg[:, :, None] * page + torch.arange(page, device=dev)
    return QuantWrite((blk.clamp(max=n - 1),), (torch.where(covered, blk.clamp(max=n), n),),
                      *_overlay(lp, q_offset, q_len, c))


def dense_quant_write(q_offset, q_len, slots: int, groups: int, group: int,
                      c: int) -> QuantWrite:
    """The groups a chunk of ``c`` columns (``c = 1``: a decode token)
    touches in each slot's rows of a dense cache; groups past ``q_offset +
    q_len`` or the cache and idle slots write into the trash slot
    ``slots``."""
    dev = q_offset.device
    t = (c - 1) // group + 2 if c > 1 else 1
    tg = (q_offset // group)[:, None] + torch.arange(t, device=dev)[None, :]  # (B, T)
    covered = (q_len > 0)[:, None] & (tg * group < (q_offset + q_len)[:, None]) \
        & (tg < groups)
    bi = torch.arange(q_offset.shape[0], device=dev)[:, None]
    tg_safe = tg.clamp(max=groups - 1).long()
    lp = tg[:, :, None] * group + torch.arange(group, device=dev)
    return QuantWrite((bi, tg_safe),
                      (torch.where(covered, bi, slots), torch.where(covered, tg_safe, 0)),
                      *_overlay(lp, q_offset, q_len, c))


def _rebuild_pages(cur, new, w: QuantWrite):
    """The overlay step of every quantize-on-write: the dequantized
    current content ``cur`` (B, T, rows, KV, hd) with the chunk ``new``
    (B, C, KV, hd) laid over it and the rows past the frontier zeroed."""
    b = new.shape[0]
    ov = new.float()[torch.arange(b, device=new.device)[:, None], w.ci].reshape(cur.shape)
    return torch.where(w.put, ov, torch.where(w.keep, cur, 0.0))


def quant_write(data, scale, new, w: QuantWrite) -> None:
    """Rebuild, in place, every page or group ``w`` names: dequantize,
    overlay ``new``, zero past the frontier, requantize under a fresh scale.
    ``data``/``scale`` are a paged pool (N + 1, P, KV, hd) / (N + 1, KV) or a
    dense cache (slots + 1, S, KV, hd) / (slots + 1, S // group, KV)."""
    if scale.ndim == 3:  # dense: one leading index per (slot, group)
        data = data.view(*scale.shape[:2], -1, *data.shape[2:])
    cur = dequant_kv_page(data[w.read], scale[w.read])
    codes, s = quant_kv_page(_rebuild_pages(cur, new, w))
    data[w.write] = codes
    scale[w.write] = s


def paged_cache_update_q(data, scale, new, table, pos) -> None:
    """Quantized twin of :func:`paged_cache_update`: rebuild the page holding
    ``pos`` (B,) per slot through its table. data (num_blocks + 1, P, KV, hd)
    int8, scale (num_blocks + 1, KV) float32, new (B, 1, KV, hd); sentinel
    entries write into the trash block."""
    w = paged_quant_write(table, pos, torch.ones_like(pos), data.shape[0] - 1, data.shape[1], 1)
    quant_write(data, scale, new, w)


def paged_chunk_cache_update_q(data, scale, new, table, q_offset, q_len) -> None:
    """Quantized twin of :func:`paged_chunk_cache_update`: every page the
    chunk touches through the slot's *write* table is rebuilt whole."""
    w = paged_quant_write(table, q_offset, q_len, data.shape[0] - 1, data.shape[1],
                          new.shape[1])
    quant_write(data, scale, new, w)


def cache_update_q(data, scale, new, pos) -> None:
    """Quantized twin of :func:`cache_update`: rebuild the group holding
    ``pos`` (B,) per slot. data (B + 1, S, KV, hd) int8 with S whole groups
    of :data:`KV_QUANT_GROUP`, scale (B + 1, S // group, KV) float32."""
    slots, groups = scale.shape[0] - 1, scale.shape[1]
    w = dense_quant_write(pos, torch.ones_like(pos), slots, groups,
                          data.shape[1] // groups, 1)
    quant_write(data, scale, new, w)


def chunk_cache_update_q(data, scale, new, q_offset, q_len) -> None:
    """Quantized twin of :func:`chunk_cache_update`: every group the chunk
    touches is rebuilt under a recomputed scale."""
    slots, groups = scale.shape[0] - 1, scale.shape[1]
    w = dense_quant_write(q_offset, q_len, slots, groups, data.shape[1] // groups,
                          new.shape[1])
    quant_write(data, scale, new, w)


# --------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, inv_freq: torch.Tensor):
    """(cos, sin) of shape (B, S, 1, hd/2) for positions (B, S) — computed
    once per forward and shared by every layer."""
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def mrope_angles(positions3: torch.Tensor, inv_freq: torch.Tensor, sections):
    """Qwen2-VL multimodal RoPE: (cos, sin) of shape (B, S, 1, hd/2) for
    (t, h, w) positions ``positions3`` (3, B, S). The frequency pairs split
    into ``sections`` (summing to hd/2), in order; each pair turns by the
    position stream its section names. :func:`apply_rope` applies them."""
    if sum(sections) != inv_freq.shape[0]:
        raise ValueError(f"mrope sections {tuple(sections)} do not cover "
                         f"{inv_freq.shape[0]} frequency pairs")
    sec = torch.repeat_interleave(torch.arange(3, device=positions3.device),
                                  torch.tensor(sections, device=positions3.device))
    pos = positions3[sec].permute(1, 2, 0)  # (B, S, hd/2): each pair's own stream
    ang = pos.float() * inv_freq
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


def next_token_loss(logits: torch.Tensor, batch: dict, vocab_size: int) -> torch.Tensor:
    """The language-model loss: position t predicts ``batch["targets"]`` at t
    + 1, weighted by ``batch["loss_mask"]`` when given, vocab padding
    masked."""
    return softmax_cross_entropy(logits[:, :-1], batch["targets"][:, 1:], batch.get("loss_mask"),
                                 real_vocab=vocab_size)

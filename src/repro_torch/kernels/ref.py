"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in ``repro.kernels.ref``).

They follow the hand-written kernels' rounding — float32 products, sums
and softmax, one cast to the input dtype at the end — which is also what
the Pallas kernels do. (The reference's jnp delta oracle instead sums in
x's dtype; in float32 the two agree.) The kernel modules wrap these as
their ``*_plain`` functions, which count calls; the CPU path of every
wrapper lands here.
"""

from __future__ import annotations

import weakref

import torch

from repro_torch.quant.qtensor import dequantize_f32


def sparse_delta_batched_ref(x, idx, val, aid):
    """y[m, o] = Σ_j val[aid[m], j, o] · x[m, idx[aid[m], j, o]].

    x (M, d_in); idx/val (N, k, d_out) adapter stacks; aid (M,) int.
    """
    a = aid.long()
    idx_m = idx[a].long()  # (M, k, d_out)
    xg = torch.gather(x.unsqueeze(1).expand(-1, idx.shape[1], -1), 2, idx_m)
    return (xg.float() * val[a].float()).sum(dim=1).to(x.dtype)


def _gather_batched(x, idx):
    """x (B, M, d_in) at idx (B, k, d_out) -> (B, M, k, d_out): row m of
    batch b read at batch b's indices."""
    b, m, _ = x.shape
    k, d_out = idx.shape[1:]
    ind = idx.long().reshape(b, 1, k * d_out).expand(b, m, k * d_out)
    return torch.gather(x, 2, ind).reshape(b, m, k, d_out)


def sparse_delta_ref(x, idx, val):
    """y[b, m, o] = Σ_j val[b, j, o] · x[b, m, idx[b, j, o]]: x (B, M, d_in),
    idx/val (B, k, d_out) -> (B, M, d_out) in x's dtype, float32 products
    and sums."""
    xg = _gather_batched(x, idx)
    return (xg.float() * val.float()[:, None]).sum(dim=2).to(x.dtype)


def sparse_delta_f32(x, idx, val):
    """Σ_j val[j, o] · x[m, idx[j, o]] in float32: x (M, d_in), idx/val
    (k, d_out) -> (M, d_out) float32."""
    xg = x[:, idx.long()]  # (M, k, d_out)
    return (xg.float() * val.float()).sum(dim=1)


def fused_linear_ref(x, w, idx, val, bias=None):
    """y = x @ W + bypass (+ bias): float32 product, bypass and bias, one
    cast to x's dtype (the Pallas kernel's accumulator and flush)."""
    acc = x.float() @ w.float() + sparse_delta_f32(x, idx, val)
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def fused_linear_q_ref(x, data, scales, idx=None, val=None, bias=None, *, qdtype: str,
                       block: int):
    """y = x @ dequant(data, scales) + bypass (+ bias): the packed codes
    dequantized to float32 (code × scale), cast to x's dtype, then the
    float32 product, the bypass (none when ``idx`` is None) and the bias,
    one cast to x's dtype — the reference's jnp path (``ops.fused_linear_q``)
    with the kernel's float32 accumulator."""
    w = dequantize_f32(data, scales, qdtype, block).to(x.dtype)
    acc = x.float() @ w.float()
    if idx is not None:
        acc = acc + sparse_delta_f32(x, idx, val)
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def sparse_delta_dval_ref(x, idx, dy):
    """dval[j, o] = Σ_m dy[m, o] · x[m, idx[j, o]] in float32 -> (k, d_out);
    with a leading batch axis, x (B, M, d_in), idx (B, k, d_out), dy (B, M,
    d_out) -> (B, k, d_out), each batch on its own."""
    if x.ndim == 3:
        return torch.einsum("bmko,bmo->bko", _gather_batched(x, idx).float(), dy.float())
    xg = x[:, idx.long()].float()  # (M, k, d_out)
    return torch.einsum("mko,mo->ko", xg, dy.float())


_DX_PLANS: dict = {}


def _dx_plan(idx, d_in: int):
    """(rows, order, offsets) of the sparse dx for ``idx`` (B, k, d_out):
    ``order`` sorts the terms p = (b, j, o) stably by their column b·d_in +
    idx, ``rows`` is the dy row b·d_out + o of each sorted term, and
    ``offsets`` bounds each of the B·d_in columns' runs.

    idx is frozen through training, so a plan is made once and kept while
    the tensor lives. Training passes a new view of the stacked (L, ...)
    leaf each step, so plans are kept by the view's base and its place in
    it, and made anew after an in-place change (the version the views
    share)."""
    base = idx if idx._base is None else idx._base
    entry = _DX_PLANS.get(id(base))
    if entry is None or entry[0]() is not base:
        i = id(base)
        entry = _DX_PLANS[i] = (weakref.ref(base, lambda _: _DX_PLANS.pop(i, None)), {})
    key = (idx.storage_offset(), tuple(idx.shape), idx.stride(), d_in)
    hit = entry[1].get(key)
    if hit is not None and hit[0] == idx._version:
        return hit[1]
    idx3 = idx if idx.ndim == 3 else idx[None]
    b, k, d_out = idx3.shape
    dev = idx.device
    col = (idx3.long() + torch.arange(b, device=dev).view(b, 1, 1) * d_in).reshape(-1)
    order = torch.argsort(col, stable=True)
    rows = order // (k * d_out) * d_out + order % d_out
    offsets = torch.searchsorted(col[order], torch.arange(b * d_in + 1, device=dev))
    entry[1][key] = (idx._version, (rows, order, offsets))
    return rows, order, offsets


def sparse_delta_dx_ref(idx, val, dy, d_in: int):
    """dx[m, i] = Σ_{(j, o): idx[j, o] = i} dy[m, o] · val[j, o] in float32
    -> (M, d_in). With a leading batch axis (idx/val (B, k, d_out), dy (B,
    M, d_out)) each batch sums into its own (M, d_in) rows.

    Deterministic on every device: the terms, sorted by column once for an
    ``idx`` (``_dx_plan``), are summed column by column in (j, o) order by
    a segment sum, the order of a sequential ``index_add_``. A CUDA
    ``index_add_`` / ``scatter_add_`` adds them by float atomics in no fixed
    order, so two backwards of one step could differ in their last bits.
    The result is a transposed view of a (d_in, M) tensor."""
    rows, order, offsets = _dx_plan(idx, d_in)
    batched = dy.ndim == 3
    b, m, d_out = dy.shape if batched else (1, *dy.shape)
    dy_t = dy.transpose(-1, -2).reshape(b * d_out, m)
    upd = dy_t.index_select(0, rows) * val.reshape(-1).index_select(0, order).float()[:, None]
    dx_t = torch.segment_reduce(upd, "sum", offsets=offsets, axis=0, unsafe=True)
    return dx_t.view(b, d_in, m).transpose(1, 2) if batched else dx_t.t()


def gather_paged_kv(pool, table):
    """(N, P, Hkv, hd) pool through a (B, n_pages) table -> contiguous
    (B, n_pages·P, Hkv, hd) view. Out-of-range (sentinel) entries clamp
    into the pool; their rows lie past every frontier and are masked."""
    b, n_pages = table.shape
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    return pool[tbl].reshape(b, n_pages * pool.shape[1], *pool.shape[2:])


def dequant_dense_kv(data, scale):
    """Dense int8 slot cache (B, S, KV, hd) with (B, S // group, KV) scales
    -> float32 values ``code.float() * scale`` (``group`` from the shapes)."""
    sg = scale.float().repeat_interleave(data.shape[-3] // scale.shape[-2], dim=-2)
    return data.float() * sg[..., None]


def gather_paged_kv_q(pool, scale, table):
    """int8 twin of :func:`gather_paged_kv`: pages and their (N, KV)
    per-(block, kv-head) scales through the table, dequantized to a float32
    (B, n_pages·P, KV, hd) view; sentinel entries clamp into the pool."""
    b, n_pages = table.shape
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    pages = pool[tbl].float() * scale[tbl].float()[:, :, None, :, None]
    return pages.reshape(b, n_pages * pool.shape[1], *pool.shape[2:])


def _masked_softmax(s, mask):
    s = s.masked_fill(~mask, -1e30)
    return torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)


def decode_attention_ref(q, k, v, kv_valid_len):
    """q (B, 1, H, hd) against a contiguous (B, S, Hkv, hd) cache; columns
    ``>= kv_valid_len[b]`` masked; fully masked rows give zeros."""
    b, _, h, hd = q.shape
    hkv = k.shape[2]
    k, v = k.float(), v.float()
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) * hd**-0.5
    col = torch.arange(k.shape[1], device=q.device)
    mask = (col[None, :] < kv_valid_len.to(q.device)[:, None])[:, None, None, :]
    p = _masked_softmax(s, mask)
    o = torch.einsum("bkgs,bskh->bkgh", p, v)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, table, kv_valid_len):
    """q (B, 1, H, hd) against the paged pool: gather, then
    :func:`decode_attention_ref`."""
    return decode_attention_ref(q, gather_paged_kv(k_pool, table),
                                gather_paged_kv(v_pool, table), kv_valid_len)


def prefill_attention_ref(q, k, v, q_offset, kv_valid_len):
    """q (B, C, H, hd) against a contiguous (B, S, Hkv, hd) cache. Query
    ``i`` sees column ``c`` iff ``c <= q_offset[b] + i`` and ``c <
    kv_valid_len[b]``; fully masked rows give zeros."""
    b, c, h, hd = q.shape
    hkv = k.shape[2]
    k, v = k.float(), v.float()
    qg = q.reshape(b, c, hkv, h // hkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * hd**-0.5
    dev = q.device
    col = torch.arange(k.shape[1], device=dev)[None, None, :]
    qpos = q_offset.to(dev)[:, None, None] + torch.arange(c, device=dev)[None, :, None]
    mask = (col <= qpos) & (col < kv_valid_len.to(dev)[:, None, None])  # (B, C, S)
    p = _masked_softmax(s, mask[:, None, None])
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, c, h, hd).to(q.dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, table, q_offset, kv_valid_len):
    """Chunk q (B, C, H, hd) against the paged pool: gather, then
    :func:`prefill_attention_ref`."""
    return prefill_attention_ref(q, gather_paged_kv(k_pool, table),
                                 gather_paged_kv(v_pool, table), q_offset, kv_valid_len)


# int8 caches: codes dequantized in float32 (``code.float() * scale``, as the
# Pallas bodies do), never rounded to q's dtype before the softmax


def decode_attention_q_ref(q, k, v, k_scale, v_scale, kv_valid_len):
    """Dense int8 slot cache: dequantize, then :func:`decode_attention_ref`."""
    return decode_attention_ref(q, dequant_dense_kv(k, k_scale),
                                dequant_dense_kv(v, v_scale), kv_valid_len)


def paged_decode_attention_q_ref(q, k_pool, v_pool, k_scale, v_scale, table, kv_valid_len):
    """int8 pools: gather and dequantize, then :func:`decode_attention_ref`."""
    return decode_attention_ref(q, gather_paged_kv_q(k_pool, k_scale, table),
                                gather_paged_kv_q(v_pool, v_scale, table), kv_valid_len)


def paged_prefill_attention_q_ref(q, k_pool, v_pool, k_scale, v_scale, table, q_offset,
                                  kv_valid_len):
    """int8 pools: gather and dequantize, then :func:`prefill_attention_ref`."""
    return prefill_attention_ref(q, gather_paged_kv_q(k_pool, k_scale, table),
                                 gather_paged_kv_q(v_pool, v_scale, table), q_offset,
                                 kv_valid_len)


def flash_attention_fwd_ref(q, k, v, *, causal: bool):
    """q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd), query head h on kv head
    ``h // (H // Hkv)`` -> (out (B, Sq, H, hd) in q's dtype, lse (B, H, Sq)
    float32): the function of the reference's ``_flash_fwd_scan``, in float32
    — scores scaled by hd^-0.5, causal columns ``j > i`` masked to -1e30
    with their p set to 0, out = Σ_j p v / max(l, 1e-30), lse = m +
    log(max(l, 1e-30)). Dense scores, not a scan: the same sums in another
    order."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd**-0.5
    mask = None
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()) / den.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(den)).reshape(b, h, sq)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse


def topk_select_ref(w, k: int, largest: bool = True):
    """(..., d_in, d_out) -> (..., k, d_out) int32: per column the k rows of
    largest |w| in float32, by descending |w| with ties to the lower row (a
    stable sort: ``lax.top_k``'s order); with ``largest=False`` the k rows
    of smallest |w|, ascending, ties to the lower row (``lax.top_k(-|w|)``).
    One matrix at a time, so a stack never needs a stack-sized float32 copy
    or sort."""
    flat = w.reshape(-1, *w.shape[-2:])
    out = torch.empty((flat.shape[0], k, w.shape[-1]), dtype=torch.int32, device=w.device)
    for i in range(flat.shape[0]):
        order = torch.sort(flat[i].abs().float(), dim=0, descending=largest,
                           stable=True).indices
        out[i] = order[:k].to(torch.int32)
    return out.reshape(*w.shape[:-2], k, w.shape[-1])

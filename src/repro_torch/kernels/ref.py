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

import torch


def sparse_delta_batched_ref(x, idx, val, aid):
    """y[m, o] = Σ_j val[aid[m], j, o] · x[m, idx[aid[m], j, o]].

    x (M, d_in); idx/val (N, k, d_out) adapter stacks; aid (M,) int.
    """
    a = aid.long()
    idx_m = idx[a].long()  # (M, k, d_out)
    xg = torch.gather(x.unsqueeze(1).expand(-1, idx.shape[1], -1), 2, idx_m)
    return (xg.float() * val[a].float()).sum(dim=1).to(x.dtype)


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


def sparse_delta_dval_ref(x, idx, dy):
    """dval[j, o] = Σ_m dy[m, o] · x[m, idx[j, o]] in float32 -> (k, d_out)."""
    xg = x[:, idx.long()].float()  # (M, k, d_out)
    return torch.einsum("mko,mo->ko", xg, dy.float())


def sparse_delta_dx_ref(idx, val, dy, d_in: int):
    """dx[m, i] = Σ_{(j, o): idx[j, o] = i} dy[m, o] · val[j, o]: a float32
    scatter-add of the k·d_out terms of each row (``index_add_``)."""
    m = dy.shape[0]
    upd = (dy.float()[:, None, :] * val.float()[None]).reshape(m, -1)
    dx = torch.zeros((m, d_in), dtype=torch.float32, device=dy.device)
    return dx.index_add_(1, idx.reshape(-1).long(), upd)


def gather_paged_kv(pool, table):
    """(N, P, Hkv, hd) pool through a (B, n_pages) table -> contiguous
    (B, n_pages·P, Hkv, hd) view. Out-of-range (sentinel) entries clamp
    into the pool; their rows lie past every frontier and are masked."""
    b, n_pages = table.shape
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    return pool[tbl].reshape(b, n_pages * pool.shape[1], *pool.shape[2:])


def _masked_softmax(s, mask):
    s = s.masked_fill(~mask, -1e30)
    return torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)


def paged_decode_attention_ref(q, k_pool, v_pool, table, kv_valid_len):
    """q (B, 1, H, hd) against the paged pool; columns ``>= kv_valid_len[b]``
    masked; fully masked rows give zeros."""
    b, _, h, hd = q.shape
    hkv = k_pool.shape[2]
    k = gather_paged_kv(k_pool, table).float()
    v = gather_paged_kv(v_pool, table).float()
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) * hd**-0.5
    col = torch.arange(k.shape[1], device=q.device)
    mask = (col[None, :] < kv_valid_len.to(q.device)[:, None])[:, None, None, :]
    p = _masked_softmax(s, mask)
    o = torch.einsum("bkgs,bskh->bkgh", p, v)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, table, q_offset, kv_valid_len):
    """q (B, C, H, hd) against the paged pool. Query ``i`` sees column ``c``
    iff ``c <= q_offset[b] + i`` and ``c < kv_valid_len[b]``; fully masked
    rows give zeros."""
    b, c, h, hd = q.shape
    hkv = k_pool.shape[2]
    k = gather_paged_kv(k_pool, table).float()
    v = gather_paged_kv(v_pool, table).float()
    qg = q.reshape(b, c, hkv, h // hkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * hd**-0.5
    dev = q.device
    col = torch.arange(k.shape[1], device=dev)[None, None, :]
    qpos = q_offset.to(dev)[:, None, None] + torch.arange(c, device=dev)[None, :, None]
    mask = (col <= qpos) & (col < kv_valid_len.to(dev)[:, None, None])  # (B, C, S)
    p = _masked_softmax(s, mask[:, None, None])
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, c, h, hd).to(q.dtype)

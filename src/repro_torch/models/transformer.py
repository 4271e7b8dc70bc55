"""Dense decoder-only transformer: paged serving and training (port of the
dense path of ``repro.models.transformer``).

Params are a nested dict in the reference's layout and names: weights
``W (d_in, d_out)`` with ``y = x @ W``, per-layer leaves stacked along a
leading layer axis ``(L, ...)``. A JAX param tree therefore converts leaf by
leaf (:mod:`repro_torch.convert`), and a NeuroAda ``(idx, val)`` adapter of
shape ``(k, d_out)`` means the same thing in both packages.

The layer stack is a Python loop over per-layer views (the reference's
``lax.scan``). The paged KV cache is ``{"k", "v"}`` pools of shape
``(L, num_blocks + 1, page, KV, hd)``, updated in place: the extra block
absorbs sentinel writes (see :mod:`repro_torch.models.layers`).

Serving adapters, when given, are ``{"blocks": {name: BatchedDelta}}``
with ``(L, N, k, d_out)`` stacks and a ``(B,)`` adapter id per slot, plus
an optional ``"head"`` ``BatchedDelta`` for an untied head. Training
adapters are the tree of :func:`repro_torch.core.adapt.zip_adapters`:
``Delta`` leaves of ``(L, k, d_out)`` beside each adapted ``w``, every
projection of every layer through the fused kernel with W frozen.
"""

from __future__ import annotations

import torch

from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.kernels import ops
from repro_torch.models.attention import (
    paged_attention,
    paged_prefill_attention,
    train_attention,
)
from repro_torch.models.layers import (
    alinear,
    apply_rope,
    chunk_slots,
    decode_positions,
    decode_slots,
    paged_write,
    rms_norm,
    rope_angles,
    rope_freqs,
    silu_mlp,
    softmax_cross_entropy,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ------------------------------------------------------------------ params


def init_params(cfg, *, seed: int, device) -> dict:
    """Random weights from ``seed``: the reference's distributions (normal
    scaled by ``d_in ** -0.5``, embedding × 0.02, zero biases, unit norms),
    drawn from a ``torch.Generator`` on ``device``."""
    dt = compute_dtype(cfg)
    L, D, Fd = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    def lin(d_in, d_out, bias=False, stack=(L,)):
        out = {"w": normal((*stack, d_in, d_out), d_in**-0.5)}
        if bias:
            out["b"] = torch.zeros((*stack, d_out), dtype=dt, device=device)
        return out

    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)  # noqa: E731
    blocks = {
        "attn_norm": ones(L, D),
        "wq": lin(D, H * hd, bias=cfg.qkv_bias),
        "wk": lin(D, KV * hd, bias=cfg.qkv_bias),
        "wv": lin(D, KV * hd, bias=cfg.qkv_bias),
        "wo": lin(H * hd, D),
        "mlp_norm": ones(L, D),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = ones(L, hd)
        blocks["k_norm"] = ones(L, hd)
    blocks["wgate"] = lin(D, Fd)
    blocks["wup"] = lin(D, Fd)
    blocks["wdown"] = lin(Fd, D)
    params = {
        "embed": {"w": normal((cfg.padded_vocab, D), 0.02)},
        "blocks": blocks,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["head"] = lin(D, cfg.padded_vocab, stack=())
    return params


def init_paged_cache(cfg, num_blocks: int, page_size: int, device) -> dict:
    """Zeroed ``(L, num_blocks + 1, page, KV, hd)`` k/v pools; block
    ``num_blocks`` is the trash block for sentinel writes."""
    shape = (cfg.num_layers, num_blocks + 1, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def layer_views(params) -> list[dict]:
    """Per-layer dicts of views into the stacked ``blocks`` leaves."""
    blocks = params["blocks"]
    n = blocks["attn_norm"].shape[0]

    def one(node, i):
        if isinstance(node, dict):
            return {k: one(v, i) for k, v in node.items()}
        return node[i]

    return [one(blocks, i) for i in range(n)]


def adapter_views(adapters) -> list[dict] | None:
    """Per-layer ``{name: (idx, val)}`` views into the ``(L, N, k, d_out)``
    tenant stacks; None without block adapters."""
    blocks = adapters.get("blocks") if adapters else None
    if not blocks:
        return None
    n = next(iter(blocks.values())).idx.shape[0]
    return [{name: (d.idx[i], d.val[i]) for name, d in blocks.items()} for i in range(n)]


def _bind_adapters(adapters, views, b: int, s: int) -> list[dict | None]:
    """Each layer's ``{name: BatchedDelta}``, the slots' adapter ids
    broadcast once to the (B, S) rows every projection sees."""
    views = adapter_views(adapters) if views is None else views
    if views is None:
        return None
    aid = next(iter(adapters["blocks"].values())).aid
    rows = aid[:, None].expand(b, s).contiguous()
    return [{name: BatchedDelta(idx, val, rows) for name, (idx, val) in layer.items()}
            for layer in views]


# ------------------------------------------------------------------- layers


def _qkv(cfg, p, a, x, cos, sin):
    b, s, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = alinear(p, a, "wq", x).view(b, s, H, hd)
    k = alinear(p, a, "wk", x).view(b, s, KV, hd)
    v = alinear(p, a, "wv", x).view(b, s, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _head_logits(cfg, params, adapters, h):
    """Tied: ``h @ embed.T``; untied: the head linear plus its tenant
    bypass, when the adapters carry one."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    logits = h @ params["head"]["w"]
    d = adapters.get("head") if adapters else None
    if d is not None:
        logits = logits + ops.delta_apply_batched(h, d.idx, d.val, d.aid)
    return logits


def _embed(cfg, params, tokens):
    return params["embed"]["w"][tokens.long()].to(compute_dtype(cfg))


# ------------------------------------------------------------------- serve


def prefill_chunk(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """Mixed prefill+decode chunk step against the paged pool.

    ``batch``: ``tokens`` (B, C), ``q_offset``/``q_len``/``last_idx`` (B,)
    int32, ``block_table``/``write_table`` (B, n_pages) int32. Each layer
    writes the chunk's k/v through the write table first (pads, idle slots
    and shared pages land in the trash block), then attends with the
    two-sided mask (intra-chunk causal from ``q_offset``, frontier
    ``q_offset + q_len``). Positions are ``q_offset + arange(C)`` for every
    column, pads included. Returns the (B, V) logits at ``last_idx``.
    ``layers``/``a_views`` are cached :func:`layer_views`/:func:`adapter_views`.
    """
    layers = layer_views(params) if layers is None else layers
    tokens, q_offset, q_len = batch["tokens"], batch["q_offset"], batch["q_len"]
    table, wtable = batch["block_table"], batch["write_table"]
    b, c = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = q_offset[:, None] + torch.arange(c, device=h.device)[None, :]
    cos, sin = rope_angles(positions, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                                 device=h.device))
    vl = q_offset + q_len
    nb = cache["k"].shape[1] - 1
    slots = chunk_slots(wtable, q_offset, q_len, cache["k"].shape[2], nb, c)
    bound = _bind_adapters(adapters, a_views, b, c)
    for i, p in enumerate(layers):
        a = bound[i] if bound else None
        ck, cv = cache["k"][i], cache["v"][i]
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        paged_write(ck, k, slots)
        paged_write(cv, v, slots)
        o = paged_prefill_attention(q, ck[:nb], cv[:nb], table,
                                    q_offset=q_offset, kv_valid_len=vl)
        h = h + alinear(p, a, "wo", o.reshape(b, c, -1))
        h = h + silu_mlp(p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    last = batch["last_idx"].long()[:, None, None].expand(-1, 1, h.shape[-1])
    hs = rms_norm(torch.gather(h, 1, last), params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, adapters, hs)[:, 0]


def decode_step(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """One new token per slot against the paged pool: ``batch`` holds
    ``token`` (B,), ``pos`` (B,) int32 (the write index) and
    ``block_table`` (B, n_pages), and optionally ``active`` (B,) bool. Each
    layer writes at ``pos`` and attends with ``kv_valid_len = pos + 1``, or
    0 where ``active`` is False: an idle slot reads no page (its output is
    zeros and discarded). Returns (B, V) logits."""
    layers = layer_views(params) if layers is None else layers
    pos, table = batch["pos"], batch["block_table"]
    h = _embed(cfg, params, batch["token"])[:, None]
    cos, sin = rope_angles(decode_positions(pos),
                           rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, device=h.device))
    vl = pos + 1
    if "active" in batch:
        vl = torch.where(batch["active"], vl, 0)
    nb = cache["k"].shape[1] - 1
    slots = decode_slots(table, pos, cache["k"].shape[2])
    bound = _bind_adapters(adapters, a_views, h.shape[0], 1)
    for i, p in enumerate(layers):
        a = bound[i] if bound else None
        ck, cv = cache["k"][i], cache["v"][i]
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        paged_write(ck, k, slots)
        paged_write(cv, v, slots)
        o = paged_attention(q, ck[:nb], cv[:nb], table, kv_valid_len=vl)
        h = h + alinear(p, a, "wo", o.reshape(h.shape[0], 1, -1))
        h = h + silu_mlp(p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, adapters, h)[:, 0]


# ------------------------------------------------------------------- train


def delta_views(adapters, n_layers: int) -> list[dict]:
    """Per-layer ``{name: Delta}`` views into the ``(L, k, d_out)`` leaves
    of a training adapter tree (slicing keeps the autograd link to the
    stacked values)."""
    out = [{} for _ in range(n_layers)]
    blocks = adapters.get("blocks") if adapters else None
    for name, leaf in (blocks or {}).items():
        d = leaf.get("w") if isinstance(leaf, dict) else leaf
        if d is None:
            continue
        for i in range(n_layers):
            out[i][name] = Delta(d.idx[i], d.val[i])
    return out


def _train_head(cfg, params, adapters, h):
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    d = adapters.get("head") if adapters else None
    if isinstance(d, dict):
        d = d.get("w")
    if d is not None:
        raise NotImplementedError(
            "a NeuroAda delta on an untied head needs the single-tenant bypass "
            "kernel (sparse_delta_pallas), which the port does not have yet "
            "(ROADMAP.md §2)")
    return h @ params["head"]["w"]


def forward_train(cfg, params, adapters, batch, layers=None):
    """Training forward over ``batch["tokens"]`` (B, S) at positions
    ``0..S-1`` (or ``batch["positions"]``): causal attention, every adapted
    projection through the fused kernel. Returns ((B, S, V) logits, the
    auxiliary loss — 0 for the dense family)."""
    layers = layer_views(params) if layers is None else layers
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    cos, sin = rope_angles(positions, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                                 device=h.device))
    deltas = delta_views(adapters, len(layers))
    for p, a in zip(layers, deltas):
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        o = train_attention(q, k, v, cfg)
        h = h + alinear(p, a, "wo", o.reshape(b, s, -1))
        h = h + silu_mlp(p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _train_head(cfg, params, adapters, h), aux / cfg.num_layers


def loss_fn(cfg, params, adapters, batch, layers=None):
    """Next-token cross-entropy in float32 (``batch["targets"]`` shifted by
    one, weighted by ``batch["loss_mask"]`` when given, vocab padding
    masked) plus ``router_aux_coef`` × the auxiliary loss. Returns
    (loss, {"ce", "aux"})."""
    logits, aux = forward_train(cfg, params, adapters, batch, layers)
    ce = softmax_cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                               batch.get("loss_mask"), real_vocab=cfg.vocab_size)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

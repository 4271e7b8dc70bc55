"""Decoder-only transformer, dense and MoE: paged and dense-cache serving
and training (port of the dense and MoE paths of
``repro.models.transformer``).

Params are a nested dict in the reference's layout and names: weights
``W (d_in, d_out)`` with ``y = x @ W``, per-layer leaves stacked along a
leading layer axis ``(L, ...)``. A JAX param tree therefore converts leaf by
leaf (:mod:`repro_torch.convert`), and a NeuroAda ``(idx, val)`` adapter of
shape ``(k, d_out)`` means the same thing in both packages.

The layer stack is a Python loop over per-layer views (the reference's
``lax.scan``). The paged KV cache is ``{"k", "v"}`` pools of shape
``(L, num_blocks + 1, page, KV, hd)``, the dense slot cache ``{"k", "v"}``
of shape ``(L, slots + 1, Smax, KV, hd)``, both updated in place: the extra
block or slot absorbs sentinel writes (see :mod:`repro_torch.models.layers`).
An int8 cache (``kv_dtype="int8"``) holds int8 codes under ``"k"``/``"v"``
and float32 scales under ``"k_scale"``/``"v_scale"``, per (block, kv-head)
or per (slot, 16-row group, kv-head), with the same extra row. A forward
without ``block_table`` in its batch runs on the dense cache.

Serving adapters, when given, are ``{"blocks": {name: BatchedDelta}}``
with ``(L, N, k, d_out)`` stacks and a ``(B,)`` adapter id per slot, plus
an optional ``"head"`` ``BatchedDelta`` for an untied head. Training
adapters are the tree of :func:`repro_torch.core.adapt.zip_adapters`:
``Delta`` leaves of ``(L, k, d_out)`` beside each adapted ``w``, every
projection of every layer through the fused kernel with W frozen.

The MoE family (``cfg.num_experts > 0``) replaces each layer's MLP with
:func:`repro_torch.models.moe.moe_ffn`: a router ``(L, D, E)`` and expert
stacks ``wgate``/``wup`` ``(L, E, D, F)`` and ``wdown`` ``(L, E, F, D)``,
whose adapters carry the expert axis too (``(L, E, k, F)`` training
deltas, ``(L, N, E, k, F)`` tenant stacks). An untied head is adaptable
like any linear: a training delta ``(k, V)`` goes through
``ops.delta_apply``, a tenant stack ``(N, k, V)`` through
``ops.delta_apply_batched``.
"""

from __future__ import annotations

import torch

from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    attention,
    chunk_attention,
    paged_attention,
    paged_prefill_attention,
    train_attention,
)
from repro_torch.models.layers import (
    KV_QUANT_GROUP,
    alinear,
    apply_rope,
    chunk_slots,
    decode_positions,
    dense_chunk_slots,
    dense_quant_write,
    paged_quant_write,
    quant_write,
    rms_norm,
    rope_angles,
    rope_freqs,
    scatter_write,
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
    if cfg.num_experts:
        E = cfg.num_experts
        blocks["router"] = {"w": normal((L, D, E), D**-0.5)}
        blocks["wgate"] = lin(D, Fd, stack=(L, E))
        blocks["wup"] = lin(D, Fd, stack=(L, E))
        blocks["wdown"] = lin(Fd, D, stack=(L, E))
    else:
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


def _zeros_kv(cfg, shape: tuple, scale_shape: tuple, device, kv_dtype: str) -> dict:
    """Zeroed k/v of ``shape`` in the compute dtype or, for ``kv_dtype="int8"``,
    int8 codes with float32 scales of ``scale_shape``."""
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device)}
    if kv_dtype != "fp32":
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    dt = compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_cache(cfg, num_blocks: int, page_size: int, device,
                     kv_dtype: str = "fp32") -> dict:
    """Zeroed ``(L, num_blocks + 1, page, KV, hd)`` k/v pools (int8 with
    ``(L, num_blocks + 1, KV)`` scales for ``kv_dtype="int8"``); block
    ``num_blocks`` is the trash block for sentinel writes."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return _zeros_kv(cfg, (L, num_blocks + 1, page_size, KV, hd), (L, num_blocks + 1, KV),
                     device, kv_dtype)


def init_cache(cfg, batch: int, max_len: int, device, kv_dtype: str = "fp32") -> dict:
    """Zeroed dense slot cache ``(L, batch + 1, max_len, KV, hd)``; slot
    ``batch`` is the trash slot. ``kv_dtype="int8"`` rounds the sequence
    axis up to whole groups of :data:`KV_QUANT_GROUP` rows, with ``(L,
    batch + 1, groups, KV)`` scales (attention masks the pad rows as it
    masks unwritten ones)."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    g = KV_QUANT_GROUP
    rows = -(-max_len // g) * g if kv_dtype == "int8" else max_len
    return _zeros_kv(cfg, (L, batch + 1, rows, KV, hd), (L, batch + 1, rows // g, KV),
                     device, kv_dtype)


def layer_views(params) -> list[dict]:
    """Per-layer dicts of views into the stacked ``blocks`` leaves. A packed
    leaf (:class:`~repro_torch.quant.QuantizedTensor`, not a tuple) slices
    its codes and scales on the layer axis with the same ``node[i]``."""
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


def _mlp(cfg, p, a, x, with_aux: bool = False):
    """The layer's MLP: (y, aux) — the MoE FFN and, for training
    (``with_aux``), its load-balancing loss; None for the SwiGLU MLP and for
    serving (no loss, and no launch to make one)."""
    if cfg.num_experts:
        return moe_lib.moe_ffn(cfg, p, a, x, with_aux=with_aux)
    return silu_mlp(p, a, x), None


def _head_logits(cfg, params, adapters, h):
    """Tied: ``h @ embed.T``; untied: the head linear plus its tenant
    bypass, when the adapters carry one."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    logits = ops.matmul_q(h, params["head"]["w"])
    d = adapters.get("head") if adapters else None
    if d is not None:
        logits = logits + ops.delta_apply_batched(h, d.idx, d.val, d.aid)
    return logits


def _embed(cfg, params, tokens):
    return params["embed"]["w"][tokens.long()].to(compute_dtype(cfg))


# ------------------------------------------------------------------- serve


def _layer_cache(cache, i: int) -> dict:
    """Layer ``i``'s views of every cache leaf (k, v and any scales)."""
    return {name: t[i] for name, t in cache.items()}


def _read(c: dict, n: int):
    """(k, v, k_scale, v_scale) of a layer's cache without the trash row:
    the first ``n`` blocks or slots; the scales are None for an fp cache."""
    ks, vs = c.get("k_scale"), c.get("v_scale")
    return (c["k"][:n], c["v"][:n], None if ks is None else ks[:n],
            None if vs is None else vs[:n])


def _write_plan(cache, table, q_offset, q_len, c: int):
    """Where this forward's k/v land, computed once for every layer and for
    k and v: the ``*_chunk_slots`` coordinates of an fp cache, or the
    :class:`~repro_torch.models.layers.QuantWrite` of an int8 one, for a
    chunk of ``c`` columns (a decode token is the chunk ``c = 1``, ``q_len =
    1``). ``table`` is the (write) block table of the paged pool, None for
    the dense cache."""
    k = cache["k"]
    n, rows = k.shape[1] - 1, k.shape[2]  # real blocks or slots; page or Smax
    if "k_scale" in cache:
        if table is not None:
            return paged_quant_write(table, q_offset, q_len, n, rows, c)
        groups = cache["k_scale"].shape[2]
        return dense_quant_write(q_offset, q_len, n, groups, rows // groups, c)
    if table is None:
        return dense_chunk_slots(q_offset, q_len, rows, n, c)
    return chunk_slots(table, q_offset, q_len, rows, n, c)


def _write(c: dict, k, v, plan) -> None:
    """Write k/v into one layer's cache at ``plan`` (:func:`_write_plan`)."""
    if "k_scale" in c:
        quant_write(c["k"], c["k_scale"], k, plan)
        quant_write(c["v"], c["v_scale"], v, plan)
    else:
        scatter_write(c["k"], k, plan)
        scatter_write(c["v"], v, plan)


def prefill_chunk(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """Mixed prefill+decode chunk step against the KV cache.

    ``batch``: ``tokens`` (B, C), ``q_offset``/``q_len``/``last_idx`` (B,)
    int32 and, for the paged pool, ``block_table``/``write_table`` (B,
    n_pages) int32; without them the cache is the dense slot cache. Each
    layer writes the chunk's k/v first (pads, idle slots and shared pages
    land in the trash block or slot), then attends with the two-sided mask
    (intra-chunk causal from ``q_offset``, frontier ``q_offset + q_len``).
    Positions are ``q_offset + arange(C)`` for every column, pads included.
    Returns the (B, V) logits at ``last_idx``. ``layers``/``a_views`` are
    cached :func:`layer_views`/:func:`adapter_views`.
    """
    layers = layer_views(params) if layers is None else layers
    tokens, q_offset, q_len = batch["tokens"], batch["q_offset"], batch["q_len"]
    table, wtable = batch.get("block_table"), batch.get("write_table")
    b, c = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = q_offset[:, None] + torch.arange(c, device=h.device)[None, :]
    cos, sin = rope_angles(positions, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                                 device=h.device))
    vl = q_offset + q_len
    n = cache["k"].shape[1] - 1  # real blocks (paged) or slots (dense)
    plan = _write_plan(cache, wtable, q_offset, q_len, c)
    bound = _bind_adapters(adapters, a_views, b, c)
    for i, p in enumerate(layers):
        a = bound[i] if bound else None
        lc = _layer_cache(cache, i)
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        _write(lc, k, v, plan)
        ck, cv, ks, vs = _read(lc, n)
        if table is None:
            o = chunk_attention(q, ck, cv, q_offset=q_offset, kv_valid_len=vl, k_scale=ks,
                                v_scale=vs)
        else:
            o = paged_prefill_attention(q, ck, cv, table, q_offset=q_offset, kv_valid_len=vl,
                                        k_scale=ks, v_scale=vs)
        h = h + alinear(p, a, "wo", o.reshape(b, c, -1))
        h = h + _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))[0]
    last = batch["last_idx"].long()[:, None, None].expand(-1, 1, h.shape[-1])
    hs = rms_norm(torch.gather(h, 1, last), params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, adapters, hs)[:, 0]


def decode_step(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """One new token per slot: ``batch`` holds ``token`` (B,), ``pos`` (B,)
    int32 (the write index), for the paged pool ``block_table`` (B, n_pages)
    (without it the cache is the dense slot cache), and optionally
    ``active`` (B,) bool. Each layer writes at ``pos`` and attends with
    ``kv_valid_len = pos + 1``, or 0 where ``active`` is False: an idle slot
    reads no cache row (its output is zeros and discarded). Returns (B, V)
    logits."""
    layers = layer_views(params) if layers is None else layers
    pos, table = batch["pos"], batch.get("block_table")
    h = _embed(cfg, params, batch["token"])[:, None]
    cos, sin = rope_angles(decode_positions(pos),
                           rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, device=h.device))
    vl = pos + 1
    if "active" in batch:
        vl = torch.where(batch["active"], vl, 0)
    n = cache["k"].shape[1] - 1
    plan = _write_plan(cache, table, pos, torch.ones_like(pos), 1)
    bound = _bind_adapters(adapters, a_views, h.shape[0], 1)
    for i, p in enumerate(layers):
        a = bound[i] if bound else None
        lc = _layer_cache(cache, i)
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        _write(lc, k, v, plan)
        ck, cv, ks, vs = _read(lc, n)
        if table is None:
            o = attention(q, ck, cv, kv_valid_len=vl, k_scale=ks, v_scale=vs)
        else:
            o = paged_attention(q, ck, cv, table, kv_valid_len=vl, k_scale=ks, v_scale=vs)
        h = h + alinear(p, a, "wo", o.reshape(h.shape[0], 1, -1))
        h = h + _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))[0]
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
    """Tied: ``h @ embed.T``; untied: the head matmul plus, when the
    adapters carry one, its NeuroAda delta through the single-tenant bypass
    kernel (differentiable in h and the values)."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    logits = ops.matmul_q(h, params["head"]["w"])
    d = adapters.get("head") if adapters else None
    if isinstance(d, dict):
        d = d.get("w")
    if d is not None:
        logits = logits + ops.delta_apply(h, d.idx, d.val)
    return logits


def forward_train(cfg, params, adapters, batch, layers=None):
    """Training forward over ``batch["tokens"]`` (B, S) at positions
    ``0..S-1`` (or ``batch["positions"]``): causal attention, every adapted
    projection through the fused kernel. Returns ((B, S, V) logits, the
    auxiliary loss: the MoE layers' load-balancing losses summed over the
    layers and divided by L, 0 for the dense family)."""
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
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, a in zip(layers, deltas):
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        o = train_attention(q, k, v, cfg)
        h = h + alinear(p, a, "wo", o.reshape(b, s, -1))
        y, aux_l = _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps), with_aux=True)
        h = h + y
        if aux_l is not None:
            aux = aux + aux_l
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
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

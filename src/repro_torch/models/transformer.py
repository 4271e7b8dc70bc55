"""Decoder-only transformer, dense, MoE and VLM: paged and dense-cache
serving, whole-prompt prefill and training (port of
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

The VLM family (qwen2-vl) is the dense decoder with Qwen2-VL's M-RoPE: a
training or prefill batch may carry ``patches`` (B, S_img, D), embedded
before the text, and (3, B, S_total) ``positions`` whose (t, h, w) streams
turn the frequency pairs of ``cfg.mrope_sections``; the loss then runs on
the text positions only. A decode step turns by M-RoPE when given
``mrope_pos`` (3, B, 1), by plain RoPE otherwise (the serving engine's
steps, and the chunked forwards, as in the reference).

Tensor-parallel serving: with a live serving group of tp > 1
(:mod:`repro_torch.distributed.context`, set by a sharded engine around
its steps) the serving forwards (:func:`prefill_chunk`,
:func:`verify_chunk`, :func:`ingest_chunk`, :func:`decode_step`) run on one
rank's local params and caches: ``H / tp`` q heads and ``KV / tp`` kv-heads,
column-parallel ``wq``/``wk``/``wv``/``wgate``/``wup``, row-parallel ``wo``
and ``wdown`` each followed by one all-reduce (a row-parallel bias added
once, after it), and a head on the rank's vocabulary slice (a tied head
reads its rows of the whole embedding) followed by one all-gather of the
logits. The embedding lookup stays replicated. An MLP whose ``d_ff`` or a
head whose vocabulary does not divide by tp is replicated, as the
reference's layout leaves it (:mod:`repro_torch.distributed.sharding`).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn, set_checkpoint_early_stop

from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.distributed import context as tp_ctx
from repro_torch.distributed.collectives import tp_all_gather, tp_all_reduce
from repro_torch.distributed.sharding import local_range
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
    Filler,
    adapter_leaf,
    adapter_slice,
    alinear,
    apply_rope,
    chunk_slots,
    decode_positions,
    dense_chunk_slots,
    dense_quant_write,
    index_tree,
    mrope_angles,
    next_token_loss,
    paged_quant_write,
    quant_write,
    rms_norm,
    rope_angles,
    rope_freqs,
    scatter_write,
    silu_mlp,
)
from repro_torch.tree import flatten

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
    fill = Filler(seed, device)

    def lin(d_in, d_out, bias=False, stack=(L,)):
        return fill.linear(d_in, d_out, dt, bias=bias, stack=stack)

    blocks = {
        "attn_norm": fill.ones((L, D), dt),
        "wq": lin(D, H * hd, bias=cfg.qkv_bias),
        "wk": lin(D, KV * hd, bias=cfg.qkv_bias),
        "wv": lin(D, KV * hd, bias=cfg.qkv_bias),
        "wo": lin(H * hd, D),
        "mlp_norm": fill.ones((L, D), dt),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = fill.ones((L, hd), dt)
        blocks["k_norm"] = fill.ones((L, hd), dt)
    if cfg.num_experts:
        E = cfg.num_experts
        blocks["router"] = {"w": fill.normal((L, D, E), D**-0.5, dt)}
        blocks["wgate"] = lin(D, Fd, stack=(L, E))
        blocks["wup"] = lin(D, Fd, stack=(L, E))
        blocks["wdown"] = lin(Fd, D, stack=(L, E))
    else:
        blocks["wgate"] = lin(D, Fd)
        blocks["wup"] = lin(D, Fd)
        blocks["wdown"] = lin(Fd, D)
    params = {
        "embed": {"w": fill.normal((cfg.padded_vocab, D), 0.02, dt)},
        "blocks": blocks,
        "final_norm": fill.ones((D,), dt),
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
                     kv_dtype: str = "fp32", tp: int = 1) -> dict:
    """Zeroed ``(L, num_blocks + 1, page, KV, hd)`` k/v pools (int8 with
    ``(L, num_blocks + 1, KV)`` scales for ``kv_dtype="int8"``); block
    ``num_blocks`` is the trash block for sentinel writes. With ``tp`` > 1,
    one rank's ``KV / tp`` kv-heads."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads // tp, cfg.resolved_head_dim
    return _zeros_kv(cfg, (L, num_blocks + 1, page_size, KV, hd), (L, num_blocks + 1, KV),
                     device, kv_dtype)


def init_cache(cfg, batch: int, max_len: int, device, kv_dtype: str = "fp32",
               tp: int = 1) -> dict:
    """Zeroed dense slot cache ``(L, batch + 1, max_len, KV, hd)``; slot
    ``batch`` is the trash slot. ``kv_dtype="int8"`` rounds the sequence
    axis up to whole groups of :data:`KV_QUANT_GROUP` rows, with ``(L,
    batch + 1, groups, KV)`` scales (attention masks the pad rows as it
    masks unwritten ones). With ``tp`` > 1, one rank's ``KV / tp``
    kv-heads."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads // tp, cfg.resolved_head_dim
    g = KV_QUANT_GROUP
    rows = -(-max_len // g) * g if kv_dtype == "int8" else max_len
    return _zeros_kv(cfg, (L, batch + 1, rows, KV, hd), (L, batch + 1, rows // g, KV),
                     device, kv_dtype)


def layer_views(params) -> list[dict]:
    """Per-layer dicts of views into the stacked ``blocks`` leaves. A packed
    leaf (:class:`~repro_torch.quant.QuantizedTensor`, not a tuple) slices
    its codes and scales on the layer axis with the same ``node[i]``."""
    blocks = params["blocks"]
    n = next(x for _, x in flatten(blocks) if x is not None).shape[0]
    return [index_tree(blocks, i) for i in range(n)]


def adapter_views(adapters) -> list[dict] | None:
    """Per-layer ``{name: (idx, val)}`` views into the ``(L, N, k, d_out)``
    tenant stacks; None without block adapters."""
    blocks = adapters.get("blocks") if adapters else None
    if not blocks:
        return None
    n = next(iter(blocks.values())).idx.shape[0]
    return [{name: (d.idx[i], d.val[i]) for name, d in blocks.items()} for i in range(n)]


def _bind_adapters(adapters, views, n_layers: int) -> list[dict | None]:
    """Each layer's adapters: ``{name: BatchedDelta}`` over the slots' (B,)
    adapter ids (the bypass kernel reads one id for a slot's S rows), or,
    for a training adapter tree (one adapter for every row, as the
    reference's decode takes it), its per-layer :func:`delta_views`."""
    blocks = adapters.get("blocks") if adapters else None
    if not blocks:
        return None
    if not isinstance(next(iter(blocks.values())), BatchedDelta):
        return delta_views(adapters, n_layers)
    views = adapter_views(adapters) if views is None else views
    aid = next(iter(blocks.values())).aid.to(torch.int32).contiguous()
    return [{name: BatchedDelta(idx, val, aid) for name, (idx, val) in layer.items()}
            for layer in views]


# ------------------------------------------------------------------- layers


def _qkv(cfg, p, a, x, cos, sin):
    """q, k, v (B, S, heads, hd) with RoPE: all of the heads, or one rank's
    under a tensor-parallel group (its columns of wq / wk / wv)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = alinear(p, a, "wq", x).view(b, s, -1, hd)
    k = alinear(p, a, "wk", x).view(b, s, -1, hd)
    v = alinear(p, a, "wv", x).view(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(cfg, p, a, x, with_aux: bool = False, reduce=None):
    """The layer's MLP: (y, aux) — the MoE FFN and, for training
    (``with_aux``), its load-balancing loss; None for the SwiGLU MLP and for
    serving (no loss, and no launch to make one). ``reduce`` sums a
    row-parallel ``wdown`` over the ranks (:func:`_reducers`)."""
    if cfg.num_experts:
        return moe_lib.moe_ffn(cfg, p, a, x, with_aux=with_aux)
    return silu_mlp(p, a, x, reduce), None


def _reducers(cfg):
    """(wo's, wdown's) all-reduce of one rank's partial sums under a live
    serving group of tp > 1, else (None, None). ``wdown`` is row-parallel
    only where ``d_ff`` divides by tp (else the MLP is replicated)."""
    group = tp_ctx.serve_group()
    if group is None or group.tp <= 1:
        return None, None
    reduce = functools.partial(tp_all_reduce, group=group)
    return reduce, (reduce if cfg.d_ff % group.tp == 0 else None)


def _head_logits(cfg, params, adapters, h):
    """Tied: ``h @ embed.T``; untied: the head linear plus its bypass, when
    the adapters carry one: a tenant stack in the kernel's epilogue, a
    training delta (one adapter for every row) through ``ops.delta_apply``.
    A LoRA leaf on the head is not applied, as in the reference. Under a
    serving group of tp > 1 whose size divides the vocabulary, each rank
    computes its vocabulary slice (its rows of the tied embedding, its
    columns of the untied head and of the head's stacks) and one
    all-gather rebuilds the whole row, identical on every rank."""
    group = tp_ctx.serve_group()
    split = group is not None and group.tp > 1 and cfg.padded_vocab % group.tp == 0
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        if split:
            lo, hi = local_range(w.shape[0], group.rank, group.tp)
            w = w[lo:hi]
        logits = h @ w.T
    else:
        logits = ops.matmul_q(h, params["head"]["w"], tp_col_sharded=split)
        d = adapter_leaf(adapters, "head")
        if isinstance(d, BatchedDelta):  # added into the logits in the kernel's epilogue
            ops.delta_apply_batched(h, d.idx, d.val, d.aid, logits)
        elif isinstance(d, Delta):
            logits = logits + ops.delta_apply(h, d.idx, d.val)
    return tp_all_gather(logits, group) if split else logits


def embed_tokens(cfg, params, tokens):
    return params["embed"]["w"][tokens.long()].to(compute_dtype(cfg))


def _angles(cfg, positions, mrope_pos, device):
    """RoPE (cos, sin) for a forward: M-RoPE from the (3, B, S) ``mrope_pos``
    when the config has sections and the batch brings them, else plain
    RoPE at ``positions`` (B, S) (the reference's ``_qkv`` dispatch)."""
    inv = rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, device=device)
    if cfg.mrope_sections and mrope_pos is not None:
        return mrope_angles(mrope_pos.to(device), inv, cfg.mrope_sections)
    return rope_angles(positions, inv)


def _embed_inputs(cfg, params, batch):
    """(h, cos, sin) of a whole-sequence forward (port of the reference's
    ``_embed_inputs``). A VLM batch with ``patches`` (B, S_img, D) puts them
    before the token embeddings and turns by M-RoPE at its (3, B, S_total)
    ``positions``; any other batch takes plain RoPE at ``batch["positions"]``
    (B, S) or ``0..S-1``."""
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm" and "patches" in batch:
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
        return (h, *_angles(cfg, None, batch["positions"], h.device))
    positions = batch.get("positions")
    if positions is None:
        b, s = tokens.shape
        positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    return (h, *_angles(cfg, positions, None, h.device))


# ------------------------------------------------------------------- serve


def prefill(cfg, params, adapters, batch, layers=None):
    """Whole-prompt forward (port of the reference's ``prefill``): (last-token
    (B, V) logits, a dense ``{"k", "v"}`` cache of the prompt's length in
    the slot cache's layout, ``(L, B + 1, S, KV, hd)`` with the zeroed trash
    slot). Pad its sequence axis to continue with :func:`decode_step` at
    ``pos = S``. ``batch`` holds ``tokens`` (B, S) (and a VLM's ``patches``
    and (3, B, S_total) ``positions``, as :func:`forward_train`), and
    optionally ``last_pos`` (B,): the final real token of a right-padded
    prompt, where the logits are gathered instead of at -1 (causal
    attention never lets a real position see a pad). Attention is the
    training forward's: dense below ``cfg.flash_threshold``, the flash
    kernel from it on. ``adapters`` is a training adapter tree or None."""
    layers = layer_views(params) if layers is None else layers
    h, cos, sin = _embed_inputs(cfg, params, batch)
    b, s, _ = h.shape
    ks, vs = [], []
    for p, a in zip(layers, delta_views(adapters, len(layers))):
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        o = train_attention(q, k, v, cfg)
        h = h + alinear(p, a, "wo", o.reshape(b, s, -1))
        h = h + _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))[0]
        ks.append(k)
        vs.append(v)
    last = batch.get("last_pos")
    if last is None:
        hs = h[:, -1:]
    else:
        hs = torch.gather(h, 1, last.long()[:, None, None].expand(-1, 1, h.shape[-1]))
    hs = rms_norm(hs, params["final_norm"], cfg.norm_eps)
    logits = _head_logits(cfg, params, adapters, hs)[:, 0]

    def with_trash(parts):
        kv = torch.stack(parts)
        return torch.cat([kv, kv.new_zeros((kv.shape[0], 1, *kv.shape[2:]))], dim=1)

    return logits, {"k": with_trash(ks), "v": with_trash(vs)}


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


def _chunk_forward(cfg, params, adapters, cache, batch, layers, a_views, hidden=True):
    """Shared body of :func:`prefill_chunk`, :func:`verify_chunk` and
    :func:`ingest_chunk`: a (B, C) token chunk through the layer stack
    against the KV cache. Returns the (B, C, D) hidden states, or None with
    ``hidden=False``: then the last layer stops after its k/v write, since
    nothing reads what follows."""
    layers = layer_views(params) if layers is None else layers
    tokens, q_offset, q_len = batch["tokens"], batch["q_offset"], batch["q_len"]
    table, wtable = batch.get("block_table"), batch.get("write_table")
    b, c = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    positions = q_offset[:, None] + torch.arange(c, device=h.device)[None, :]
    cos, sin = rope_angles(positions, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                                 device=h.device))
    vl = q_offset + q_len
    n = cache["k"].shape[1] - 1  # real blocks (paged) or slots (dense)
    plan = _write_plan(cache, wtable, q_offset, q_len, c)
    bound = _bind_adapters(adapters, a_views, len(layers))
    red_o, red_mlp = _reducers(cfg)
    for i, p in enumerate(layers):
        a = bound[i] if bound else None
        lc = _layer_cache(cache, i)
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, a, x, cos, sin)
        _write(lc, k, v, plan)
        if not hidden and i == len(layers) - 1:
            return None
        ck, cv, ks, vs = _read(lc, n)
        if table is None:
            o = chunk_attention(q, ck, cv, q_offset=q_offset, kv_valid_len=vl, k_scale=ks,
                                v_scale=vs)
        else:
            o = paged_prefill_attention(q, ck, cv, table, q_offset=q_offset, kv_valid_len=vl,
                                        k_scale=ks, v_scale=vs)
        h = h + alinear(p, a, "wo", o.reshape(b, c, -1), red_o)
        h = h + _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps), reduce=red_mlp)[0]
    return h


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
    h = _chunk_forward(cfg, params, adapters, cache, batch, layers, a_views)
    last = batch["last_idx"].long()[:, None, None].expand(-1, 1, h.shape[-1])
    hs = rms_norm(torch.gather(h, 1, last), params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, adapters, hs)[:, 0]


def verify_chunk(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """Speculative verification: :func:`prefill_chunk`'s forward with the
    head at every chunk column, so each slot's ``[token, d_1 .. d_K]``
    chunk is scored at all K + 1 positions in one call. Returns (B, C, V)
    logits; columns at or past a slot's ``q_len`` are garbage for the
    caller to mask (their writes went to the trash block or slot)."""
    h = _chunk_forward(cfg, params, adapters, cache, batch, layers, a_views)
    return _head_logits(cfg, params, adapters, rms_norm(h, params["final_norm"], cfg.norm_eps))


def ingest_chunk(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """:func:`prefill_chunk`'s k/v writes without its logits: a model
    drafter takes the mixed step's chunk into its own cache. No head runs
    (a (B, V) tied-head product a step would be thrown away), and the last
    layer stops at its k/v write. ``last_idx`` is not read."""
    _chunk_forward(cfg, params, adapters, cache, batch, layers, a_views, hidden=False)


def decode_step(cfg, params, adapters, cache, batch, layers=None, a_views=None):
    """One new token per slot: ``batch`` holds ``token`` (B,), ``pos`` (B,)
    int32 (the write index), for the paged pool ``block_table`` (B, n_pages)
    (without it the cache is the dense slot cache), and optionally
    ``active`` (B,) bool. Each layer writes at ``pos`` and attends with
    ``kv_valid_len = pos + 1``, or 0 where ``active`` is False: an idle slot
    reads no cache row (its output is zeros and discarded). A VLM batch may
    bring ``mrope_pos`` (3, B, 1): M-RoPE then turns q and k, else plain
    RoPE at ``pos``. ``adapters`` are tenant stacks or a training adapter
    tree (one adapter for every slot). Returns (B, V) logits."""
    layers = layer_views(params) if layers is None else layers
    pos, table = batch["pos"], batch.get("block_table")
    h = embed_tokens(cfg, params, batch["token"])[:, None]
    cos, sin = _angles(cfg, decode_positions(pos), batch.get("mrope_pos"), h.device)
    vl = pos + 1
    if table is None:  # a drafter's step past the dense cache's end reads all of it
        vl = vl.clamp(max=cache["k"].shape[2])
    if "active" in batch:
        vl = torch.where(batch["active"], vl, 0)
    n = cache["k"].shape[1] - 1
    plan = _write_plan(cache, table, pos, torch.ones_like(pos), 1)
    bound = _bind_adapters(adapters, a_views, len(layers))
    red_o, red_mlp = _reducers(cfg)
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
        h = h + alinear(p, a, "wo", o.reshape(h.shape[0], 1, -1), red_o)
        h = h + _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps), reduce=red_mlp)[0]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, adapters, h)[:, 0]


# ------------------------------------------------------------------- train


def delta_views(adapters, n_layers: int) -> list[dict]:
    """Per-layer views into the stacked leaves of a training adapter tree:
    ``{name: Delta}`` from ``(L, k, d_out)`` deltas, ``{name: {"A", "B",
    "scale"}}`` from LoRA's ``(L, d_in, r)`` / ``(L, r, d_out)`` / ``(L,)``
    leaves (slicing keeps the autograd link to the stacked trainables). A
    tenant stack has no place in training and raises, as any leaf
    :func:`~repro_torch.models.layers.adapter_leaf` does not know."""
    blocks = adapters.get("blocks") if adapters else None
    return [adapter_slice(blocks, i) for i in range(n_layers)]


def _train_head(cfg, params, adapters, h):
    """Tied: ``h @ embed.T``; untied: the head matmul plus, when the
    adapters carry one, its NeuroAda delta through the single-tenant bypass
    kernel (differentiable in h and the values). A LoRA leaf on the head is
    not applied — the reference's ``_head_logits``
    (``repro/models/transformer.py:261-265``) applies only deltas — so its
    gradient is zero, as there (``peft.lora`` warns at init)."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    logits = ops.matmul_q(h, params["head"]["w"])
    d = adapter_leaf(adapters, "head")
    if isinstance(d, Delta):
        logits = logits + ops.delta_apply(h, d.idx, d.val)
    elif isinstance(d, BatchedDelta):
        raise TypeError("training adapters hold a tenant stack at 'head'")
    return logits


REMAT_MODES = ("none", "full", "dots")


def remat_call(remat: str, fn, *args):
    """``fn(*args)``, a layer's (or group's) body, recomputed in the
    backward unless ``remat`` is ``none`` (see :func:`forward_train`)."""
    if remat == "none":
        return fn(*args)
    keep = ops.keep_linear_outputs if remat == "dots" else noop_context_fn
    with set_checkpoint_early_stop(False):  # the whole body, every kernel
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=keep)


def _train_layer(cfg, p, a, h, cos, sin):
    """One layer of the training forward: (h, the MoE layer's aux loss or
    None)."""
    b, s, _ = h.shape
    x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, a, x, cos, sin)
    o = train_attention(q, k, v, cfg)
    h = h + alinear(p, a, "wo", o.reshape(b, s, -1))
    y, aux_l = _mlp(cfg, p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps), with_aux=True)
    return h + y, aux_l


def forward_train(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """Training forward over ``batch["tokens"]`` (B, S) at positions
    ``0..S-1`` (or ``batch["positions"]``): causal attention, every adapted
    projection through the fused kernel. Returns ((B, S, V) logits, the
    auxiliary loss: the MoE layers' load-balancing losses summed over the
    layers and divided by L, 0 for the dense family).

    ``remat`` recomputes each layer body in the backward, as the
    reference's ``jax.checkpoint`` around its scan body
    (``torch.utils.checkpoint``, non-reentrant, the whole body recomputed
    once): ``full`` keeps only the layer's input, so every forward kernel
    of the layer runs again in the backward; ``dots`` also keeps the
    outputs of the layer's 2-D projections (the reference's
    ``dots_with_no_batch_dims_saveable``): the fused linear kernels are not
    launched again, while attention and the MoE expert products (batched)
    are recomputed. The values are those of ``none``, bit for bit."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    layers = layer_views(params) if layers is None else layers
    h, cos, sin = _embed_inputs(cfg, params, batch)
    deltas = delta_views(adapters, len(layers))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, a in zip(layers, deltas):
        h, aux_l = remat_call(remat, _train_layer, cfg, p, a, h, cos, sin)
        if aux_l is not None:
            aux = aux + aux_l
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _train_head(cfg, params, adapters, h), aux / cfg.num_layers


def loss_fn(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """Next-token cross-entropy in float32 (``batch["targets"]`` shifted by
    one, weighted by ``batch["loss_mask"]`` when given, vocab padding
    masked) plus ``router_aux_coef`` × the auxiliary loss. Returns
    (loss, {"ce", "aux"})."""
    logits, aux = forward_train(cfg, params, adapters, batch, layers, remat)
    if cfg.family == "vlm" and "patches" in batch:  # only text positions carry loss
        logits = logits[:, batch["patches"].shape[1]:]
    ce = next_token_loss(logits, batch, cfg.vocab_size)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

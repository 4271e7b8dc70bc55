"""seamless-m4t-large-v2: an encoder-decoder backbone with cross-attention
(port of ``repro.models.encdec``).

The speech front end is a stub, as in the reference: a batch brings
precomputed frame embeddings ``frames`` (B, S_enc, D). The encoder is a
stack of bidirectional self-attention and SwiGLU MLP layers; the decoder a
stack of causal self-attention, cross-attention to the encoder's output
and a SwiGLU MLP. RoPE turns q and k of every self-attention, never of the
cross-attention.

Params, in the reference's tree: ``embed`` (V, D), ``enc_blocks`` (Le,
...) with ``wq``/``wk``/``wv``/``wo``/``wgate``/``wup``/``wdown``,
``dec_blocks`` (Ld, ...) with ``self_w*``, ``cross_w*`` and the MLP,
``enc_norm``, ``final_norm`` and the untied ``head`` (D, V), which runs
through ``ops.matmul_q`` (it may be packed) and, as in the reference,
takes no bypass: its NeuroAda delta is selected and counted but never
applied, so its gradient is zero. Training adapters are the tree of
:func:`repro_torch.core.adapt.zip_adapters`, ``(L, k, d_out)`` deltas
beside each of a layer's 7 (encoder) or 11 (decoder) projections; each
layer takes its slice.

Attention is the transformer's: whole sequences (training, prefill)
dispatch to the flash kernel from ``cfg.flash_threshold`` keys on, causal
in the decoder's self-attention and not in the encoder's or the
cross-attention (Sq = the decoder's length there, Skv = the frame count),
and to the dense softmax below it. The decode step's self-attention is the
dense-cache decode kernel (``kv_valid_len = pos + 1``); its
cross-attention, one query over the cached cross k/v with no valid length,
is the plain dense softmax, as in the reference (``repro/models/
attention.py``'s dispatch sends it to ``dense_attention``).

The decode cache is the reference's: ``self_k``/``self_v`` (Ld, B, max_len,
KV, hd), written in place at each slot's ``pos`` (no trash slot: a write
past ``max_len`` raises where the reference drops it, as zamba2's site
caches do), and ``cross_k``/``cross_v`` (Ld, B, S_enc, KV, hd), computed
once by :func:`prefill` at the batch's frame count (``init_cache`` zeroes
them at :data:`DECODE_ENC_LEN`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import attention, dense_attention, train_attention
from repro_torch.models.layers import (
    Filler,
    adapter_slice,
    alinear,
    apply_rope,
    index_tree,
    next_token_loss,
    rms_norm,
    rope_angles,
    rope_freqs,
    silu_mlp,
)
from repro_torch.models.transformer import compute_dtype, embed_tokens

# Decode-mode encoder length (frames): the cross cache's fixed context
DECODE_ENC_LEN = 4096


def init_params(cfg, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with the reference's distributions."""
    dt = compute_dtype(cfg)
    fill = Filler(seed, device)
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    D, Fd = cfg.d_model, cfg.d_ff
    dq, dkv = cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim

    def attn(L, prefix=""):
        return {prefix + "wq": fill.linear(D, dq, dt, stack=(L,)),
                prefix + "wk": fill.linear(D, dkv, dt, stack=(L,)),
                prefix + "wv": fill.linear(D, dkv, dt, stack=(L,)),
                prefix + "wo": fill.linear(dq, D, dt, stack=(L,))}

    def mlp(L):
        return {"mlp_norm": fill.ones((L, D), dt),
                "wgate": fill.linear(D, Fd, dt, stack=(L,)),
                "wup": fill.linear(D, Fd, dt, stack=(L,)),
                "wdown": fill.linear(Fd, D, dt, stack=(L,))}

    enc = {"attn_norm": fill.ones((Le, D), dt), **attn(Le), **mlp(Le)}
    dec = {"self_norm": fill.ones((Ld, D), dt), **attn(Ld, "self_"),
           "cross_norm": fill.ones((Ld, D), dt), **attn(Ld, "cross_"), **mlp(Ld)}
    return {
        "embed": {"w": fill.normal((cfg.padded_vocab, D), 0.02, dt)},
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_norm": fill.ones((D,), dt),
        "final_norm": fill.ones((D,), dt),
        "head": fill.linear(D, cfg.padded_vocab, dt),
    }


def _stack_views(blocks) -> list[dict]:
    n = blocks["wq" if "wq" in blocks else "self_wq"]["w"].shape[0]
    return [index_tree(blocks, i) for i in range(n)]


def layer_views(params) -> tuple[list[dict], list[dict]]:
    """(encoder layers, decoder layers): per-layer dicts of views into the
    two stacks."""
    return _stack_views(params["enc_blocks"]), _stack_views(params["dec_blocks"])


def _a_views(adapters, key: str, n: int) -> list[dict]:
    blocks = adapters.get(key) if adapters else None
    return [adapter_slice(blocks, i) for i in range(n)]


def _rope(cfg, b: int, s: int, device):
    pos = torch.arange(s, device=device)[None, :].expand(b, s)
    return rope_angles(pos, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, device=device))


def _mha(cfg, p, a, prefix: str, xq, xkv, rope, *, causal: bool):
    """Attention of ``xq`` over ``xkv`` through the ``prefix`` projections:
    (the output projection's result, k, v). ``rope`` is the (cos, sin) of
    a self-attention's positions (q and k share them), None for the
    cross-attention."""
    b, sq, _ = xq.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = alinear(p, a, prefix + "wq", xq).view(b, sq, H, hd)
    k = alinear(p, a, prefix + "wk", xkv).view(b, xkv.shape[1], KV, hd)
    v = alinear(p, a, prefix + "wv", xkv).view(b, xkv.shape[1], KV, hd)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    o = train_attention(q, k, v, cfg, causal=causal)
    return alinear(p, a, prefix + "wo", o.reshape(b, sq, -1)), k, v


def _mlp(cfg, p, a, h):
    return h + silu_mlp(p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))


def encode(cfg, params, adapters, frames, layers=None):
    """Frames (B, S_enc, D) -> the normed encoder output (B, S_enc, D) in
    the compute dtype: bidirectional self-attention with RoPE at 0..S-1."""
    enc_layers = (layer_views(params) if layers is None else layers)[0]
    h = frames.to(compute_dtype(cfg))
    b, s, _ = h.shape
    rope = _rope(cfg, b, s, h.device)
    for p, a in zip(enc_layers, _a_views(adapters, "enc_blocks", len(enc_layers))):
        x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        h = h + _mha(cfg, p, a, "", x, x, rope, causal=False)[0]
        h = _mlp(cfg, p, a, h)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _decode_stack(cfg, params, adapters, h, enc_out, dec_layers, *, collect_cache=False):
    """The decoder over a whole target sequence (B, S, D) at positions
    0..S-1: (h, and with ``collect_cache`` the per-layer self and cross
    k/v stacked (Ld, B, ·, KV, hd))."""
    b, s, _ = h.shape
    rope = _rope(cfg, b, s, h.device)
    cache = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    for p, a in zip(dec_layers, _a_views(adapters, "dec_blocks", len(dec_layers))):
        x = rms_norm(h, p["self_norm"], cfg.norm_eps)
        o, sk, sv = _mha(cfg, p, a, "self_", x, x, rope, causal=True)
        h = h + o
        x = rms_norm(h, p["cross_norm"], cfg.norm_eps)
        o, ck, cv = _mha(cfg, p, a, "cross_", x, enc_out, None, causal=False)
        h = _mlp(cfg, p, a, h + o)
        if collect_cache:
            for key, t in zip(cache, (sk, sv, ck, cv)):
                cache[key].append(t)
    if not collect_cache:
        return h, None
    return h, {key: torch.stack(ts) for key, ts in cache.items()}


def _head(cfg, params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return ops.matmul_q(h, params["head"]["w"])  # no bypass, as in the reference


def forward_train(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """((B, S, V) logits, 0) of ``batch["frames"]`` (B, S_enc, D) and the
    teacher-forced ``batch["tokens"]`` (B, S). ``remat`` is taken and
    ignored, as in the reference (``repro/models/encdec.py:145``)."""
    layers = layer_views(params) if layers is None else layers
    enc_out = encode(cfg, params, adapters, batch["frames"], layers)
    h = embed_tokens(cfg, params, batch["tokens"])
    h, _ = _decode_stack(cfg, params, adapters, h, enc_out, layers[1])
    return _head(cfg, params, h), torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """Next-token cross-entropy in float32 over the decoder's positions
    (targets shifted by one, the ``loss_mask`` weights when given, vocab
    padding masked)."""
    logits, aux = forward_train(cfg, params, adapters, batch, layers, remat)
    ce = next_token_loss(logits, batch, cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, device, enc_len: int = DECODE_ENC_LEN) -> dict:
    """Zeroed ``self_k``/``self_v`` (Ld, B, max_len, KV, hd) and
    ``cross_k``/``cross_v`` (Ld, B, enc_len, KV, hd) in the compute dtype."""
    kv = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = compute_dtype(cfg)
    return {key: torch.zeros((*kv, n, *tail), dtype=dt, device=device)
            for key, n in (("self_k", max_len), ("self_v", max_len), ("cross_k", enc_len),
                           ("cross_v", enc_len))}


def prefill(cfg, params, adapters, batch, layers=None):
    """Encode ``batch["frames"]``, then a teacher-forced decoder pass over
    ``batch["tokens"]`` (B, S): ((B, V) logits at the last position, the
    cache: every decoder layer's self k/v (Ld, B, S, KV, hd) — pad their
    sequence axis to decode on — and its cross k/v over the frames, (Ld,
    B, S_enc, KV, hd), computed once here)."""
    layers = layer_views(params) if layers is None else layers
    enc_out = encode(cfg, params, adapters, batch["frames"], layers)
    h = embed_tokens(cfg, params, batch["tokens"])
    h, cache = _decode_stack(cfg, params, adapters, h, enc_out, layers[1], collect_cache=True)
    return _head(cfg, params, h[:, -1:])[:, 0], cache


def decode_step(cfg, params, adapters, cache, batch, layers=None):
    """One target token a sequence: ``batch["token"]`` (B,) at
    ``batch["pos"]`` (B,) or () int32, the write index. Each decoder layer
    writes its self k/v at ``pos`` in place and attends to rows ``< pos + 1``
    (the dense decode kernel), then over its cached cross k/v (the dense
    softmax). Returns (B, V) logits."""
    dec_layers = (layer_views(params) if layers is None else layers)[1]
    tok = batch["token"]
    b = tok.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = torch.as_tensor(batch["pos"], device=tok.device).to(torch.int32).expand(b)
    h = embed_tokens(cfg, params, tok)[:, None]
    cos, sin = rope_angles(pos[:, None], rope_freqs(hd, cfg.rope_theta, device=h.device))
    rows, at = torch.arange(b, device=tok.device), pos.long()
    vl = (pos + 1).contiguous()
    for i, (p, a) in enumerate(zip(dec_layers, _a_views(adapters, "dec_blocks",
                                                        len(dec_layers)))):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        x = rms_norm(h, p["self_norm"], cfg.norm_eps)
        q = apply_rope(alinear(p, a, "self_wq", x).view(b, 1, H, hd), cos, sin)
        sk[rows, at] = apply_rope(alinear(p, a, "self_wk", x).view(b, 1, KV, hd), cos, sin)[:, 0]
        sv[rows, at] = alinear(p, a, "self_wv", x).view(b, 1, KV, hd)[:, 0]
        o = attention(q, sk, sv, kv_valid_len=vl)
        h = h + alinear(p, a, "self_wo", o.reshape(b, 1, -1))
        x = rms_norm(h, p["cross_norm"], cfg.norm_eps)
        q = alinear(p, a, "cross_wq", x).view(b, 1, H, hd)
        o = dense_attention(q, cache["cross_k"][i], cache["cross_v"][i], causal=False)
        h = _mlp(cfg, p, a, h + alinear(p, a, "cross_wo", o.reshape(b, 1, -1)))
    return _head(cfg, params, h)[:, 0]

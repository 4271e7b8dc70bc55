"""zamba2-2.7b: a Mamba-2 trunk with one weight-tied attention block shared
by every group (port of ``repro.models.zamba2``).

The ``num_layers`` Mamba-2 blocks form ``g = num_layers / attn_every``
groups of ``per = attn_every``; before each group the *shared* transformer
block (attention and SwiGLU MLP, one set of weights) runs on the hidden
state. Params: ``embed``, ``shared`` (2-D weights), ``blocks`` the (g,
per, ...) Mamba-2 stacks, ``final_norm``, ``head`` (untied; through
``ops.matmul_q`` and, as in the reference, no bypass: its delta is
selected and counted but never applied).

NeuroAda deltas on the shared block are tied across its ``g`` sites like
its weights: one ``(k, d_out)`` delta a projection, applied at every site,
whose value gradient autograd sums over the sites. The Mamba-2 deltas are
``(g, per, k, d_out)`` stacks, sliced a layer at a time.

Decode keeps the Mamba states (O(1)) and one KV cache a site, ``(g, B, S,
KV, hd)``; the shared block's decode attention is the dense-cache decode
kernel (non-causal, ``kv_valid_len = pos + 1``), its training and prefill
attention the transformer's (dense below ``flash_threshold``, the flash
kernel from it on).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.attention import attention, train_attention
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
from repro_torch.models.transformer import REMAT_MODES, compute_dtype, embed_tokens, remat_call


def groups(cfg) -> tuple[int, int]:
    """(g, per): the number of shared-block sites and Mamba-2 blocks a group."""
    per = cfg.attn_every
    if per < 1 or cfg.num_layers % per:
        raise ValueError(f"num_layers={cfg.num_layers} is no multiple of attn_every={per}")
    return cfg.num_layers // per, per


def init_params(cfg, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with the reference's distributions."""
    dt = compute_dtype(cfg)
    fill = Filler(seed, device)
    D, Fd = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shared = {
        "attn_norm": fill.ones((D,), dt),
        "wq": fill.linear(D, H * hd, dt),
        "wk": fill.linear(D, KV * hd, dt),
        "wv": fill.linear(D, KV * hd, dt),
        "wo": fill.linear(H * hd, D, dt),
        "mlp_norm": fill.ones((D,), dt),
        "wgate": fill.linear(D, Fd, dt),
        "wup": fill.linear(D, Fd, dt),
        "wdown": fill.linear(Fd, D, dt),
    }
    return {
        "embed": {"w": fill.normal((cfg.padded_vocab, D), 0.02, dt)},
        "shared": shared,
        "blocks": ssm.init_mamba2_block(cfg, fill, dt, stack=groups(cfg)),
        "final_norm": fill.ones((D,), dt),
        "head": fill.linear(D, cfg.padded_vocab, dt),
    }


def layer_views(params) -> list[list[dict]]:
    """``views[g][j]``: the j-th Mamba-2 block of group g."""
    blocks = params["blocks"]
    g, per = blocks["norm"].shape[:2]
    return [[index_tree(index_tree(blocks, i), j) for j in range(per)] for i in range(g)]


def _a_views(adapters, g: int, per: int) -> list[list[dict]]:
    blocks = adapters.get("blocks") if adapters else None
    out = []
    for i in range(g):
        group = adapter_slice(blocks, i)
        out.append([adapter_slice(group, j) for j in range(per)])
    return out


def _shared_adapters(adapters) -> dict | None:
    return adapters.get("shared") if adapters else None


def _qkv(cfg, p, a, h, cos, sin):
    """The shared block's normed input and its rotated q, k and v."""
    b, s, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    q = alinear(p, a, "wq", x).view(b, s, H, hd)
    k = alinear(p, a, "wk", x).view(b, s, KV, hd)
    v = alinear(p, a, "wv", x).view(b, s, KV, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _shared_rest(cfg, p, a, h, o):
    """The shared block after attention: the output projection, the MLP."""
    h = h + alinear(p, a, "wo", o.reshape(*h.shape[:2], -1))
    return h + silu_mlp(p, a, rms_norm(h, p["mlp_norm"], cfg.norm_eps))


def shared_block(cfg, p, a, h, cos, sin):
    """The weight-tied attention + MLP block over a whole sequence (causal).
    Returns (h, k, v): the prefill keeps k and v as the site's cache."""
    q, k, v = _qkv(cfg, p, a, h, cos, sin)
    return _shared_rest(cfg, p, a, h, train_attention(q, k, v, cfg)), k, v


def _angles(cfg, positions, device):
    return rope_angles(positions, rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                             device=device))


def _seq_angles(cfg, tokens, device):
    b, s = tokens.shape
    return _angles(cfg, torch.arange(s, device=device)[None, :].expand(b, s), device)


def _head(cfg, params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return ops.matmul_q(h, params["head"]["w"])


def _group(cfg, sh_p, sh_a, views, a_views, h, cos, sin):
    h = shared_block(cfg, sh_p, sh_a, h, cos, sin)[0]
    for p, a in zip(views, a_views):
        h = ssm.mamba2_block(cfg, p, a, h)
    return h


def forward_train(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """((B, S, V) logits, 0) of ``batch["tokens"]`` (B, S) at positions
    0..S-1. ``remat`` recomputes each group (the shared block and its
    Mamba-2 blocks) in the backward, as the reference checkpoints its
    group body."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    layers = layer_views(params) if layers is None else layers
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    cos, sin = _seq_angles(cfg, tokens, h.device)
    sh_p, sh_a = params["shared"], _shared_adapters(adapters)
    for views, a_views in zip(layers, _a_views(adapters, len(layers), len(layers[0]))):
        h = remat_call(remat, _group, cfg, sh_p, sh_a, views, a_views, h, cos, sin)
    return _head(cfg, params, h), torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """Next-token cross-entropy in float32, as the Mamba LM's."""
    logits, aux = forward_train(cfg, params, adapters, batch, layers, remat)
    ce = next_token_loss(logits, batch, cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeroed ``shared_k``/``shared_v`` (g, B, max_len, KV, hd) in the compute
    dtype, ``conv`` (g, per, B, W-1, di) and ``ssm`` (g, per, B, H, P, N)
    float32."""
    g, per = groups(cfg)
    dt = compute_dtype(cfg)
    kv = (g, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "shared_k": torch.zeros(kv, dtype=dt, device=device),
        "shared_v": torch.zeros(kv, dtype=dt, device=device),
        "conv": torch.zeros((g, per, batch, cfg.conv_width - 1, cfg.resolved_d_inner),
                            dtype=dt, device=device),
        "ssm": torch.zeros((g, per, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def prefill(cfg, params, adapters, batch, layers=None):
    """Whole-prompt forward: ((B, V) logits at the last position, the cache:
    each site's k and v (g, B, S, KV, hd) — pad their sequence axis to
    decode on — and every Mamba-2 block's conv window and SSM state)."""
    layers = layer_views(params) if layers is None else layers
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    cos, sin = _seq_angles(cfg, tokens, h.device)
    sh_p, sh_a = params["shared"], _shared_adapters(adapters)
    ks, vs, convs, states = [], [], [], []
    for views, a_views in zip(layers, _a_views(adapters, len(layers), len(layers[0]))):
        h, k, v = shared_block(cfg, sh_p, sh_a, h, cos, sin)
        ks.append(k)
        vs.append(v)
        gc, gs = [], []
        for p, a in zip(views, a_views):
            h, (conv, state) = ssm.mamba2_block(cfg, p, a, h, return_state=True)
            gc.append(conv)
            gs.append(state)
        convs.append(torch.stack(gc))
        states.append(torch.stack(gs))
    logits = _head(cfg, params, h[:, -1:])[:, 0]
    return logits, {"shared_k": torch.stack(ks), "shared_v": torch.stack(vs),
                    "conv": torch.stack(convs), "ssm": torch.stack(states)}


def decode_step(cfg, params, adapters, cache, batch, layers=None):
    """One token a sequence: ``batch["token"]`` (B,) at ``batch["pos"]`` (B,)
    or () int32, the write index. Each site writes its k and v at ``pos`` and
    attends to rows ``< pos + 1`` (the dense decode kernel); every cache leaf
    advances in place. Returns (B, V) logits."""
    layers = layer_views(params) if layers is None else layers
    tok = batch["token"]
    b = tok.shape[0]
    pos = torch.as_tensor(batch["pos"], device=tok.device).to(torch.int32).expand(b)
    h = embed_tokens(cfg, params, tok)[:, None]
    cos, sin = _angles(cfg, pos[:, None], h.device)
    sh_p, sh_a = params["shared"], _shared_adapters(adapters)
    rows = torch.arange(b, device=tok.device)
    vl = (pos + 1).contiguous()
    for i, (views, a_views) in enumerate(zip(layers, _a_views(adapters, len(layers),
                                                              len(layers[0])))):
        ck, cv = cache["shared_k"][i], cache["shared_v"][i]
        q, k, v = _qkv(cfg, sh_p, sh_a, h, cos, sin)
        ck[rows, pos.long()] = k[:, 0]
        cv[rows, pos.long()] = v[:, 0]
        h = _shared_rest(cfg, sh_p, sh_a, h, attention(q, ck, cv, kv_valid_len=vl))
        for j, (p, a) in enumerate(zip(views, a_views)):
            h, conv, state = ssm.mamba2_decode(cfg, p, a, h, cache["conv"][i, j],
                                               cache["ssm"][i, j])
            cache["conv"][i, j].copy_(conv)
            cache["ssm"][i, j].copy_(state)
    return _head(cfg, params, h)[:, 0]

"""falcon-mamba-7b: the attention-free Mamba-1 language model (port of
``repro.models.mamba_lm``).

Params: ``embed`` (V, D), ``blocks`` the (L, ...) Mamba-1 stack of
:mod:`repro_torch.models.ssm`, ``final_norm`` and, untied, ``head`` (D,
V). The decode state is O(1) in the context: a conv window and a (di, N)
SSM state a layer, no KV cache. The untied head runs through
``ops.matmul_q`` (it may be packed) and, as in the reference, takes no
bypass: its NeuroAda delta is selected and counted but never applied, so
its gradient is zero.

Training adapters are the tree of
:func:`repro_torch.core.adapt.zip_adapters`: ``Delta`` leaves of ``(L, k,
d_out)`` beside ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj``; each
layer takes its slice. The layer stack is a Python loop over per-layer
views (the reference's ``lax.scan``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.layers import Filler, next_token_loss, rms_norm
from repro_torch.models.transformer import (  # noqa: F401  (layer_views: the registry's)
    REMAT_MODES,
    compute_dtype,
    delta_views,
    embed_tokens,
    layer_views,
    remat_call,
)


def init_params(cfg, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with the reference's distributions."""
    dt = compute_dtype(cfg)
    fill = Filler(seed, device)
    params = {
        "embed": {"w": fill.normal((cfg.padded_vocab, cfg.d_model), 0.02, dt)},
        "blocks": ssm.init_mamba1_block(cfg, fill, dt),
        "final_norm": fill.ones((cfg.d_model,), dt),
    }
    if not cfg.tie_embeddings:
        params["head"] = fill.linear(cfg.d_model, cfg.padded_vocab, dt)
    return params


def _head(cfg, params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    return ops.matmul_q(h, params["head"]["w"])  # an untied head may be packed


def forward_train(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """((B, S, V) logits, 0) of ``batch["tokens"]`` (B, S). ``remat``
    recomputes each layer in the backward as the transformer's does
    (``full``: only the layer's input kept; ``dots``: the fused linears'
    outputs kept too)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    layers = layer_views(params) if layers is None else layers
    h = embed_tokens(cfg, params, batch["tokens"])
    for p, a in zip(layers, delta_views(adapters, len(layers))):
        h = remat_call(remat, ssm.mamba1_block, cfg, p, a, h)
    return _head(cfg, params, h), torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg, params, adapters, batch, layers=None, remat: str = "none"):
    """Next-token cross-entropy in float32 (targets shifted by one, the
    ``loss_mask`` weights when given, vocab padding masked)."""
    logits, aux = forward_train(cfg, params, adapters, batch, layers, remat)
    ce = next_token_loss(logits, batch, cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """The recurrent state, O(1) in ``max_len``: ``conv`` (L, B, W-1, di) in
    the compute dtype, ``ssm`` (L, B, di, N) float32, zeroed."""
    L, di, n, cw = cfg.num_layers, cfg.resolved_d_inner, cfg.ssm_state, cfg.conv_width
    return {"conv": torch.zeros((L, batch, cw - 1, di), dtype=compute_dtype(cfg), device=device),
            "ssm": torch.zeros((L, batch, di, n), dtype=torch.float32, device=device)}


def prefill(cfg, params, adapters, batch, layers=None):
    """Whole-prompt forward: ((B, V) logits at the last position, the cache
    :func:`decode_step` continues from: every layer's final conv window and
    SSM state)."""
    layers = layer_views(params) if layers is None else layers
    h = embed_tokens(cfg, params, batch["tokens"])
    convs, states = [], []
    for p, a in zip(layers, delta_views(adapters, len(layers))):
        h, (conv, state) = ssm.mamba1_block(cfg, p, a, h, return_state=True)
        convs.append(conv)
        states.append(state)
    logits = _head(cfg, params, h[:, -1:])[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(states)}


def decode_step(cfg, params, adapters, cache, batch, layers=None):
    """One token a sequence, ``batch["token"]`` (B,): every layer's conv
    window and SSM state advance in place in ``cache``. Returns (B, V)
    logits."""
    layers = layer_views(params) if layers is None else layers
    h = embed_tokens(cfg, params, batch["token"])[:, None]
    for i, (p, a) in enumerate(zip(layers, delta_views(adapters, len(layers)))):
        h, conv, state = ssm.mamba1_decode(cfg, p, a, h, cache["conv"][i], cache["ssm"][i])
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(state)
    return _head(cfg, params, h)[:, 0]

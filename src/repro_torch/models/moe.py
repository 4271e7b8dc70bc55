"""Token-choice MoE FFN with sort-based dispatch (port of
``repro.models.moe``).

Route: top-K gating -> stable argsort of the (token, choice) assignments
-> capacity-truncated expert buffers -> batched expert FFN -> combine
weighted by the gate values. Tokens split into ``groups`` routing groups
(shrunk until they divide the tokens, as the reference does), each with
capacity ``C = capacity(cfg, tokens_per_group)``; assignments beyond an
expert's capacity are dropped and the token keeps only its residual, as
in GShard/Switch. Idle slots and pad rows route like any token, so they
compete for capacity exactly as in the reference.

The reference vmaps over groups and experts; here both are tensor axes,
with no Python loop over either. Expert buffers are built directly in
expert-major layout ``(E, G·C, D)``: row ``g·C + c`` of expert ``e`` holds
the ``c``-th token of group ``g`` routed to ``e``, zeros where there is
none. Each expert linear is then one batched matmul (the reference's XLA
einsum) plus one bypass launch over the whole stack: a training ``Delta``
``(E, k, F)`` through ``ops.delta_apply``, a serving ``BatchedDelta``
``(N, E, k, F)`` through one ``sparse_delta_batched`` with the ``(N·E, k,
F)`` stack and the combined id ``tenant · E + e`` per buffer row.

Ties and determinism. Top-K takes a stable descending sort, so equal
probabilities go to the lower expert first, as ``jax.lax.top_k``; the
dispatch order is a stable argsort, as the reference's. The reference
dispatches with a scatter (``.at[dest].set``) and combines with a
scatter-add (``.at[tok_of].add``); here each buffer row gathers the token
that fills it, and each (token, choice) gathers its expert's output back
and the K choices are summed per token — no atomics in the forward, so
repeated runs give the same bits. In float32 and for K = 2 the sum is the
reference's bit for bit; for larger K it agrees within rounding.

Expert parallelism (tensor-parallel serving). Under a live serving group
of tp > 1 whose size divides ``E`` (:func:`repro_torch.distributed.
sharding.local_experts`), a rank holds the experts ``[lo, hi)`` and their
tenant stacks. It routes every token over all ``E`` experts with the
replicated router, exactly as above (the same top-K, stable argsort and
capacity of the whole group, so capacity drops are the reference's), then
keeps the buffer rows of its own experts, runs only those, and combines
only the choices whose expert is local: each rank's output is a partial
sum, and one all-reduce (the caller's ``reduce``) adds them up. No
all-to-all is needed: the reference's dispatch all-to-all arises where
routing groups are sharded over a data axis, but in SPMD serving every
rank holds every token after the attention's all-reduce, so the MoE layer
costs the same one all-reduce as the dense MLP's row-parallel ``wdown``.
Replicated experts, and any call outside a serving group (training, a
tp = 1 engine), take the path above unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.distributed import context as tp_ctx
from repro_torch.distributed.sharding import local_experts
from repro_torch.kernels import ops
from repro_torch.models.layers import adapter_leaf

EXPERT_LINEARS = ("wgate", "wup", "wdown")


def capacity(cfg, tokens: int) -> int:
    c = int(-(-tokens * cfg.experts_per_token * cfg.capacity_factor // cfg.num_experts))
    return max(c, cfg.experts_per_token)


def num_groups(t: int, kk: int, groups: int = 32) -> int:
    """The reference's group count for ``t`` tokens: halve ``groups`` until
    it divides ``t`` with at least ``kk`` tokens a group (1 at the end)."""
    g = groups
    while t % g or (t // g) < kk:
        g //= 2
        if g <= 1:
            return 1
    return g


class Route(NamedTuple):
    """Where every token goes and comes back, for all groups at once."""

    src: torch.Tensor  # (E, G·C) int64: the flat token each buffer row holds
    filled: torch.Tensor  # (E, G·C) bool: False for an empty buffer row
    dest: torch.Tensor  # (G, Tg, K) int64: row of the flat (E·G·C) output
    keep: torch.Tensor  # (G, Tg, K) bool: False where capacity dropped it
    gate: torch.Tensor  # (G, Tg, K) float32: normalised gate values


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    descending order, equal values to the lower index first — what
    ``jax.lax.top_k`` returns (``torch.topk`` promises no order on ties)."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def _route_group(cfg, probs: torch.Tensor, c: int) -> tuple[Route, torch.Tensor]:
    """Sort-based dispatch of every group: probs (G, Tg, E) float32 ->
    (:class:`Route`, the top-1 expert of each token (G, Tg))."""
    e, kk = cfg.num_experts, cfg.experts_per_token
    g, tg, _ = probs.shape
    gate, exp_idx = top_k(probs, kk)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    a_flat = exp_idx.reshape(g, tg * kk)
    order = torch.argsort(a_flat, dim=-1, stable=True)  # (G, TgK): by expert, then token
    counts = torch.zeros((g, e), dtype=torch.int64, device=probs.device)
    counts.scatter_add_(1, a_flat, torch.ones_like(a_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    dev = probs.device
    # dispatch: buffer row (g, e, c) holds sorted assignment starts[g, e] + c
    cc = torch.arange(c, device=dev)
    filled = cc < counts[:, :, None]  # (G, E, C)
    p = torch.clamp(starts[:, :, None] + cc, max=tg * kk - 1)
    tok = torch.gather(order, 1, p.reshape(g, e * c)).reshape(g, e, c) // kk
    src = tok + (torch.arange(g, device=dev) * tg)[:, None, None]
    # combine: assignment (t, j) sits at sorted position inv; its rank
    # within its expert is inv - starts[expert]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(tg * kk, device=dev).expand(g, -1).contiguous())
    pos = inv - torch.gather(starts, 1, a_flat)
    keep = pos < c
    dest = (a_flat * g + torch.arange(g, device=dev)[:, None]) * c + torch.clamp(pos, max=c - 1)
    route = Route(src=src.permute(1, 0, 2).reshape(e, g * c),
                  filled=filled.permute(1, 0, 2).reshape(e, g * c),
                  dest=dest.reshape(g, tg, kk), keep=keep.reshape(g, tg, kk), gate=gate)
    return route, exp_idx[..., 0]


def expert_span(cfg) -> tuple[int, int] | None:
    """[lo, hi) of the experts this rank holds under a live serving group of
    tp > 1 that splits them, else None (every expert here)."""
    tp = tp_ctx.serve_tp()
    return None if tp <= 1 else local_experts(cfg.num_experts, tp_ctx.serve_rank(), tp)


def local_route(route: Route, span: tuple[int, int]) -> Route:
    """The part of a global :class:`Route` that the experts ``[lo, hi)``
    serve: their buffer rows ``(hi - lo, G·C)``, and only the choices whose
    expert is local kept, with ``dest`` shifted to the local rows."""
    lo, hi = span
    gc = route.src.shape[1]
    expert = route.dest // gc  # dest indexes the (E·G·C) expert-major output
    mine = (expert >= lo) & (expert < hi)
    dest = torch.clamp(route.dest - lo * gc, 0, (hi - lo) * gc - 1)
    return Route(src=route.src[lo:hi], filled=route.filled[lo:hi], dest=dest,
                 keep=route.keep & mine, gate=route.gate)


def _dispatch(xt: torch.Tensor, route: Route) -> torch.Tensor:
    """Expert buffers (E, G·C, D) from the flat tokens xt (T, D)."""
    return torch.where(route.filled[..., None], xt[route.src], 0.0)


def _combine_group(out_e: torch.Tensor, route: Route, dtype) -> torch.Tensor:
    """(E, G·C, D) expert outputs -> (G, Tg, D): each token's kept choices
    weighted by their gates, summed over the K choices."""
    flat = out_e.reshape(-1, out_e.shape[-1])
    contrib = torch.where(route.keep[..., None], flat[route.dest], 0.0)
    return (contrib * route.gate.to(dtype)[..., None]).sum(dim=2)


def _dispatch_adapter_ids(a, route: Route, b: int, s: int, e: int):
    """Per-sequence tenant ids scattered through the dispatch: (E, G·C)
    int32 combined ids ``tenant · E + e`` into the ``(N·E, k, F)`` stacks,
    or None without tenant stacks. An empty buffer row keeps tenant 0 (its
    activations are zero, so its delta adds zero); the router stays the
    base model's (DESIGN §7). Under expert parallelism ``route`` is the
    local one and ``e`` the local count ``E / tp``: the id is then
    ``tenant · (E / tp) + (e − lo)`` into the rank's ``(N·E / tp, k, F)``
    stack (an id built with the global ``E`` would read past it)."""
    d0 = next((d for d in (adapter_leaf(a, n) for n in EXPERT_LINEARS)
               if isinstance(d, BatchedDelta)), None)
    if d0 is None:
        return None
    aid = d0.aid
    aid_t = (aid if aid.ndim == 2 else aid[:, None].expand(b, s)).reshape(-1)
    tenant = torch.where(route.filled, aid_t[route.src], 0)
    expert = torch.arange(e, device=tenant.device)[:, None]
    return (tenant * e + expert).to(torch.int32)


def _expert_linear_g(p: dict, a, name: str, eh: torch.Tensor, aid_buf=None) -> torch.Tensor:
    """eh (E, R, Din) @ w (E, Din, Dout) plus the expert stack's NeuroAda
    bypass -> (E, R, Dout). A packed (int8 / NF4) stack is dequantized per
    call (``ops.bmm_q``), as the reference does."""
    y = ops.bmm_q(eh, p[name]["w"])
    d = adapter_leaf(a, name)
    if isinstance(d, BatchedDelta):  # serving: added into y in the kernel's epilogue
        n, e, k, f = d.idx.shape
        ops.delta_apply_batched(eh, d.idx.reshape(n * e, k, f), d.val.reshape(n * e, k, f),
                                aid_buf, y)
    elif isinstance(d, Delta):
        y = y + ops.delta_apply(eh, d.idx, d.val)
    elif d is not None:
        raise ValueError(
            f"a LoRA leaf on the expert stack {name!r}: LoRA cannot train the MoE family — the "
            "reference hands it to ops.delta_apply (repro/models/moe.py:163-166, an "
            "AttributeError), and the port refuses it likewise")
    return y


def moe_ffn(cfg, p: dict, a, x: torch.Tensor, *, groups: int = 32, with_aux: bool = True,
            reduce=None):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar float32, or None
    when ``with_aux`` is False: serving drops the loss and skips its
    launches). Nothing here waits for the device: the top-1 counts are a
    scatter-add, not ``bincount``, which reads its input's range back to
    the host on the card. Under expert parallelism (:func:`expert_span`)
    ``p`` and ``a`` hold this rank's experts and ``out`` is the rank's
    partial sum, which ``reduce`` (the serving group's all-reduce, when
    given) sums over the ranks once, after the combine. Where the experts
    are not split ``reduce`` is not called: every rank computed the whole
    sum."""
    b, s, dm = x.shape
    e = cfg.num_experts
    t = b * s
    g = num_groups(t, cfg.experts_per_token, groups)
    tg = t // g
    c = capacity(cfg, tg)
    xt = x.reshape(t, dm)
    logits = (xt.reshape(g, tg, dm) @ p["router"]["w"]).float()
    probs = torch.softmax(logits, dim=-1)
    route, top1 = _route_group(cfg, probs, c)
    span = expert_span(cfg)
    if span is not None:
        route = local_route(route, span)
    eh = _dispatch(xt, route)
    aid_buf = _dispatch_adapter_ids(a, route, b, s, route.src.shape[0])
    h = F.silu(_expert_linear_g(p, a, "wgate", eh, aid_buf)) * _expert_linear_g(
        p, a, "wup", eh, aid_buf)
    out_e = _expert_linear_g(p, a, "wdown", h, aid_buf)
    yt = _combine_group(out_e, route, x.dtype).reshape(b, s, dm)
    if span is not None and reduce is not None:
        yt = reduce(yt)
    if not with_aux:
        return yt, None
    top1 = top1.reshape(-1)
    frac_tokens = torch.zeros(e, device=x.device).scatter_add_(
        0, top1, torch.ones(t, device=x.device)) / t
    frac_probs = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return yt, aux

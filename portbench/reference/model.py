"""The plain reference of the benchmark's models: the decoder (dense
SwiGLU or routed experts) in float32 PyTorch, with TF32 off, and nothing
of the program's: no kernel, no cache, no batching of requests.

It reads the weight tree the benchmark made (the program's layout, ``y =
x @ W``) and a NeuroAda adapter given as ``{path: (idx, val)}``, where
``idx`` (..., k, d_out) names the input rows whose bypass values ``val``
add to each output: ``y[o] += Σ_j val[j, o] · x[idx[j, o]]``.

The model (Qwen2 and OLMoE as the program computes them): RMSNorm in
float32, rotary embedding on halves, causal grouped-query attention (head
``h`` reads kv-head ``h // (H / KV)``), OLMoE's q/k RMSNorm per head, a
SwiGLU MLP, or a top-K router (softmax, the K largest with ties to the
lower expert, gates divided by their sum) whose tokens fall in routing
groups with a capacity per expert: an assignment past its expert's
capacity, counted in (token, choice) order within the group, is dropped.
The training loss is the next-token cross-entropy over the real vocabulary
plus ``aux_coef`` × the mean over layers of ``E · Σ_e f_e · P_e`` (top-1
share times mean probability).

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 (per output column for a weight, per row for an
activation, scaled to the format's range) and accumulated in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness.arch import Arch, capacity, num_groups

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale a slice along ``dim``;
    the gradient passes the rounding unchanged."""
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


class Weights:
    """The float32 copy of a weight tree (fp8-rounded matrices for the
    control), made once; leaves by path."""

    def __init__(self, arch: Arch, tree: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.arch, self.fp8 = arch, precision == "fp8"

        def conv(path, t):
            t = t.float()
            if self.fp8 and path[-1] == "w" and path[0] in ("blocks", "head"):
                t = fp8_round(t, -2)
            return t

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            return conv(path, node)

        self.tree = walk(tree, ())
        if self.fp8 and arch.tied:  # the tied head's matrix is the embedding's transpose
            self.head_t = fp8_round(self.tree["embed"]["w"], -1)
        else:
            self.head_t = self.tree["embed"]["w"] if arch.tied else None

    def layer(self, i: int) -> dict:
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node[i]
        return pick(self.tree["blocks"])


def _act(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return fp8_round(x, -1) if fp8 else x


def bypass(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) with idx/val (k, d_out) -> (..., d_out)."""
    k, d_out = idx.shape
    xg = x.index_select(-1, idx.reshape(-1).long()).view(*x.shape[:-1], k, d_out)
    return (xg * val).sum(dim=-2)


def linear(x, p: dict, ad, fp8: bool):
    """x @ W (+ b) (+ the bypass of ``ad`` = (idx, val) or None)."""
    y = _act(x, fp8) @ p["w"]
    if p.get("b") is not None:
        y = y + p["b"]
    if ad is not None:
        y = y + bypass(x, *ad)
    return y


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotate halves of x (B, S, H, hd) by positions pos (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v):
    """Causal attention, q (B, S, H, hd), k/v (B, S, KV, hd), float32."""
    s, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
    col = torch.arange(s, device=q.device)
    sc = sc.masked_fill(col[None, :] > col[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)


def route(arch: Arch, probs: torch.Tensor):
    """Top-K routing of flat tokens probs (T, E): (experts (T, K), gates (T,
    K) normalised, keep (T, K) bool after the groups' capacities)."""
    t, e = probs.shape
    kk = arch.top_k
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = srt.values[:, :kk], srt.indices[:, :kk]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    g = num_groups(t, kk)
    c = capacity(arch, t // g)
    onehot = F.one_hot(experts.reshape(g, -1), e)  # (G, Tg*K, E) in (token, choice) order
    rank = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1
    keep = (rank < c).reshape(t, kk)
    return experts, gates, keep


def moe(arch: Arch, p: dict, ads: dict, x: torch.Tensor, fp8: bool):
    """(y (T, D), aux) of the routed experts on flat tokens x (T, D)."""
    t, d = x.shape
    e = arch.experts
    probs = torch.softmax(_act(x, fp8) @ p["router"]["w"], dim=-1)
    experts, gates, keep = route(arch, probs)
    y = torch.zeros_like(x)
    flat_e, flat_keep = experts.reshape(-1), keep.reshape(-1)
    tok_of = torch.arange(t, device=x.device).repeat_interleave(arch.top_k)
    gate_of = gates.reshape(-1)
    for j in range(e):
        sel = torch.nonzero((flat_e == j) & flat_keep).squeeze(-1)
        if sel.numel() == 0:
            continue
        tok = tok_of[sel]
        xe = x[tok]

        def lin(name, z):
            ad = ads.get(name)
            w = {"w": p[name]["w"][j]}
            return linear(z, w, None if ad is None else (ad[0][j], ad[1][j]), fp8)

        he = F.silu(lin("wgate", xe)) * lin("wup", xe)
        y = y.index_add(0, tok, lin("wdown", he) * gate_of[sel][:, None])
    top1 = torch.bincount(experts[:, 0], minlength=e).float() / t
    aux = e * torch.sum(top1 * probs.mean(dim=0))
    return y, aux


def layer(arch: Arch, p: dict, ads: dict, h: torch.Tensor, pos: torch.Tensor, fp8: bool):
    """One decoder layer on h (B, S, D): (h, aux or a zero)."""
    b, s, d = h.shape
    hd = arch.head_dim
    x = rms_norm(h, p["attn_norm"], arch.norm_eps)
    q = linear(x, p["wq"], ads.get("wq"), fp8).view(b, s, -1, hd)
    k = linear(x, p["wk"], ads.get("wk"), fp8).view(b, s, -1, hd)
    v = linear(x, p["wv"], ads.get("wv"), fp8).view(b, s, -1, hd)
    if arch.qk_norm:
        q = rms_norm(q, p["q_norm"], arch.norm_eps)
        k = rms_norm(k, p["k_norm"], arch.norm_eps)
    q, k = rope(q, pos, arch.rope_theta), rope(k, pos, arch.rope_theta)
    o = attention(q, k, v).reshape(b, s, -1)
    h = h + linear(o, p["wo"], ads.get("wo"), fp8)
    x = rms_norm(h, p["mlp_norm"], arch.norm_eps)
    if arch.experts:
        y, aux = moe(arch, p, ads, x.reshape(b * s, d), fp8)
        return h + y.view(b, s, d), aux
    y = linear(F.silu(linear(x, p["wgate"], ads.get("wgate"), fp8))
               * linear(x, p["wup"], ads.get("wup"), fp8), p["wdown"], ads.get("wdown"), fp8)
    return h + y, torch.zeros((), device=h.device)


def layer_adapters(adapters: dict | None, i: int) -> dict:
    """Layer i's ``{name: (idx, val)}`` from ``{path: (idx, val)}``."""
    out = {}
    for path, (idx, val) in (adapters or {}).items():
        if path[0] == "blocks":
            out[path[1]] = (idx[i], val[i])
    return out


def hidden(arch: Arch, W: Weights, adapters: dict | None, tokens: torch.Tensor,
           remat: bool = False):
    """Final normed hidden states (B, S, D) of tokens (B, S) and the mean
    auxiliary loss over the layers. ``remat`` recomputes each layer in the
    backward (the reference's memory, not its values)."""
    h = W.tree["embed"]["w"][tokens.long()]
    pos = torch.arange(tokens.shape[1], device=h.device)
    aux = torch.zeros((), device=h.device)
    for i in range(arch.layers):
        p, ads = W.layer(i), layer_adapters(adapters, i)
        if remat:
            h, a = checkpoint(layer, arch, p, ads, h, pos, W.fp8, use_reentrant=False)
        else:
            h, a = layer(arch, p, ads, h, pos, W.fp8)
        aux = aux + a
    return rms_norm(h, W.tree["final_norm"], arch.norm_eps), aux / arch.layers


def logits(arch: Arch, W: Weights, adapters: dict | None, h: torch.Tensor) -> torch.Tensor:
    """Logits over the real vocabulary of hidden states h (..., D)."""
    x = _act(h, W.fp8)
    if arch.tied:
        out = x @ W.head_t.T
    else:
        out = x @ W.tree["head"]["w"]
        ad = (adapters or {}).get(("head", "w"))
        if ad is not None:
            out = out + bypass(h, *ad)
    return out[..., :arch.vocab]


def loss(arch: Arch, W: Weights, adapters: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy, mean over every (row, position) but the
    last, plus the router's auxiliary loss."""
    h, aux = hidden(arch, W, adapters, tokens, remat=True)
    lg = logits(arch, W, adapters, h[:, :-1])
    ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1).long())
    return ce + arch.aux_coef * aux

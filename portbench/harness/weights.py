"""Weights made from the seed, on the device, in the type they are run
in, handed alike to the program and the reference.

The tree follows the program's layout (``W (d_in, d_out)`` with ``y = x @
W``, per-layer leaves stacked on a leading layer axis): ``embed``,
``blocks`` (norms, ``wq``/``wk``/``wv``/``wo``, the MLP or the router and
expert stacks), ``final_norm`` and, untied, ``head``. Every normal draw
comes from one ``torch.Generator`` in one call into a single buffer; each
leaf is a view of it, scaled in place (``d_in ** -0.5`` for a matrix, 0.02
for the embedding and the biases). Norm weights are ones.
"""

from __future__ import annotations

import math

import torch

from .arch import Arch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _plan(arch: Arch) -> list[tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every normal leaf."""
    L, D, V = arch.layers, arch.d_model, arch.padded_vocab
    out = [(("embed", "w"), (V, D), 0.02)]
    for name, shape in arch.linear_shapes().items():
        out.append((("blocks", name, "w"), (L, *shape), shape[-2] ** -0.5))
        if arch.qkv_bias and name in ("wq", "wk", "wv"):
            out.append((("blocks", name, "b"), (L, shape[-1]), 0.02))
    if not arch.tied:
        out.append((("head", "w"), (D, V), D**-0.5))
    return out


def _put(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def make_params(arch: Arch, seed: int, device) -> dict:
    dt = DTYPES[arch.dtype]
    plan = _plan(arch)
    total = sum(math.prod(s) for _, s, _ in plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=dt)
    tree: dict = {}
    at = 0
    for path, shape, scale in plan:
        n = math.prod(shape)
        _put(tree, path, buf[at:at + n].view(shape).mul_(scale))
        at += n
    L, D = arch.layers, arch.d_model
    ones = torch.ones(2 * L * D + D + (2 * L * arch.head_dim if arch.qk_norm else 0),
                      device=device, dtype=dt)
    tree["blocks"]["attn_norm"] = ones[:L * D].view(L, D)
    tree["blocks"]["mlp_norm"] = ones[L * D:2 * L * D].view(L, D)
    tree["final_norm"] = ones[2 * L * D:2 * L * D + D]
    if arch.qk_norm:
        rest = ones[2 * L * D + D:].view(2, L, arch.head_dim)
        tree["blocks"]["q_norm"], tree["blocks"]["k_norm"] = rest[0], rest[1]
    return tree


def adapted(arch: Arch) -> list[tuple]:
    """Paths of the matrices NeuroAda adapts: every ``blocks`` linear but
    the router, and an untied head."""
    out = [("blocks", n, "w") for n in arch.linear_shapes() if n != "router"]
    return out + ([] if arch.tied else [("head", "w")])


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def magnitude_indices(w: torch.Tensor, k: int) -> torch.Tensor:
    """The k rows of largest |w| in each column of ``w`` (..., d_in,
    d_out), largest first, ties to the lower row: (..., k, d_out) int64.
    One layer (or expert stack) at a time, so the sort's copy stays small."""
    if w.ndim > 3:
        return torch.stack([magnitude_indices(w[i], k) for i in range(w.shape[0])])
    a = w.float().abs()
    if k == 1:  # argmax returns the first of equal maxima
        return a.argmax(dim=-2, keepdim=True)
    return torch.sort(a, dim=-2, descending=True, stable=True).indices[..., :k, :]


def unique_rows(indices: dict, k: int, arch: Arch) -> dict:
    """Distinct input rows the indices ``{path: idx}`` name, for the
    roofline's bytes: ``{"k": k, name: [one count a layer], "head":
    [count]}``; an expert stack's entry holds a list of counts a layer, one
    an expert."""
    out: dict = {"k": k}
    for path in adapted(arch):
        idx = indices[path]
        name = path[1] if path[0] == "blocks" else "head"
        if path[0] != "blocks":
            out[name] = [int(torch.unique(idx).numel())]
        elif idx.ndim == 4:
            out[name] = [[int(torch.unique(idx[i, e]).numel()) for e in range(idx.shape[1])]
                         for i in range(idx.shape[0])]
        else:
            out[name] = [int(torch.unique(idx[i]).numel()) for i in range(idx.shape[0])]
    return out

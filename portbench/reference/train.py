"""The reference of a NeuroAda training cell's first steps (the paper's
Alg. 1): selection of the k largest |w| of every neuron's inputs, then
AdamW on the bypass values alone, everything in float32.

AdamW as the configuration states it: moments from zero, bias
corrections ``1 - b ** t``, ``u = m̂ / (sqrt(v̂) + eps)`` plus weight
decay, ``value -= lr · u``, after clipping the gradients to a global norm.
"""

from __future__ import annotations

import torch

from portbench.harness.weights import adapted, get, magnitude_indices
from portbench.reference import model as ref


def select(arch, params: dict, k: int) -> dict:
    """``{path: idx (..., k, d_out)}`` of every adapted matrix."""
    return {p: magnitude_indices(get(params, p), k) for p in adapted(arch)}


def leaves(arch, tree: dict) -> dict:
    """``{name: tensor}`` of a per-path tree cut into one leaf a layer (and
    the head): ``blocks/wq/w[3]`` is one leaf."""
    out = {}
    for path, t in tree.items():
        if path[0] == "blocks":
            for i in range(t.shape[0]):
                out[f"{'/'.join(path)}[{i}]"] = t[i]
        else:
            out["/".join(path)] = t
    return out


def steps(arch, params: dict, batches: list, opt: dict, *, k: int, n_steps: int = 3,
          precision: str = "fp32", half_batch: bool = False) -> dict:
    """Run ``n_steps`` steps on ``batches`` (numpy ``tokens`` (B, S)).
    Returns ``indices`` ({path: idx}), ``losses`` (one a step), ``grad``
    (the clipped first gradient: {leaf: norm}) and ``change`` (the values
    after the last step: {leaf: norm}). ``half_batch`` leaves out the second
    half of every batch's rows (a planted fault)."""
    ref.no_tf32()
    dev = get(params, ("embed", "w")).device
    W = ref.Weights(arch, params, precision)
    idx = select(arch, params, k)
    vals = {p: torch.zeros(i.shape, device=dev, requires_grad=True) for p, i in idx.items()}
    mu = {p: torch.zeros_like(v) for p, v in vals.items()}
    nu = {p: torch.zeros_like(v) for p, v in vals.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad = [], None
    for t in range(1, n_steps + 1):
        tokens = torch.as_tensor(batches[t - 1]["tokens"], device=dev)
        if half_batch:
            tokens = tokens[: tokens.shape[0] // 2]
        adapters = {p: (idx[p], vals[p]) for p in idx}
        lv = ref.loss(arch, W, adapters, tokens)
        grads = torch.autograd.grad(lv, [vals[p] for p in idx])
        losses.append(float(lv.detach()))
        grads = dict(zip(idx, grads))
        if opt["grad_clip"] > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(opt["grad_clip"] / norm.clamp(min=1e-9), max=1.0)
            grads = {p: g * scale for p, g in grads.items()}
        if t == 1:
            first_grad = {n: float(g.norm()) for n, g in leaves(arch, grads).items()}
        lr = opt["lr"]
        with torch.no_grad():
            for p in idx:
                g = grads[p]
                mu[p] = b1 * mu[p] + (1 - b1) * g
                nu[p] = b2 * nu[p] + (1 - b2) * g * g
                u = (mu[p] / (1 - b1**t)) / (torch.sqrt(nu[p] / (1 - b2**t)) + eps)
                if wd:
                    u = u + wd * vals[p]
                vals[p] -= lr * u
    change = {n: float(v.norm()) for n, v in leaves(arch, {p: v.detach() for p, v in
                                                           vals.items()}).items()}
    return {"indices": idx, "losses": losses, "grad": first_grad, "change": change}

"""AdamW over nested-dict trees (``None``-leaf aware), float32 moments.

Port of ``repro.optim.adamw`` as written, so values follow the reference
step by step: moments in float32 even for bf16 values, bias corrections
``1 - b**step`` in float32, ``u = m̂ / (sqrt(v̂) + eps)`` with weight decay
added to ``u``, the update ``-lr · u`` cast to the value's dtype and
applied as ``p + u`` in that dtype — no float32 master copy. (Not
``torch.optim.AdamW``, whose order of operations and rounding differ.)

For NeuroAda the tree holds only the ``(…, k, d_out)`` values, so the
moments are k/d_in the size of dense states (paper Eq. 5–6).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import flatten, map_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: object
    nu: object


def _map(f, *trees):
    return map_leaves(lambda *xs: None if xs[0] is None else f(*xs), *trees)


def _leaves(tree) -> list[torch.Tensor]:
    return [x for _, x in flatten(tree) if x is not None]


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> AdamW:
    """``lr`` is a float or a schedule ``step -> float32 tensor``, evaluated
    at the update's step count (1 on the first update)."""

    def lr_fn(step):
        if callable(lr):
            return lr(step)
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    def init(params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        dev = _leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          _map(zeros, params), _map(zeros, params))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        stepf = step.float()
        mu = _map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state.mu)
        nu = _map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()), grads, state.nu)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        lr_t = lr_fn(step)

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return _map(upd, params, mu, nu), AdamWState(step, mu, nu)

    return AdamW(init, update)


def apply_updates(params, updates):
    return _map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm

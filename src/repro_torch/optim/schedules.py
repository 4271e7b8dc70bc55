"""Learning-rate schedules (port of ``repro.optim.schedules``). The paper
uses linear warm-up + linear decay (Tables 5–7). Each schedule maps an
int step tensor to a float32 tensor, computed in float32 as the
reference does."""

from __future__ import annotations

import math

import torch


def linear_warmup_linear_decay(peak: float, total_steps: int, warmup_ratio: float = 0.06):
    warmup = max(int(total_steps * warmup_ratio), 1)

    def fn(step):
        step = step.float()
        up = step / warmup
        down = torch.clamp(total_steps - step, min=0.0) / max(total_steps - warmup, 1)
        return peak * torch.minimum(up, down).clamp(0.0, 1.0)

    return fn


def cosine(peak: float, total_steps: int, warmup_ratio: float = 0.06, floor: float = 0.0):
    warmup = max(int(total_steps * warmup_ratio), 1)

    def fn(step):
        step = step.float()
        up = step / warmup
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(step < warmup, up, cos)

    return fn


def constant(peak: float):
    def fn(step):
        return torch.full((), peak, dtype=torch.float32, device=step.device)

    return fn


def get_schedule(name: str, peak: float, total_steps: int, warmup_ratio: float):
    if name == "linear":
        return linear_warmup_linear_decay(peak, total_steps, warmup_ratio)
    if name == "cosine":
        return cosine(peak, total_steps, warmup_ratio)
    if name == "constant":
        return constant(peak)
    raise ValueError(f"unknown schedule {name!r}")

"""What one run of a cell leaves for the per-layer readers, the judge and
the result line."""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class RunRecord:
    kind: str  # the mix's kind: train
    arch: Any
    mix: dict
    seed: int
    window: tuple[float, float]  # host clock (time.perf_counter) at open and close
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Any = None  # a DeviceTrace of the window, or None
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)
    step_s: list = field(default_factory=list)  # host seconds of each step in the window
    program: dict = field(default_factory=dict)  # the program's outputs the judge reads
    inputs: dict = field(default_factory=dict)  # what the reference is handed
    train: dict = field(default_factory=dict)  # the training window's own readings

    def ops(self):
        """The device operations of the window, cut to it (None untraced)."""
        if self.trace is None:
            return None
        from .devtrace import clip

        return clip(self.trace.ops, *self.window)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (0 on the CPU)."""
    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

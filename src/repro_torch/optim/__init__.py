"""Port of ``repro.optim``: AdamW with float32 moments, learning-rate
schedules, global-norm clipping."""

from repro_torch.optim.adamw import (
    AdamW,
    AdamWState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import get_schedule

__all__ = [
    "AdamW",
    "AdamWState",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "get_schedule",
    "global_norm",
]

"""Port of ``repro.data``: synthetic tasks and the prefetching loader."""

from repro_torch.data.loader import DataLoader, peek_batch
from repro_torch.data.synthetic import TASKS

__all__ = ["DataLoader", "TASKS", "peek_batch"]

"""Port of ``repro.distributed`` (fault tolerance only)."""

from repro_torch.distributed.fault import NanGuard, StragglerMonitor

__all__ = ["NanGuard", "StragglerMonitor"]

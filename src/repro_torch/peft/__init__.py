"""Port of ``repro.peft`` (adapter export/load)."""

from repro_torch.peft.api import export_adapter, load_adapter

__all__ = ["export_adapter", "load_adapter"]

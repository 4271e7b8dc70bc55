"""Port of ``repro.peft``: NeuroAda for the trainer, adapter export/load."""

from repro_torch.peft.api import (
    METHODS,
    Peft,
    count_params,
    export_adapter,
    get_peft,
    load_adapter,
    neuroada,
    stats,
)

__all__ = ["METHODS", "Peft", "count_params", "export_adapter", "get_peft",
           "load_adapter", "neuroada", "stats"]

"""Port of ``repro.peft``: NeuroAda and the paper's baselines (LoRA /
QLoRA, BitFit, mask-based sparse, full fine-tuning) for the trainer,
adapter export/load, the quantized base."""

from repro_torch.peft.api import (
    BASE_DTYPES,
    METHODS,
    Peft,
    count_params,
    export_adapter,
    get_peft,
    load_adapter,
    neuroada,
    quantize_base,
    stats,
)

__all__ = ["BASE_DTYPES", "METHODS", "Peft", "count_params", "export_adapter", "get_peft",
           "load_adapter", "neuroada", "quantize_base", "stats"]

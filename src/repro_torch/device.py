"""Device resolution for the port's entry points.

Entry points (``ServeEngine``, ``launch/serve.py``, model init) run on the
card unless the caller names another device. Without CUDA they raise
rather than carry on quietly on the CPU: the CPU path exists for tests,
which ask for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev

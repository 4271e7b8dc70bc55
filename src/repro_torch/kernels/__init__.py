"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions and their launch counters.

| kernel | replaces (TPU, Pallas) | CUDA source |
| --- | --- | --- |
| ``sparse_delta_batched`` | ``sparse_delta.py::sparse_delta_batched_pallas`` | ``csrc/sparse_delta.cu`` |
| ``paged_decode_attention`` | ``decode_attention.py::paged_decode_attention_pallas`` | ``csrc/decode_attention.cu`` |
| ``paged_prefill_attention`` | ``prefill_attention.py::paged_prefill_attention_pallas`` | ``csrc/prefill_attention.cu`` |

A wrapper launches its kernel for CUDA tensors and uses the plain version
for CPU tensors; there is no backend switch.
"""

from repro_torch.kernels import decode_attention, prefill_attention, sparse_delta

KERNEL_MODULES = (sparse_delta, decode_attention, prefill_attention)
COUNTERS = {m.counter.name: m.counter for m in KERNEL_MODULES}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = ["COUNTERS", "KERNEL_MODULES", "reset_counters"]

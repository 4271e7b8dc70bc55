"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their launch counters.

| kernel | replaces (TPU, Pallas) | CUDA source |
| --- | --- | --- |
| ``sparse_delta_batched`` | ``sparse_delta.py::sparse_delta_batched_pallas`` | ``csrc/sparse_delta.cu`` |
| ``paged_decode_attention`` | ``decode_attention.py::paged_decode_attention_pallas`` | ``csrc/decode_attention.cu`` |
| ``paged_prefill_attention`` | ``prefill_attention.py::paged_prefill_attention_pallas`` | ``csrc/prefill_attention.cu`` |
| ``fused_linear`` | ``fused_linear.py::fused_linear_pallas`` | ``csrc/fused_linear.cu`` |
| ``sparse_delta_dval`` | ``sparse_delta.py::sparse_delta_dval_pallas`` | ``csrc/sparse_delta_dval.cu`` |

The first three carry serving, the last two training. A wrapper launches
its kernel for CUDA tensors and uses the plain version for CPU tensors;
there is no backend switch.
"""

from repro_torch.kernels import decode_attention, fused_linear, prefill_attention, sparse_delta

SERVING = ("sparse_delta_batched", "paged_decode_attention", "paged_prefill_attention")
TRAINING = ("fused_linear", "sparse_delta_dval")
COUNTERS = {c.name: c for c in (sparse_delta.counter, decode_attention.counter,
                                prefill_attention.counter, fused_linear.counter,
                                sparse_delta.dval_counter)}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = ["COUNTERS", "SERVING", "TRAINING", "reset_counters"]

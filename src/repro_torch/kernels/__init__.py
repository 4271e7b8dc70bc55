"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their launch counters.

| kernel | replaces (TPU, Pallas) | CUDA source |
| --- | --- | --- |
| ``sparse_delta_batched`` | ``sparse_delta.py::sparse_delta_batched_pallas`` | ``csrc/sparse_delta.cu`` |
| ``paged_decode_attention`` | ``decode_attention.py::paged_decode_attention_pallas`` | ``csrc/decode_attention.cu`` |
| ``paged_prefill_attention`` | ``prefill_attention.py::paged_prefill_attention_pallas`` | ``csrc/prefill_attention.cu`` |
| ``fused_linear`` | ``fused_linear.py::fused_linear_pallas`` | ``csrc/fused_linear.cu`` |
| ``sparse_delta_dval`` | ``sparse_delta.py::sparse_delta_dval_pallas`` | ``csrc/sparse_delta_dval.cu`` |
| ``fused_linear_q`` | ``quant_linear.py::fused_linear_q_pallas`` | ``csrc/fused_linear_q.cu`` |

The first three carry serving, the next two training; ``fused_linear_q``
carries both on a packed (int8 or NF4) base: it takes the place of
``fused_linear`` in training and of the plain ``x @ W`` base matmuls in
serving. A wrapper launches its kernel for CUDA tensors and uses the plain
version for CPU tensors; there is no backend switch.
"""

from repro_torch.kernels import (
    decode_attention,
    fused_linear,
    prefill_attention,
    quant_linear,
    sparse_delta,
)

SERVING = ("sparse_delta_batched", "paged_decode_attention", "paged_prefill_attention")
TRAINING = ("fused_linear", "sparse_delta_dval")
PACKED_BASE = ("fused_linear_q",)
COUNTERS = {c.name: c for c in (sparse_delta.counter, decode_attention.counter,
                                prefill_attention.counter, fused_linear.counter,
                                sparse_delta.dval_counter, quant_linear.counter)}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = ["COUNTERS", "PACKED_BASE", "SERVING", "TRAINING", "reset_counters"]

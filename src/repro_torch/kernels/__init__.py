"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their launch counters.

| kernel | replaces (TPU, Pallas) | CUDA source |
| --- | --- | --- |
| ``sparse_delta_batched`` | ``sparse_delta.py::sparse_delta_batched_pallas`` | ``csrc/sparse_delta.cu`` |
| ``paged_decode_attention`` | ``decode_attention.py::paged_decode_attention_pallas`` | ``csrc/decode_attention.cu`` |
| ``paged_decode_attention_q`` | its int8 body ``_paged_decode_attn_q_kernel`` | ``csrc/decode_attention.cu`` |
| ``paged_prefill_attention`` | ``prefill_attention.py::paged_prefill_attention_pallas`` | ``csrc/prefill_attention.cu`` |
| ``paged_prefill_attention_q`` | its int8 body ``_paged_prefill_attn_q_kernel`` | ``csrc/prefill_attention.cu`` |
| ``decode_attention`` | ``decode_attention.py::decode_attention_pallas`` (``_decode_attn_kernel``) | ``csrc/dense_decode_attention.cu`` |
| ``decode_attention_q`` | its int8 body ``_decode_attn_q_kernel`` | ``csrc/dense_decode_attention.cu`` |
| ``fused_linear`` | ``fused_linear.py::fused_linear_pallas`` | ``csrc/fused_linear.cu`` |
| ``sparse_delta_dval`` | ``sparse_delta.py::sparse_delta_dval_pallas`` | ``csrc/sparse_delta_dval.cu`` |
| ``sparse_delta`` | ``sparse_delta.py::sparse_delta_pallas`` | ``csrc/sparse_delta.cu`` |
| ``fused_linear_q`` | ``quant_linear.py::fused_linear_q_pallas`` | ``csrc/fused_linear_q.cu`` |

``SERVING`` carries the default paged engine with an fp KV cache; the
attention bodies of the other cache layouts and dtypes stand in
``ATTENTION`` under their ``(paged, kv_dtype)``; ``TRAINING`` carries
training; ``SINGLE_TENANT`` (``sparse_delta``) joins it where training
adapts an untied head or expert stacks (the MoE family); ``fused_linear_q`` carries both on a packed (int8 or NF4) base: it
takes the place of ``fused_linear`` in training and of the plain ``x @ W``
base matmuls in serving. A wrapper launches its kernel for CUDA tensors and
uses the plain version for CPU tensors; there is no backend switch.
"""

from repro_torch.kernels import (
    decode_attention,
    dense_decode_attention,
    fused_linear,
    prefill_attention,
    quant_linear,
    sparse_delta,
)

SERVING = ("sparse_delta_batched", "paged_decode_attention", "paged_prefill_attention")
# the attention kernels a serving run launches, by (paged, kv_dtype); the
# dense engine's mixed steps attend with plain dense attention, as the
# reference's do (no kernel there)
ATTENTION = {
    (True, "fp32"): ("paged_decode_attention", "paged_prefill_attention"),
    (True, "int8"): ("paged_decode_attention_q", "paged_prefill_attention_q"),
    (False, "fp32"): ("decode_attention",),
    (False, "int8"): ("decode_attention_q",),
}
TRAINING = ("fused_linear", "sparse_delta_dval")
SINGLE_TENANT = ("sparse_delta",)
PACKED_BASE = ("fused_linear_q",)
COUNTERS = {c.name: c for c in (sparse_delta.counter, decode_attention.counter,
                                decode_attention.q_counter, prefill_attention.counter,
                                prefill_attention.q_counter, dense_decode_attention.counter,
                                dense_decode_attention.q_counter, fused_linear.counter,
                                sparse_delta.dval_counter, sparse_delta.delta_counter,
                                quant_linear.counter)}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = ["ATTENTION", "COUNTERS", "PACKED_BASE", "SERVING", "SINGLE_TENANT", "TRAINING",
           "reset_counters"]

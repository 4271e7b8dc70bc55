from repro_torch.quant.qtensor import (
    DEFAULT_QUANT_EXCLUDE,
    NF4_CODES,
    QDTYPES,
    QuantizedTensor,
    any_quantized,
    dequantize,
    dequantize_tree,
    is_linear_weight,
    quantize,
    quantize_tree,
    tree_bytes,
    unpack_nf4,
)

__all__ = [
    "DEFAULT_QUANT_EXCLUDE",
    "NF4_CODES",
    "QDTYPES",
    "QuantizedTensor",
    "any_quantized",
    "dequantize",
    "dequantize_tree",
    "is_linear_weight",
    "quantize",
    "quantize_tree",
    "tree_bytes",
    "unpack_nf4",
]

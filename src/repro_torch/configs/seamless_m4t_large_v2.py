"""seamless-m4t-large-v2 [audio]: enc-dec backbone, 24L d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

Backbone only: the speech frontend is a stub — ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, d_model). 24 encoder + 24 decoder
layers. vocab 256206 is padded to 256256 (÷128) for TP sharding
(DESIGN.md §2.4).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
)

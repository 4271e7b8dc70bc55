"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub — ``input_specs()`` provides
precomputed patch embeddings plus 3-D (t,h,w) M-RoPE position ids.
mrope sections (16, 24, 24) cover the 64 rotary frequency pairs of the
128-wide heads.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    mrope_sections=(16, 24, 24),
    image_frac=0.25,
    rope_theta=1_000_000.0,
)

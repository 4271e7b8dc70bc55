"""zamba2-2.7b [hybrid]: Mamba2 trunk + shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]. Shared attention block applied every 6 ssm blocks
(9 applications over 54 layers), weight-tied across sites.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
)

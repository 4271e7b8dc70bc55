"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,  # attn-free, no MLP: mamba blocks only
    vocab_size=65024,
    ssm_state=16,
    conv_width=4,
)

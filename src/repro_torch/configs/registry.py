"""--arch registry: 10 assigned architectures + the paper's own models.

``get_config(arch_id)`` returns the exact published config;
``reduced(cfg)`` returns a CPU-smoke-sized member of the same family
(small layers/width/experts/vocab — used by tests; the FULL configs are
exercised only via the dry-run, which never allocates).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_is_runnable

_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "qwen2.5-3b": "repro_torch.configs.qwen2p5_3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3p5_moe",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _MODULES:
        return importlib.import_module(_MODULES[arch_id]).CONFIG
    if arch_id in _PAPER:
        return _PAPER[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + tuple(_PAPER)}")


# The paper's own evaluation models (Tables 2–4), as additional configs.
_PAPER = {
    "llama-7b": ModelConfig(
        name="llama-7b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=32000,
    ),
    "llama-13b": ModelConfig(
        name="llama-13b", family="dense", num_layers=40, d_model=5120,
        num_heads=40, num_kv_heads=40, d_ff=13824, vocab_size=32000,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
        rope_theta=500_000.0,
    ),
}

PAPER_ARCH_IDS = tuple(_PAPER)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, CPU-sized: for smoke tests and examples."""
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_head_dim=16, d_inner=128, dt_rank=8, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(attn_every=1, num_layers=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.family == "vlm":
        kw.update(mrope_sections=(2, 3, 3))  # covers head_dim 16 -> 8 pairs
    return cfg.replace(**kw)


def all_cells() -> list[tuple[str, str, bool, str]]:
    """(arch_id, shape_name, runnable, skip_reason) for the 40-cell matrix."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_is_runnable(cfg, s)
            out.append((a, s.name, ok, why))
    return out


__all__ = [
    "ARCH_IDS",
    "PAPER_ARCH_IDS",
    "SHAPES",
    "ShapeConfig",
    "all_cells",
    "get_config",
    "reduced",
]

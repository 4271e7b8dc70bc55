"""Config system: one frozen dataclass covers every assigned architecture.

Families: dense | moe | ssm | hybrid | encdec | vlm. Every field is plain
data so configs hash/serialise cleanly (checkpoint metadata, dry-run cache
keys).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class PeftConfig:
    method: str = "neuroada"  # neuroada | lora | bitfit | masked | full | none
    k: int = 1  # NeuroAda top-k per neuron
    strategy: str = "magnitude"  # magnitude | gradient | reverse | random
    lora_rank: int = 8
    lora_alpha: float = 16.0
    delta_dtype: str = "bfloat16"  # paper stores BF16 deltas


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (mamba1/mamba2) ---
    ssm_state: int = 0
    d_inner: int = 0  # 0 -> 2*d_model
    conv_width: int = 4
    ssm_head_dim: int = 64  # mamba2 heads = d_inner // ssm_head_dim
    dt_rank: int = 0  # mamba1; 0 -> ceil(d_model/16)
    # chunked-scan length (TPU adaptation, DESIGN §2.1). 1024 won the §Perf
    # sweep (-36…53% HBM traffic vs 256: per-chunk-step overheads dominate).
    ssm_chunk: int = 1024
    # --- hybrid (zamba2) ---
    attn_every: int = 0  # shared attention block applied every N ssm blocks
    # --- encdec ---
    encoder_layers: int = 0
    # --- vlm ---
    mrope_sections: tuple[int, int, int] = ()
    image_frac: float = 0.25  # fraction of sequence that is patch embeddings
    # --- attention memory policy ---
    flash_block: int = 512
    flash_threshold: int = 2048  # use chunked online-softmax at/above this S
    sliding_window: int = 0  # 0 = full attention

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple so TP-16 sharding always divides."""
        return _round_up(self.vocab_size, 128)

    @property
    def ssm_heads(self) -> int:
        return self.resolved_d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic/O(1)-state decode families only (DESIGN §4)."""
        return self.family in ("ssm", "hybrid")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-3  # paper Table 5 best for top-1
    weight_decay: float = 0.0  # paper: {0}
    warmup_ratio: float = 0.06
    schedule: str = "linear"  # paper: linear
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    steps: int = 1000
    microbatches: int = 1  # gradient accumulation
    remat: str = "none"  # none | full | dots
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = ""
    log_every: int = 10
    nan_guard: bool = True
    max_skipped_steps: int = 50


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The 40-cell matrix with documented skips (DESIGN.md §4)."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, (
            "long_500k skipped: full-attention arch has no sub-quadratic "
            "decode state (DESIGN.md §4)"
        )
    return True, ""

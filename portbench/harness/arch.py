"""A model configuration file (``portbench/configs/<name>.json``, the
published ``config.json`` keys plus what it leaves unsaid) read into the
sizes the weights, the reference and the roofline arithmetic share.

Besides the published keys a file states three of its own, each required:
``family`` (the program's model family: ``dense`` or ``moe``),
``qkv_bias`` (q, k and v carry a bias) and ``qk_norm`` (q and k pass an
RMSNorm over each head before the rotary embedding).

Nothing here imports the program: the reference and the yardstick read an
:class:`Arch`, and only :func:`portbench.harness.program.model_config`
turns one into the program's own config object.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

OWN_KEYS = ("family", "qkv_bias", "qk_norm")


@dataclass(frozen=True)
class Arch:
    name: str
    family: str
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool
    qkv_bias: bool
    qk_norm: bool
    norm_eps: float
    rope_theta: float
    dtype: str
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 128) * 128

    def linear_shapes(self) -> dict[str, tuple[int, ...]]:
        """Every matrix of one layer as (*stack, d_in, d_out), the router
        included; the head (untied) under ``head``."""
        D, F, hd = self.d_model, self.d_ff, self.head_dim
        st = (self.experts,) if self.experts else ()
        out = {"wq": (D, self.heads * hd), "wk": (D, self.kv_heads * hd),
               "wv": (D, self.kv_heads * hd), "wo": (self.heads * hd, D),
               "wgate": (*st, D, F), "wup": (*st, D, F), "wdown": (*st, F, D)}
        if self.experts:
            out["router"] = (D, self.experts)
        return out


def load(path: str | Path) -> Arch:
    cfg = json.loads(Path(path).read_text())
    missing = [k for k in OWN_KEYS if k not in cfg]
    if missing:
        raise KeyError(f"{path}: the configuration does not state {missing}")
    heads = cfg["num_attention_heads"]
    return Arch(
        name=Path(path).stem, family=cfg["family"], layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], heads=heads,
        kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        tied=bool(cfg.get("tie_word_embeddings", False)), qkv_bias=bool(cfg["qkv_bias"]),
        qk_norm=bool(cfg["qk_norm"]),
        norm_eps=float(cfg["rms_norm_eps"]), rope_theta=float(cfg["rope_theta"]),
        dtype=cfg["torch_dtype"], experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        capacity_factor=float(cfg.get("capacity_factor", 1.25)),
        aux_coef=float(cfg.get("router_aux_loss_coef", 0.0)) if cfg.get("num_experts") else 0.0,
    )


def capacity(arch: Arch, tokens: int) -> int:
    """Buffer rows an expert holds for a routing group of ``tokens``."""
    c = int(-(-tokens * arch.top_k * arch.capacity_factor // arch.experts))
    return max(c, arch.top_k)


def num_groups(t: int, kk: int, groups: int = 32) -> int:
    """Routing groups of ``t`` tokens: halve ``groups`` until it divides
    ``t`` with at least ``kk`` tokens a group (1 at the end)."""
    g = groups
    while t % g or (t // g) < kk:
        g //= 2
        if g <= 1:
            return 1
    return g

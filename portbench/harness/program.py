"""The one place the harness reaches into the program (``repro_torch``):
its config object, model and NeuroAda trainer. Imported only by the
drivers, at run time."""

from __future__ import annotations

from .arch import Arch


def model_config(arch: Arch):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=arch.name, family=arch.family, num_layers=arch.layers, d_model=arch.d_model,
        d_ff=arch.d_ff, vocab_size=arch.vocab, num_heads=arch.heads,
        num_kv_heads=arch.kv_heads, head_dim=arch.head_dim, qk_norm=arch.qk_norm,
        qkv_bias=arch.qkv_bias, rope_theta=arch.rope_theta, norm_eps=arch.norm_eps,
        tie_embeddings=arch.tied, dtype=arch.dtype, num_experts=arch.experts,
        experts_per_token=arch.top_k, capacity_factor=arch.capacity_factor,
        router_aux_coef=arch.aux_coef,
    )


def trainer(arch: Arch, mix: dict, params: dict, seed: int):
    """The program's NeuroAda trainer over ``params``: selection runs here."""
    from repro_torch.configs.base import PeftConfig, TrainConfig
    from repro_torch.models import get_model
    from repro_torch.peft import get_peft
    from repro_torch.train import Trainer

    p, o = mix["peft"], mix["optimizer"]
    if o["schedule"] != "constant":
        raise ValueError("the reference follows a constant learning rate only")
    peft = get_peft(PeftConfig(method=p["method"], k=p["k"], strategy=p["strategy"]))
    tcfg = TrainConfig(learning_rate=o["lr"], weight_decay=o["weight_decay"],
                       schedule="constant", beta1=o["b1"], beta2=o["b2"], eps=o["eps"],
                       grad_clip=o["grad_clip"], microbatches=mix["microbatches"],
                       seed=seed, checkpoint_every=0, log_every=0)
    return Trainer(get_model(model_config(arch)), peft, tcfg, params)

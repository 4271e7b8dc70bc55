"""Tiny configurations of the benchmark's two families, for CPU tests."""

from portbench.harness.arch import Arch

DENSE = Arch(name="tiny-qwen2", family="dense", layers=2, d_model=64, heads=4, kv_heads=2,
             head_dim=16, d_ff=128, vocab=512, tied=True, qkv_bias=True, qk_norm=False,
             norm_eps=1e-6, rope_theta=1e6, dtype="float32")
MOE = Arch(name="tiny-olmoe", family="moe", layers=2, d_model=64, heads=4, kv_heads=4,
           head_dim=16, d_ff=32, vocab=512, tied=False, qkv_bias=False, qk_norm=True,
           norm_eps=1e-5, rope_theta=1e4, dtype="float32", experts=8, top_k=2,
           capacity_factor=1.25, aux_coef=0.01)

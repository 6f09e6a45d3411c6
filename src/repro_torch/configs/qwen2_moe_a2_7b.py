"""Qwen1.5-MoE-A2.7B [moe] — 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts are padded to 64 dispatch slots for mesh divisibility
(router logits for the 4 pad slots are masked to -inf); the 4 shared
experts are fused into one always-on FFN of width 4*1408 (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    qkv_bias=True,
    moe=True, n_experts=60, n_experts_padded=64, top_k=4,
    shared_expert_ff=4 * 1408,
    act="silu", gated_ffn=True,
    notes="Full attention -> long_500k skipped.",
))

"""Mixtral-8x7B [moe] — 8 experts top-2, SWA 4096 [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    window=4096,
    moe=True, n_experts=8, n_experts_padded=8, top_k=2,
    act="silu", gated_ffn=True, rope_theta=1e6,
    notes="SWA window 4096 -> sub-quadratic decode; long_500k runs.",
))

"""Hymba-1.5B [hybrid] — parallel attention + mamba heads per layer
[arXiv:2411.13676].  SWA on the attention path + SSM state -> sub-quadratic;
long_500k runs.  25 heads are not divisible by the model-axis size, so
EinDecomp shards the FFN hidden / sequence labels instead (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024,
    block_pattern=("hymba",),
    ssm_state=16,
    act="silu", gated_ffn=True,
))

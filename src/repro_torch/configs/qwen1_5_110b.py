"""Qwen1.5-110B [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064,
    qkv_bias=True,
    act="silu", gated_ffn=True,
))

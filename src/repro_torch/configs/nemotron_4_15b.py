"""Nemotron-4-15B [dense] — GQA kv=8, squared-ReLU FFN [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    act="relu2", gated_ffn=False,
))

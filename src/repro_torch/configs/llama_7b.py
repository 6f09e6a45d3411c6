"""LLaMA-7B — the paper's own Experiment 3/4 subject [arXiv:2302.13971]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=32000,
    act="silu", gated_ffn=True,
))

"""MiniCPM-2B [dense] — llama-like, WSD schedule [arXiv:2404.06395].
The WSD (warmup-stable-decay) schedule is wired in repro/optim/schedules."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753,
    act="silu", gated_ffn=True, tie_embeddings=True,
))

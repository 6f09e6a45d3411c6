"""Yi-9B [dense] — llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    act="silu", gated_ffn=True,
))

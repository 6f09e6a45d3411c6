"""MusicGen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a STUB: the backbone consumes
token ids over the 2048-entry codebook vocabulary directly (the brief's
"precomputed frame embeddings" are the embedding rows of those ids).
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    act="gelu", gated_ffn=False,
))

"""PaliGemma-3B [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

The SigLIP vision tower is a STUB per the brief: ``input_specs`` provides
256 precomputed patch embeddings as a prefix.  Backbone: gemma-style MQA
(kv=1), GeGLU FFN, RMSNorm.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    act="gelu", gated_ffn=True, rope_theta=1e4,
    prefix_len=256,
    notes="SigLIP frontend stubbed (patch embeddings in input_specs).",
))

"""xLSTM-125M [ssm] — alternating mLSTM / sLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections instead of a
separate FFN.  Recurrent state -> all four shapes run, incl. long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304,
    block_pattern=("mlstm", "slstm"),
    notes="mLSTM chunkwise-parallel; sLSTM lax.scan recurrence.",
))

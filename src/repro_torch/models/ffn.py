"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain (incl. squared-ReLU).

The hidden width f is the canonical "model parallel" EinSum label — the
EinGraph fragment is  h1[bsf] <- x[bsa] W1[af];  act;  y[bsa] <- h[bsf] W2[fa]
and EinDecomp discovers Megatron-style f-sharding on it (paper Exp 3).  The
projections are plain matrix products, left to torch as the reference
leaves them to XLA (``gspmd.matmul``: on DTensors, split contractions sum
in float32).
"""
from __future__ import annotations

import torch

from repro_torch.core.gspmd import matmul
from repro_torch.models.common import ParamFactory, activation


def init_ffn(pf: ParamFactory, cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    p = {"w1": pf.dense(D, F), "w2": pf.dense(F, D)}
    if cfg.gated_ffn:
        p["w3"] = pf.dense(D, F)
    return p


def ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = activation(cfg.act)
    h = matmul(x, p["w1"])
    if cfg.gated_ffn:
        h = act(h) * matmul(x, p["w3"])
    else:
        h = act(h)
    return matmul(h, p["w2"])

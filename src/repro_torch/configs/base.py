"""Model + shape configuration system.

Every assigned architecture is a ``ModelConfig`` (src/repro_torch/configs/<id>.py);
the four input shapes are ``ShapeConfig``s.  ``cfg.dtype`` stays a string
(``"bfloat16"``, ``"float32"``); :func:`torch_dtype` maps it to the torch
dtype the model stack allocates in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named by a config's ``dtype`` string."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_TORCH_DTYPES)}") from None


# ---------------------------------------------------------------------------
# Shapes (assigned set — LM transformer shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention
    window: int = 0             # sliding-window size (0 = full attention)
    qkv_bias: bool = False
    rope_theta: float = 1e4

    # ffn
    act: str = "silu"           # silu | gelu | relu2
    gated_ffn: bool = True      # SwiGLU/GeGLU vs plain 2-matrix MLP

    # MoE
    moe: bool = False
    n_experts: int = 0          # routed experts (router size)
    n_experts_padded: int = 0   # dispatch-buffer experts (mesh divisibility)
    top_k: int = 0
    shared_expert_ff: int = 0   # total hidden width of always-on shared experts
    capacity_factor: float = 1.25
    moe_groups: int = 0         # >1: group-local dispatch (EXPERIMENTS §Perf)

    # ssm / recurrent
    block_pattern: tuple[str, ...] = ("attn",)  # cycled over layers
    ssm_state: int = 0
    ssm_conv: int = 4

    # frontend stub (vlm / audio)
    prefix_len: int = 0         # patch/frame embeddings prepended (stub)

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    notes: str = ""

    # ---- derived ----------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def n_e(self) -> int:
        return self.n_experts_padded or self.n_experts

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode with bounded state?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    @property
    def uniform_blocks(self) -> bool:
        return len(set(self.block_pattern)) == 1

    def blocks(self) -> list[str]:
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def supports(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False  # pure full-attention: skipped per DESIGN.md §4
        return True

    def kv_len(self, shape: ShapeConfig) -> int:
        """KV-cache (or attention span) length for a decode shape: sliding-
        window archs keep a ring buffer of `window`, others the full seq."""
        if self.window:
            return min(self.window, shape.seq)
        return shape.seq

    # parameter count (for MODEL_FLOPS = 6 N D roofline term)
    def param_count(self, active_only: bool = False) -> int:
        D, H, K, hd, F, L = (self.d_model, self.n_heads, self.n_kv_heads,
                             self.hd, self.d_ff, self.n_layers)
        emb = self.vocab_padded * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for blk in self.blocks():
            p = 2 * D  # two norms
            if blk in ("attn", "hymba"):
                p += D * H * hd + 2 * D * K * hd + H * hd * D
                if self.qkv_bias:
                    p += (H + 2 * K) * hd
            if blk == "hymba":
                n = self.ssm_state
                di = self.d_model  # ssm inner dim
                p += D * 2 * di + di * self.ssm_conv + di * (2 * n + 1) + di * D
            if blk in ("mlstm", "slstm"):
                p += 4 * D * D + 4 * D  # q/k/v/gates projections (approx)
            if blk in ("attn", "hymba", "mlstm", "slstm") and F:
                if self.moe:
                    e = self.top_k if active_only else self.n_e
                    width = 3 if self.gated_ffn else 2
                    p += e * width * D * F + D * self.n_e  # router
                    if self.shared_expert_ff:
                        p += width * D * self.shared_expert_ff
                else:
                    p += (3 if self.gated_ffn else 2) * D * F
            per_layer += p
        return emb + per_layer + D


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


ARCH_IDS = [
    "paligemma-3b", "mixtral-8x7b", "qwen2-moe-a2.7b", "musicgen-large",
    "xlstm-125m", "minicpm-2b", "qwen1.5-110b", "nemotron-4-15b",
    "yi-9b", "hymba-1.5b",
]


def _load_all() -> None:
    import importlib

    mods = ARCH_IDS + ["llama-7b"]
    for arch in mods:
        importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


# ---------------------------------------------------------------------------
# Reduced (smoke) variants: same family/topology, tiny dims.
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    n_layers = min(cfg.n_layers, 2 * len(cfg.block_pattern))
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    if cfg.n_heads % cfg.n_kv_heads == 0 and heads % kv != 0:
        kv = 1
    return replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        n_experts_padded=min(cfg.n_e, 8) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        shared_expert_ff=64 if cfg.shared_expert_ff else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        prefix_len=min(cfg.prefix_len, 4) if cfg.prefix_len else 0,
        dtype="float32",
    )


SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 2)
SMOKE_DECODE = ShapeConfig("smoke_decode", "decode", 64, 2)

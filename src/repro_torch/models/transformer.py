"""The model stack: embedding -> blocks -> norm -> LM head.

``cfg.block_pattern`` cycles over layers; layers are grouped into *units*
of one pattern period and their parameters are stacked with a leading unit
axis, as in the reference.  A Python loop over units replaces the
reference's ``lax.scan``.  This slice of the port runs the ``attn`` block
with a dense FFN (the llama family); the MoE, hymba and xLSTM blocks raise
``NotImplementedError`` naming the slice that brings them.

Decode caches are preallocated once (``init_caches``) and written in place
by each decode step.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (ParamFactory, dtype_of, embed,
                                       lm_logits, resolve_device, rmsnorm)

_UNPORTED_BLOCKS = {
    "hymba": "the recurrent slice (models/ssm.py)",
    "mlstm": "the recurrent slice (models/xlstm.py)",
    "slstm": "the recurrent slice (models/xlstm.py)",
}


def _check_supported(cfg) -> None:
    for blk in cfg.block_pattern:
        if blk in _UNPORTED_BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: {blk!r} blocks are not ported yet; they come "
                f"with {_UNPORTED_BLOCKS[blk]}")
        if blk != "attn":
            raise ValueError(blk)
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet; they come with the "
            "MoE slice (models/moe.py and the grouped-matmul kernel)")
    if cfg.prefix_len:
        raise NotImplementedError(
            f"{cfg.name}: prefix embeddings (vlm / audio stubs) are not "
            "ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(pf: ParamFactory, cfg) -> dict:
    """One ``attn`` block's parameters."""
    p: dict[str, Any] = {"norm1": pf.ones(cfg.d_model)}
    p["attn"] = attn_mod.init_attention(pf, cfg)
    p["norm2"] = pf.ones(cfg.d_model)
    p["ffn"] = ffn_mod.init_ffn(pf, cfg)
    return p


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (default: the card; a
    ``torch.Generator`` on that device, fan-in scaled as in the reference).
    The CPU and CUDA generators give different numbers for one seed; to run
    the same weights on both, make them on the CPU and move them."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    pattern = cfg.block_pattern
    units = cfg.n_layers // len(pattern)
    if units * len(pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not divide "
                         f"into units of the pattern {pattern}")
    pf = ParamFactory(gen, dt, device)
    params = {
        # d**-0.5 keeps tied-head logits unit-variance (x RMS=1 post-norm)
        "embed": pf.dense(cfg.vocab_padded, cfg.d_model,
                          scale=cfg.d_model ** -0.5),
    }
    stacked = ParamFactory(gen, dt, device, stack=units)
    params["layers"] = [_init_block(stacked, cfg) for _ in pattern]
    params["final_norm"] = pf.ones(cfg.d_model)
    if not cfg.tie_embeddings:
        params["head"] = pf.dense(cfg.d_model, cfg.vocab_padded)
    return params


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_reference_params(cfg, tree, device=None) -> dict:
    """The port's parameters from the JAX package's parameter tree, given
    as numpy arrays (``{"embed", "layers": [per pattern position: nested
    dict with a leading unit axis], "final_norm", "head"?}``).  The layouts
    agree leaf for leaf, so both packages compute the same function.
    ``device`` defaults to the card."""
    _check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, device)

    params = conv(tree)
    want = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"head"})
    if set(params) != want:
        raise ValueError(f"from_reference_params: keys {sorted(params)}, "
                         f"expected {sorted(want)}")
    if len(params["layers"]) != len(cfg.block_pattern):
        raise ValueError("from_reference_params: one layer stack per "
                         "pattern position expected")
    return params


def _unit(tree, u: int):
    """Unit ``u``'s parameters (or caches): views into the stacked tree."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    if isinstance(tree, attn_mod.KVCache):
        return attn_mod.KVCache(tree.k[u], tree.v[u])
    return tree[u]


def _n_units(cfg) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _head(params) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _block_forward(p: dict, x, cfg):
    """Full-sequence ``attn`` block.  Returns (x, (k, v))."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a_out, kv = attn_mod.attention_full(p["attn"], h, cfg)
    x = x + a_out
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
    x = x + ffn_mod.ffn(p["ffn"], h2, cfg)
    return x, kv


def forward(params, tokens, cfg, *, collect_cache: bool = False,
            last_logit_only: bool = False):
    """Full-sequence forward.  Returns (logits, caches, aux_loss).

    ``caches`` (with ``collect_cache``) holds, per pattern position, the
    (k, v) of every unit stacked to (units, b, s, kv_heads, hd).
    ``last_logit_only`` computes the LM head for the final position only
    (prefill serving never needs the (b, s, v) logits)."""
    _check_supported(cfg)
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    pattern = cfg.block_pattern
    per_pos: list[list] = [[] for _ in pattern]
    for u in range(_n_units(cfg)):
        for ppos in range(len(pattern)):
            x, kv = _block_forward(_unit(params["layers"][ppos], u), x, cfg)
            if collect_cache:
                per_pos[ppos].append(kv)
    caches = 0
    if collect_cache:
        caches = [(torch.stack([kv[0] for kv in kvs]),
                   torch.stack([kv[1] for kv in kvs])) for kvs in per_pos]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    logits = lm_logits(x, _head(params))
    return logits, caches, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_caches(cfg, batch: int, kv_len: int, *, device=None):
    """Per-pattern-position stacked (units, b, kv_len, kv_heads, hd) decode
    caches on ``device`` (default: the card), allocated once and written in
    place by ``decode_step``."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)
    units = _n_units(cfg)
    shape = (units, batch, kv_len, cfg.n_kv_heads, cfg.hd)
    return [attn_mod.KVCache(torch.zeros(shape, dtype=dt, device=device),
                             torch.zeros(shape, dtype=dt, device=device))
            for _ in cfg.block_pattern]


def _block_decode(p: dict, x, cache, pos: int, cfg):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a_out, _ = attn_mod.attention_decode(p["attn"], h, cache, pos, cfg)
    x = x + a_out
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + ffn_mod.ffn(p["ffn"], h2, cfg)


def decode_step(params, tokens, caches, pos: int, cfg):
    """One token for the whole batch.  tokens (b, 1); pos the absolute
    position.  Writes this step's K/V into ``caches`` in place and returns
    (logits (b, 1, v), caches)."""
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    pattern = cfg.block_pattern
    for u in range(_n_units(cfg)):
        for ppos in range(len(pattern)):
            x = _block_decode(_unit(params["layers"][ppos], u), x,
                              _unit(caches[ppos], u), pos, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, _head(params)), caches

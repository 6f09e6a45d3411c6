"""The model stack: embedding -> blocks -> norm -> LM head.

``cfg.block_pattern`` cycles over layers; layers are grouped into *units*
of one pattern period and their parameters are stacked with a leading unit
axis, as in the reference.  A Python loop over units replaces the
reference's ``lax.scan``.  The port runs the ``attn`` block with a dense
FFN (the llama family) or a MoE FFN (mixtral, qwen2-moe); the hymba and
xLSTM blocks raise ``NotImplementedError`` naming the slice that brings
them.

Decode caches are preallocated once (``init_caches``) and written in place
by each decode step; the serving tier's paged pools (``init_paged_caches``)
likewise, by ``decode_step_paged``.  Training differentiates ``loss_fn`` with
``torch.autograd``, each unit rematerialized as the reference's
``jax.checkpoint`` does (``forward(remat=...)``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ParamFactory, dtype_of, embed,
                                       lm_logits, resolve_device, rmsnorm,
                                       softmax_xent)

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
    if cfg.prefix_len:
        raise NotImplementedError(
            f"{cfg.name}: prefix embeddings (vlm / audio stubs) are not "
            "ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(pf: ParamFactory, cfg) -> dict:
    """One ``attn`` block's parameters (a MoE FFN where ``cfg.moe``)."""
    p: dict[str, Any] = {"norm1": pf.ones(cfg.d_model)}
    p["attn"] = attn_mod.init_attention(pf, cfg)
    p["norm2"] = pf.ones(cfg.d_model)
    if cfg.moe:
        p["moe"] = moe_mod.init_moe(pf, cfg)
    else:
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
    if isinstance(tree, (attn_mod.KVCache, attn_mod.PagedKVCache)):
        return type(tree)(tree.k[u], tree.v[u])
    return tree[u]


def _n_units(cfg) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _head(params) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _ffn_or_moe(p: dict, h, cfg):
    """The block's FFN: (out, MoE aux loss or None)."""
    if cfg.moe:
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    return ffn_mod.ffn(p["ffn"], h, cfg), None


def _block_forward(p: dict, x, cfg):
    """Full-sequence ``attn`` block.  Returns (x, (k, v), aux or None)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a_out, kv = attn_mod.attention_full(p["attn"], h, cfg)
    x = x + a_out
    m_out, aux = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + m_out, kv, aux


#: what ``remat="dots"`` keeps: the outputs of matrix products (the
#: reference's ``jax.checkpoint_policies.dots_saveable``)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialized(unit, remat):
    """``unit`` under the remat policy: ``False`` runs it as it is; ``True``
    saves only its inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint``); ``"dots"`` keeps the matrix products' outputs and
    recomputes everything else (selective checkpointing).  Outside grad
    mode there is no backward, and the unit runs as it is."""
    if not remat or not torch.is_grad_enabled():
        return unit
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    if remat == "dots":
        kw = {"context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    elif remat is True:
        kw = {}
    else:
        raise ValueError(f"remat must be True, False or 'dots', got {remat!r}")
    return lambda x, u: checkpoint(unit, x, u, use_reentrant=False, **kw)


def forward(params, tokens, cfg, *, collect_cache: bool = False,
            last_logit_only: bool = False, logit_index=None, remat=False):
    """Full-sequence forward.  Returns (logits, caches, aux_loss), the
    aux loss summed over the MoE layers (0 without MoE).

    ``caches`` (with ``collect_cache``) holds, per pattern position, the
    (k, v) of every unit stacked to (units, b, s, kv_heads, hd).
    ``last_logit_only`` computes the LM head for the final position only
    (prefill serving never needs the (b, s, v) logits); ``logit_index``
    (an int) generalizes it to any single position — the serving tier's
    bucketed prefill pads the prompt to the bucket length and takes the
    logit at the last real token.  ``remat`` is the
    reference's: ``True`` recomputes each unit (one pattern period) in the
    backward from its input, ``"dots"`` keeps the unit's matrix products
    and recomputes the rest, ``False`` (the default, what serving runs)
    keeps every activation."""
    _check_supported(cfg)
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    pattern = cfg.block_pattern
    per_pos: list[list] = [[] for _ in pattern]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit(x, u):
        kvs, auxs = [], []
        for ppos in range(len(pattern)):
            x, kv, a = _block_forward(_unit(params["layers"][ppos], u), x, cfg)
            kvs.append(kv)
            if a is not None:
                auxs.append(a)
        return x, kvs, auxs

    body = _rematerialized(unit, remat)
    for u in range(_n_units(cfg)):
        x, kvs, auxs = body(x, u)
        for a in auxs:
            aux = aux + a
        if collect_cache:
            for ppos, kv in enumerate(kvs):
                per_pos[ppos].append(kv)
    caches = 0
    if collect_cache:
        caches = [(torch.stack([kv[0] for kv in kvs]),
                   torch.stack([kv[1] for kv in kvs])) for kvs in per_pos]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    elif logit_index is not None:
        x = x.narrow(1, int(logit_index), 1)
    return lm_logits(x, _head(params)), caches, aux


def loss_fn(params, batch, cfg, *, policy=None, remat=None):
    """Training loss: mean next-token cross-entropy plus 0.01 x the MoE aux
    loss.  Returns ``(loss, {"ce", "aux"})``.  ``remat`` defaults as in the
    reference: the policy's, else True."""
    if remat is None:
        remat = policy.remat if policy is not None else True
    logits, _, aux = forward(params, batch["tokens"], cfg, remat=remat)
    ce = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


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
    m_out, _ = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + m_out


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


# ---------------------------------------------------------------------------
# Paged decode (the serving tier): block-pool KV caches + per-slot positions
# ---------------------------------------------------------------------------


def init_paged_caches(cfg, batch: int, n_blocks: int, block: int, *,
                      device=None):
    """Per-pattern-position stacked (units, n_blocks, block, kv_heads, hd)
    paged KV pools on ``device`` (default: the card), shared by all batch
    slots through block tables and written in place by
    ``decode_step_paged``.  ``batch`` sizes only per-slot recurrent
    states, which the port's ``attn`` blocks do not have."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)
    shape = (_n_units(cfg), n_blocks, block, cfg.n_kv_heads, cfg.hd)
    return [attn_mod.PagedKVCache(torch.zeros(shape, dtype=dt, device=device),
                                  torch.zeros(shape, dtype=dt, device=device))
            for _ in cfg.block_pattern]


def _block_decode_paged(p: dict, x, cache, tables, pos, cfg):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a_out, _ = attn_mod.attention_decode_paged(p["attn"], h, cache, tables,
                                               pos, cfg)
    x = x + a_out
    m_out, _ = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + m_out


def decode_step_paged(params, tokens, caches, tables, pos, cfg):
    """One continuous-batching decode step.  tokens (b, 1); tables (b, W)
    int block tables; pos (b,) int per-slot positions.  Writes this step's
    K/V into the pools of ``caches`` in place and returns (logits (b, 1,
    v), caches).  Idle slots point their table rows at the scratch block 0
    with pos 0, so their writes land there."""
    tables, pos = tables.long(), pos.long()  # once a step, not once a layer
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    pattern = cfg.block_pattern
    for u in range(_n_units(cfg)):
        for ppos in range(len(pattern)):
            x = _block_decode_paged(_unit(params["layers"][ppos], u), x,
                                    _unit(caches[ppos], u), tables, pos, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, _head(params)), caches

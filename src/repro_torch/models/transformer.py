"""The model stack: embedding -> blocks -> norm -> LM head.

``cfg.block_pattern`` cycles the block kinds (attn | hymba | mlstm | slstm)
over layers; layers are grouped into *units* of one pattern period and
their parameters are stacked with a leading unit axis, as in the
reference.  A Python loop over units replaces the reference's
``lax.scan``.  ``attn`` blocks carry a dense FFN (the llama family) or a
MoE FFN (mixtral, qwen2-moe); ``hymba`` runs attention and a selective SSM
side by side (``models/ssm.py``); ``mlstm`` and ``slstm`` are the xLSTM
blocks (``models/xlstm.py``).  Prefix embeddings (paligemma's patch
embeddings, a stub of the vision tower) are prepended to the token
embeddings where ``forward`` is given them.

Decode caches are preallocated once (``init_caches``) and written in place
by each decode step; the serving tier's paged pools (``init_paged_caches``)
likewise, by ``decode_step_paged``.  A block's cache is the reference's
structure: ``KVCache`` for attn, ``(KVCache, SSMState)`` for hymba,
``MLSTMState`` or ``SLSTMState``, every leaf stacked over units.  Recurrent
states are per batch slot (paged or not); each decode step copies the new
state into them.  Training differentiates ``loss_fn`` with
``torch.autograd``, each unit rematerialized as the reference's
``jax.checkpoint`` does (``forward(remat=...)``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (ParamFactory, dtype_of, embed,
                                       lm_logits, resolve_device, rmsnorm,
                                       softmax_xent)

BLOCKS = ("attn", "hymba", "mlstm", "slstm")


def _check_supported(cfg) -> None:
    for blk in cfg.block_pattern:
        if blk not in BLOCKS:
            raise ValueError(f"{cfg.name}: unknown block {blk!r}; expected "
                             f"one of {BLOCKS}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(pf: ParamFactory, cfg, blk: str) -> dict:
    """One block's parameters, the reference's leaves."""
    p: dict[str, Any] = {"norm1": pf.ones(cfg.d_model)}
    if blk == "attn":
        p["attn"] = attn_mod.init_attention(pf, cfg)
        p["norm2"] = pf.ones(cfg.d_model)
        if cfg.moe:
            p["moe"] = moe_mod.init_moe(pf, cfg)
        else:
            p["ffn"] = ffn_mod.init_ffn(pf, cfg)
    elif blk == "hymba":
        p["attn"] = attn_mod.init_attention(pf, cfg)
        p["ssm"] = ssm_mod.init_ssm(pf, cfg)
        p["norm_a"] = pf.ones(cfg.d_model)
        p["norm_s"] = pf.ones(cfg.d_model)
        p["norm2"] = pf.ones(cfg.d_model)
        p["ffn"] = ffn_mod.init_ffn(pf, cfg)
    elif blk == "mlstm":
        p["mlstm"] = xlstm_mod.init_mlstm(pf, cfg)
    elif blk == "slstm":
        p["slstm"] = xlstm_mod.init_slstm(pf, cfg)
    else:
        raise ValueError(blk)
    return p


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (default: the card; a
    ``torch.Generator`` on that device, fan-in scaled as in the reference).
    The CPU and CUDA generators give different numbers for one seed; to run
    the same weights on both, make them on the CPU and move them.  On the
    ``"meta"`` device (no generator, no memory) it gives the parameters'
    shapes and dtypes only."""
    _check_supported(cfg)
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    dt = dtype_of(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
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
    params["layers"] = [_init_block(stacked, cfg, blk) for blk in pattern]
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
    agree leaf for leaf, so both packages compute the same function; a
    tree whose structure, leaf shapes or dtypes differ from the port's
    (``init_params`` on the meta device) raises.  ``device`` defaults to
    the card."""
    _check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, device)

    params = conv(tree)
    want = init_params(cfg, device="meta")
    if _structure(params) != _structure(want):
        raise ValueError(f"from_reference_params: tree {_structure(params)}, "
                         f"expected {_structure(want)}")
    for got, ref in zip(tree_mod.leaves(params), tree_mod.leaves(want)):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise ValueError(f"from_reference_params: a leaf of {tuple(got.shape)} "
                             f"{got.dtype} where the port has {tuple(ref.shape)} "
                             f"{ref.dtype}")
    return params


def _structure(tree):
    """``tree`` with every leaf replaced by None (dict keys, list lengths)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _unit(tree, u: int):
    """Unit ``u``'s parameters (or caches): views into the stacked tree,
    containers (dicts, tuples, NamedTuples) kept."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unit(v, u) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unit(v, u) for v in tree)
    return tree[u]


def _stack(trees: list):
    """Trees of one structure stacked leaf by leaf along a new leading
    (unit) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def _write_state(buf, new) -> None:
    """Copy a block's new recurrent state into its cache buffers in place."""
    for b, n in zip(tree_mod.leaves(buf), tree_mod.leaves(new)):
        b.copy_(n)


def _n_units(cfg) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _head(params) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn_or_moe(p: dict, h, cfg):
    """The block's FFN: (out, MoE aux loss or None)."""
    if cfg.moe:
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    return ffn_mod.ffn(p["ffn"], h, cfg), None


def _hymba_mix(p: dict, a_out, s_out, cfg):
    return 0.5 * (rmsnorm(a_out, p["norm_a"], cfg.norm_eps)
                  + rmsnorm(s_out, p["norm_s"], cfg.norm_eps))


def _block_forward(blk: str, p: dict, x, cfg):
    """Full-sequence block.  Returns (x, cache, aux or None); the cache is
    the block's decode state (see the module docstring)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    aux = None
    if blk == "attn":
        a_out, cache = attn_mod.attention_full(p["attn"], h, cfg)
        x = x + a_out
        m_out, aux = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
        x = x + m_out
    elif blk == "hymba":
        a_out, kv = attn_mod.attention_full(p["attn"], h, cfg)
        s_out, st = ssm_mod.ssm_forward(p["ssm"], h, cfg)
        x = x + _hymba_mix(p, a_out, s_out, cfg)
        x = x + ffn_mod.ffn(p["ffn"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
        cache = (kv, st)
    elif blk == "mlstm":
        out, cache = xlstm_mod.mlstm_forward(p["mlstm"], h, cfg)
        x = x + out
    elif blk == "slstm":
        out, cache = xlstm_mod.slstm_forward(p["slstm"], h, cfg)
        x = x + out
    else:
        raise ValueError(blk)
    return x, cache, aux


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


def _embed_tokens(params, tokens, prefix_embeds, cfg):
    """Token embeddings in the model's dtype, the prefix embeddings (cast
    to it) before them where the config has a prefix and they are given."""
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    if cfg.prefix_len and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    return x


def forward(params, tokens, cfg, *, prefix_embeds=None,
            collect_cache: bool = False, last_logit_only: bool = False,
            logit_index=None, remat=False):
    """Full-sequence forward.  Returns (logits, caches, aux_loss), the
    aux loss summed over the MoE layers (0 without MoE).

    ``prefix_embeds`` (b, prefix_len, d_model), where the config has a
    prefix, go before the token embeddings; the logits then cover the
    prefix positions too.  ``caches`` (with ``collect_cache``) holds, per
    pattern position, the blocks' decode states with every leaf stacked
    over units: (k, v) of (units, b, s, kv_heads, hd) for attn, ((k, v),
    SSMState) for hymba, MLSTMState or SLSTMState.
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
    x = _embed_tokens(params, tokens, prefix_embeds, cfg)
    pattern = cfg.block_pattern
    per_pos: list[list] = [[] for _ in pattern]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit(x, u):
        caches, auxs = [], []
        for ppos, blk in enumerate(pattern):
            x, cache, a = _block_forward(blk, _unit(params["layers"][ppos], u),
                                         x, cfg)
            caches.append(cache)
            if a is not None:
                auxs.append(a)
        return x, caches, auxs

    body = _rematerialized(unit, remat)
    for u in range(_n_units(cfg)):
        x, caches, auxs = body(x, u)
        for a in auxs:
            aux = aux + a
        if collect_cache:
            for ppos, cache in enumerate(caches):
                per_pos[ppos].append(cache)
    caches = [_stack(cs) for cs in per_pos] if collect_cache else 0
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    elif logit_index is not None:
        x = x.narrow(1, int(logit_index), 1)
    return lm_logits(x, _head(params)), caches, aux


def loss_fn(params, batch, cfg, *, policy=None, remat=None):
    """Training loss: mean next-token cross-entropy plus 0.01 x the MoE aux
    loss, over the token positions only (the prefix positions of
    ``batch["prefix_embeds"]``, where the config has a prefix, predict
    nothing).  Returns ``(loss, {"ce", "aux"})``.  ``remat`` defaults as in
    the reference: the policy's, else True."""
    if remat is None:
        remat = policy.remat if policy is not None else True
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             prefix_embeds=batch.get("prefix_embeds"),
                             remat=remat)
    if cfg.prefix_len:
        logits = logits[:, cfg.prefix_len:]
    ce = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _stacked_caches(cfg, one) -> list:
    """Per pattern position, ``one(blk)`` repeated over units: every leaf
    gets a leading unit axis, allocated once."""
    units = _n_units(cfg)

    def rep(t):
        return t.unsqueeze(0).expand(units, *t.shape).contiguous()

    return [tree_mod.map(rep, one(blk)) for blk in cfg.block_pattern]


def _recurrent_state(cfg, blk: str, batch: int, device):
    if blk == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device=device)
    if blk == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device=device)
    raise ValueError(blk)


def init_caches(cfg, batch: int, kv_len: int, *, device=None):
    """Per-pattern-position stacked (units, ...) decode caches on
    ``device`` (default: the card), allocated once and written in place by
    ``decode_step``: (units, b, kv_len, kv_heads, hd) KV buffers, and the
    recurrent states of the hymba, mlstm and slstm blocks."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)

    def one(blk):
        if blk == "attn":
            return attn_mod.init_kv_cache(cfg, batch, kv_len, dt, device)
        if blk == "hymba":
            return (attn_mod.init_kv_cache(cfg, batch, kv_len, dt, device),
                    ssm_mod.init_ssm_state(cfg, batch, dt, device))
        return _recurrent_state(cfg, blk, batch, device)

    return _stacked_caches(cfg, one)


def _block_decode(blk: str, p: dict, x, cache, cfg, attend):
    """One decode step of one block.  ``attend(p_attn, h, kv)`` is the
    attention call (dense or paged), which writes its K/V in place; the
    recurrent state is copied into ``cache`` in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if blk == "attn":
        x = x + attend(p["attn"], h, cache)
        m_out, _ = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
        return x + m_out
    if blk == "hymba":
        kv, st = cache
        a_out = attend(p["attn"], h, kv)
        s_out, st2 = ssm_mod.ssm_decode(p["ssm"], h, st, cfg)
        _write_state(st, st2)
        x = x + _hymba_mix(p, a_out, s_out, cfg)
        return x + ffn_mod.ffn(p["ffn"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    if blk == "mlstm":
        out, st2 = xlstm_mod.mlstm_decode(p["mlstm"], h, cache, cfg)
    elif blk == "slstm":
        out, st2 = xlstm_mod.slstm_decode(p["slstm"], h, cache, cfg)
    else:
        raise ValueError(blk)
    _write_state(cache, st2)
    return x + out


def _decode_layers(params, tokens, caches, cfg, attend):
    x = embed(params["embed"], tokens).to(dtype_of(cfg))
    pattern = cfg.block_pattern
    for u in range(_n_units(cfg)):
        for ppos, blk in enumerate(pattern):
            x = _block_decode(blk, _unit(params["layers"][ppos], u), x,
                              _unit(caches[ppos], u), cfg, attend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, _head(params))


def decode_step(params, tokens, caches, pos: int, cfg):
    """One token for the whole batch.  tokens (b, 1); pos the absolute
    position.  Writes this step's K/V and recurrent states into ``caches``
    in place and returns (logits (b, 1, v), caches)."""
    def attend(p, h, kv):
        return attn_mod.attention_decode(p, h, kv, pos, cfg)[0]

    return _decode_layers(params, tokens, caches, cfg, attend), caches


# ---------------------------------------------------------------------------
# Paged decode (the serving tier): block-pool KV caches + per-slot positions
# ---------------------------------------------------------------------------


def init_paged_caches(cfg, batch: int, n_blocks: int, block: int, *,
                      device=None):
    """Per-pattern-position stacked (units, ...) paged caches on ``device``
    (default: the card), written in place by ``decode_step_paged``:
    (units, n_blocks, block, kv_heads, hd) KV pools shared by all batch
    slots through block tables, and per-slot recurrent states (``batch``
    sizes only those)."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)

    def one(blk):
        if blk == "attn":
            return attn_mod.init_paged_kv_cache(cfg, n_blocks, block, dt, device)
        if blk == "hymba":
            return (attn_mod.init_paged_kv_cache(cfg, n_blocks, block, dt, device),
                    ssm_mod.init_ssm_state(cfg, batch, dt, device))
        return _recurrent_state(cfg, blk, batch, device)

    return _stacked_caches(cfg, one)


def decode_step_paged(params, tokens, caches, tables, pos, cfg):
    """One continuous-batching decode step.  tokens (b, 1); tables (b, W)
    int block tables; pos (b,) int per-slot positions.  Writes this step's
    K/V into the pools of ``caches`` and every slot's recurrent state in
    place, and returns (logits (b, 1, v), caches).  Idle slots point their
    table rows at the scratch block 0 with pos 0, so their writes land
    there; their recurrent rows run on and are overwritten at admission."""
    tables, pos = tables.long(), pos.long()  # once a step, not once a layer

    def attend(p, h, pool):
        return attn_mod.attention_decode_paged(p, h, pool, tables, pos, cfg)[0]

    return _decode_layers(params, tokens, caches, cfg, attend), caches

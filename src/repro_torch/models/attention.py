"""GQA / MQA / sliding-window attention with KV caching.

Two call modes:
  * full-sequence (prefill): flash attention over the whole (possibly
    windowed, causal) span — the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors (``kernels/ops.py``).
  * decode: one query token against a preallocated KV cache buffer;
    sliding-window archs keep a ring buffer of size ``window``.  Plain torch,
    as in the reference.
  * paged decode (the serving tier, ``repro_torch.serving``): every batch
    slot at its own position, its K/V in blocks of a shared pool reached
    through a per-slot block table (``ops.kv_block_gather``).  Plain torch:
    the reference has no kernel for it either.

Parameter layout keeps heads (h) and head_dim (d) as separate tensor dims —
these are exactly the EinSum labels EinDecomp assigns mesh axes to (the
multi-head-attention EinGraph of paper §3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamFactory, apply_rope, resolve_device


def init_attention(pf: ParamFactory, cfg) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": pf.dense(D, H, hd),
        "wk": pf.dense(D, K, hd),
        "wv": pf.dense(D, K, hd),
        "wo": pf.dense(H, hd, D, scale=(H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = pf.zeros(H, hd)
        p["bk"] = pf.zeros(K, hd)
        p["bv"] = pf.zeros(K, hd)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    q = torch.einsum("bsa,ahd->bshd", x, p["wq"])
    k = torch.einsum("bsa,akd->bskd", x, p["wk"])
    v = torch.einsum("bsa,akd->bskd", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p: dict, x: torch.Tensor, cfg, *,
                   prefix_len: int = 0) -> tuple[torch.Tensor, tuple]:
    """Prefill path.  Returns (out, (k, v)) with k/v in (b, s, kv_heads, hd).
    One flash-attention call per layer; the (b, s, h, d) projections reach
    the kernel as transposed views, without a copy.

    ``prefix_len`` > 0 marks a non-causal prefix (paligemma's patch
    embeddings).  As in the reference, the whole span stays plain causal
    (a documented simplification: the decomposition structure is the
    same), so it changes nothing here."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=cfg.window)
    o = o.transpose(1, 2)  # (b, s, h, d)
    out = torch.einsum("bshd,hda->bsa", o, p["wo"])
    return out, (k, v)


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, S, kv_heads, hd)
    v: torch.Tensor


def init_kv_cache(cfg, batch: int, length: int, dtype,
                  device=None) -> KVCache:
    K, hd = cfg.n_kv_heads, cfg.hd
    shape = (batch, length, K, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  x: (b, 1, d_model); pos: absolute position.

    The step's K/V are written **in place** into the preallocated cache
    (the reference returns a new buffer from ``dynamic_update_slice``); the
    returned cache is the same object.  Sliding-window archs use the cache
    as a ring buffer (slot = pos % W) and attend with window masking on
    absolute positions reconstructed from the ring; full-attention archs
    write at slot = pos.
    """
    S = cache.k.shape[1]
    positions = torch.full((1,), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)

    slot = (pos % S) if cfg.window else pos
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]

    qh = q.transpose(1, 2)          # (b, h, 1, hd)
    kh = cache.k.transpose(1, 2)    # (b, kv, S, hd)
    vh = cache.v.transpose(1, 2)

    idx = torch.arange(S, device=x.device)
    if cfg.window:
        # ring buffer: absolute position of slot i given current pos
        abs_pos = pos - ((pos % S) - idx) % S   # in (pos-S, pos]
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - cfg.window)
    else:
        valid = idx <= pos

    o = _decode_attend(qh, kh, vh, valid)
    o = o.transpose(1, 2)
    out = torch.einsum("bshd,hda->bsa", o, p["wo"])
    return out, cache


class PagedKVCache(NamedTuple):
    """Block-pool KV cache (the serving tier): ``n_blocks`` blocks of
    ``block`` cache rows each; sequences own disjoint block sets through
    per-slot block tables.  Block 0 is reserved as scratch (inactive slots
    write there; nothing valid ever reads it)."""

    k: torch.Tensor  # (n_blocks, block, kv_heads, hd)
    v: torch.Tensor


def init_paged_kv_cache(cfg, n_blocks: int, block: int, dtype,
                        device=None) -> PagedKVCache:
    """A zero pool on ``device`` (default: the card)."""
    device = resolve_device(device)
    shape = (n_blocks, block, cfg.n_kv_heads, cfg.hd)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def attention_decode_paged(p: dict, x: torch.Tensor, pool: PagedKVCache,
                           tables: torch.Tensor, pos: torch.Tensor,
                           cfg) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step against a paged block pool.

    x: (b, 1, d_model); tables: (b, W) int block tables; pos: (b,) int
    per-slot absolute positions — unlike ``attention_decode``, every batch
    slot sits at its *own* position (continuous batching).  This step's
    K/V are written **in place** into block ``tables[b, pos // block]`` at
    row ``pos % block`` (the reference returns a new pool); the
    time-ordered cache view is gathered through the same block-table lookup
    the planner prices (``ops.kv_block_gather``) and attended with per-row
    validity masks (``idx <= pos``, plus the sliding window on absolute
    positions for windowed archs — the pool is time-ordered, so no ring
    reconstruction is needed).  The write comes before the gather, so the
    pad rows a bucketed prefill left at row ``pos`` are overwritten before
    the mask admits them.  Idle slots (table rows of 0, pos 0) all write
    row 0 of the scratch block; which of them lands there does not matter.
    """
    blk = pool.k.shape[1]
    W = tables.shape[1]
    pos = pos.long()
    tables = tables.long()
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    blk_ids = torch.gather(tables, 1, (pos // blk)[:, None])[:, 0]
    off = pos % blk
    pool.k[blk_ids, off] = k_new[:, 0]
    pool.v[blk_ids, off] = v_new[:, 0]

    kh = ops.kv_block_gather(pool.k, tables, W * blk)   # (b, kv, t, d)
    vh = ops.kv_block_gather(pool.v, tables, W * blk)
    qh = q.transpose(1, 2)                              # (b, h, 1, hd)

    idx = torch.arange(W * blk, device=x.device)
    valid = idx[None, :] <= pos[:, None]
    if cfg.window:
        valid &= idx[None, :] > (pos[:, None] - cfg.window)

    o = _decode_attend(qh, kh, vh, valid)
    o = o.transpose(1, 2)
    out = torch.einsum("bshd,hda->bsa", o, p["wo"])
    return out, pool


def _decode_attend(q, k, v, valid):
    """Masked attention for a single query against the whole cache buffer.
    ``valid`` is (S,) shared across the batch, or (b, S) per row (the paged
    decode path, where every slot sits at its own position)."""
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    b, _, S, d = k.shape
    f32 = torch.float32
    qs = q.reshape(b, hkv, g, 1, d).to(f32) * (d ** -0.5)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(f32))
    mask = valid[:, None, None, None, :] if valid.dim() == 2 else valid
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = torch.sum(pr, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr / l, v.to(f32))
    return o.reshape(b, hq, 1, d).to(q.dtype)

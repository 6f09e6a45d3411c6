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

Under a mesh of more than one rank (DTensor activations, ``policy`` and
``mesh`` given) the projections run on DTensors, and the attention core —
the flash kernel in prefill, the masked cache softmax and the in-place
cache write in decode — runs on each rank's (batch, head) blocks, as the
``ring`` shard rule keeps flash attention local: q heads and kv heads
split on the same axes, so GQA groups stay whole; the sequence whole.  A
head dim split by the policy is gathered for the flash kernel; in decode
each rank keeps its block of it, and the partial scores are summed across
its axes; a cache time split combines softmax partials across its axes.
The paged decode's pool has no batch dim: each rank holds its kv-head
(and head-dim) block of every pool block, writes every slot's new row
into it and attends its own slots (``_paged_placed``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import gspmd
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


def _proj_in(x, w):
    """x (b, s, a) @ w (a, h, d) -> (b, s, h, d).  On DTensors the product
    of local blocks (``gspmd.local_einsum``), which flattens no split
    dims."""
    if isinstance(x, DTensor):
        return gspmd.local_einsum("bsa,ahd->bshd", x, w)
    return torch.einsum("bsa,ahd->bshd", x, w)


def _proj_out(o, w):
    """o (b, s, h, d) @ w (h, d, a) -> (b, s, a), as ``_proj_in``."""
    if isinstance(o, DTensor):
        return gspmd.local_einsum("bshd,hda->bsa", o, w)
    return torch.einsum("bshd,hda->bsa", o, w)


def _project_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def head_spec(policy, mesh, batch: int, heads: int, kv_heads: int) -> tuple:
    """``(batch entry, head entry)`` of the blocks attention runs on under
    ``policy``: the batch on the policy's batch axes, q and kv heads on the
    union of its ``h`` and ``k`` axes (as the ring rule co-shards them);
    axes that do not divide the batch, or both head counts, are dropped."""
    from repro_torch.models.policy import batch_entry

    sizes = gspmd.mesh_sizes(mesh)
    b_entry = batch_entry(policy, mesh, batch)
    used = set() if b_entry is None else set(
        (b_entry,) if isinstance(b_entry, str) else b_entry)
    head_axes, n = [], 1
    for a in policy._axes("h") + policy._axes("k"):
        if a in used or a in head_axes:
            continue
        if heads % (n * sizes[a]) == 0 and kv_heads % (n * sizes[a]) == 0:
            head_axes.append(a)
            n *= sizes[a]
    return b_entry, gspmd.entry_of(head_axes)


def _flash_placed(q, k, v, policy, mesh, **kw):
    """The flash kernel on each rank's (batch, head) blocks of DTensor
    q (b, h, s, d) and k/v (b, kv, s, d), the head dim whole: one the
    policy splits is gathered first, and the output is constrained back to
    it."""
    from repro_torch.core.gspmd import constrain, run_local, spec_of_placements

    be, he = head_spec(policy, mesh, q.shape[0], q.shape[1], k.shape[1])
    spec = (be, he, None, None)
    o = run_local(lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                  (q, k, v), (spec, spec, spec), spec, mesh)
    de = spec_of_placements(q.placements, 4, mesh)[3]
    return o if de is None else constrain(o, mesh, (be, he, None, de))


def attention_full(p: dict, x: torch.Tensor, cfg, *, prefix_len: int = 0,
                   policy=None, mesh=None) -> tuple[torch.Tensor, tuple]:
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
    if mesh is not None and mesh.world_size > 1:
        o = _flash_placed(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), policy, mesh, causal=True,
                          window=cfg.window)
    else:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=cfg.window)
    o = o.transpose(1, 2)  # (b, s, h, d)
    out = _proj_out(o, p["wo"])
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


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, pos,
                     cfg, *, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  x: (b, 1, d_model); pos: the absolute position, a
    0-d integer tensor on the cache's device (the reference's traced
    scalar) or an int, which is converted to one.

    The step's K/V are written **in place** into the preallocated cache
    (the reference returns a new buffer from ``dynamic_update_slice``); the
    returned cache is the same object.  Sliding-window archs use the cache
    as a ring buffer (slot = pos % W) and attend with window masking on
    absolute positions reconstructed from the ring; full-attention archs
    write at slot = pos.  The slot and the masks are computed on the device
    and the write takes a tensor index (``index_copy_``), so no value of
    ``pos`` reaches the host: one captured CUDA graph serves every step
    (``launch.steps.GraphedStep``).
    """
    S = cache.k.shape[1]
    pos = as_position(pos, x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos.reshape(1))

    slot = (pos % S) if cfg.window else pos
    idx = torch.arange(S, device=x.device)
    if cfg.window:
        # ring buffer: absolute position of slot i given current pos
        abs_pos = pos - ((pos % S) - idx) % S   # in (pos-S, pos]
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - cfg.window)
    else:
        valid = idx <= pos

    def core(q, k_new, v_new, ck, cv, **kw):
        ck.index_copy_(1, slot.reshape(1), k_new.to(ck.dtype))
        cv.index_copy_(1, slot.reshape(1), v_new.to(cv.dtype))
        o = _decode_attend(q.transpose(1, 2), ck.transpose(1, 2),
                           cv.transpose(1, 2), valid, **kw)
        return o.transpose(1, 2)

    if mesh is not None and mesh.world_size > 1:
        o = _decode_placed(core, q, k_new, v_new, cache, mesh, slot, valid)
    else:
        o = core(q, k_new, v_new, cache.k, cache.v)
    out = _proj_out(o, p["wo"])
    return out, cache


def as_position(pos, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: an int is
    filled in on the device (a kernel argument, no host-to-device copy), a
    tensor cast where it is not int64 yet."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.long).reshape(())
    return torch.full((), int(pos), dtype=torch.long, device=device)


def _decode_placed(core, q, k_new, v_new, cache: KVCache, mesh, slot,
                   valid):
    """``core`` on each rank's (batch, kv-head) blocks of the DTensor
    cache, written in place: q and this step's K/V are placed as the cache
    is (q heads on the cache's kv-head axes).  A cache split along its
    time dim takes ``_decode_time_split``.  One split along its head dim
    takes each rank's ``d`` block: the rank writes its block of the new
    row, its float32 partial scores are summed across ``d``'s axes
    (``_head_dim_split``), the softmax is taken locally, and P·V gives the
    output on the rank's ``d`` block."""
    from repro_torch.core import gspmd

    be, te, ke, de = gspmd.spec_of_placements(cache.k.placements, 4, mesh)
    spec = (be, None, ke, de)
    kw = _head_dim_split(mesh, be, ke, de, q.shape[-1])
    if te is not None:
        return _decode_time_split(q, k_new, v_new, cache, mesh, spec, te, slot,
                                  valid, **kw)
    return gspmd.run_local(
        lambda q, k, v: core(q, k, v, cache.k.to_local(), cache.v.to_local(), **kw),
        (q, k_new, v_new), (spec, spec, spec), spec, mesh)


def _head_dim_split(mesh, be, ke, de, hd: int) -> dict:
    """``_decode_attend``'s keywords for q and a cache whose head dim (of
    ``hd``) is split over the axes of ``de`` (none where ``de`` is None):
    the scale of the whole head dim, and ``sum_scores``, which sums the
    float32 partial scores (b, kv, g, 1, t) — each rank's over its block
    of the head dim — across those axes (an all-reduce)."""
    if de is None:
        return {}
    sspec = (be, ke, None, None, None)
    partial = [(a, "sum") for a in gspmd.entry_axes(de)]

    def sum_scores(s):
        part = gspmd.wrap_block(s, mesh, sspec, partial=partial)
        return gspmd.constrain(part, mesh, sspec).to_local()

    return {"hd": hd, "sum_scores": sum_scores}


def _decode_time_split(q, k_new, v_new, cache: KVCache, mesh, spec, te, slot,
                       valid, **kw):
    """The decode step on a cache split along its time dim over the axes of
    ``te``: the rank whose time block holds ``slot`` writes this step's K/V
    there; every rank attends over its own block, and the blocks' softmax
    partials combine across those axes — the running max by an all-reduce
    of max, the sums rescaled to it and all-reduced — as ``_decode_attend``
    over the whole cache, up to float32 sums in another order.  ``kw``
    (``hd``, ``sum_scores``) carries a head dim split as ``spec``'s last
    entry says (``_decode_placed``)."""
    from repro_torch.core import gspmd

    be, _, ke, de = spec
    ql, kl, vl = (gspmd.constrain(t, mesh, spec).to_local() for t in (q, k_new, v_new))
    ck, cv = cache.k.to_local(), cache.v.to_local()
    axes = gspmd.entry_axes(te)
    span = ck.shape[1]
    lo = mesh.linear_index(axes) * span
    # the slot's index in this block, clamped: a rank whose block does not
    # hold it writes back the row it has (no value of ``slot`` is read)
    local = slot - lo
    here = (local >= 0) & (local < span)
    at = local.clamp(0, span - 1).reshape(1)
    for c, row in ((ck, kl), (cv, vl)):
        c.index_copy_(1, at, torch.where(here, row.to(c.dtype), c.index_select(1, at)))
    m, l, o = _decode_partial(ql.transpose(1, 2), ck.transpose(1, 2),
                              cv.transpose(1, 2), valid[lo:lo + span], **kw)

    def combined(t, op, last=None):  # (b, h, 1, ·)
        pspec = (be, ke, None, last)
        part = gspmd.wrap_block(t, mesh, pspec, partial=[(a, op) for a in axes])
        return gspmd.constrain(part, mesh, pspec).to_local()

    scale = torch.exp(m - combined(m, "max"))
    out = combined(o * scale, "sum", de) / combined(l * scale, "sum")
    return gspmd.wrap_block(out.to(q.dtype).transpose(1, 2), mesh, spec)


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
                           cfg, *, policy=None,
                           mesh=None) -> tuple[torch.Tensor, PagedKVCache]:
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

    On a mesh of more than one rank (``policy`` and ``mesh`` given; the
    pool a DTensor placed by ``transformer.paged_cache_specs``) the step
    runs on each rank's (batch block x kv-head block): ``_paged_placed``.
    """
    blk = pool.k.shape[1]
    W = tables.shape[1]
    pos = pos.long()
    tables = tables.long()
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    idx = torch.arange(W * blk, device=pos.device)
    valid = idx[None, :] <= pos[:, None]
    if cfg.window:
        valid &= idx[None, :] > (pos[:, None] - cfg.window)

    def write(k_new, v_new, pk, pv):
        blk_ids = torch.gather(tables, 1, (pos // blk)[:, None])[:, 0]
        off = pos % blk
        pk[blk_ids, off] = k_new[:, 0]
        pv[blk_ids, off] = v_new[:, 0]

    def attend(q, pk, pv, rows, **kw):
        kh = ops.kv_block_gather(pk, tables[rows], W * blk)   # (b, kv, t, d)
        vh = ops.kv_block_gather(pv, tables[rows], W * blk)
        o = _decode_attend(q.transpose(1, 2), kh, vh, valid[rows], **kw)
        return o.transpose(1, 2)

    if mesh is not None and mesh.world_size > 1:
        o = _paged_placed(write, attend, q, k_new, v_new, pool, policy, mesh)
    else:
        write(k_new, v_new, pool.k, pool.v)
        o = attend(q, pool.k, pool.v, slice(None))
    out = _proj_out(o, p["wo"])
    return out, pool


def _paged_placed(write, attend, q, k_new, v_new, pool: PagedKVCache,
                  policy, mesh):
    """The paged step on each rank's (batch block x kv-head block): q on
    the policy's batch axes (``policy.batch_entry``) and the pool's
    kv-head axes.  The pool has no batch dim — any slot may own any block
    — so it is whole along the batch axes, and each rank holds its kv-head
    block of every block.  So a rank writes *every* slot's new K/V row
    into that block (this step's K/V gathered over the batch axes first):
    the ranks that hold one head block then hold equal pools, as the
    reference's replicated pool is one array.  It then gathers and attends
    its own slots (``write(k, v, pool k, pool v)``, ``attend(q, pool k,
    pool v, rows)``).  A pool split along its head dim is attended as the
    dense decode attends such a cache (``_decode_placed``): each rank
    writes and gathers its ``d`` block of the rows, and its partial scores
    are summed across ``d``'s axes.  The pool's block and row dims carry
    no label (``"-"``), so no policy splits them; a pool split there
    raises."""
    from repro_torch.models.policy import batch_entry

    nb, br, ke, de = gspmd.spec_of_placements(pool.k.placements, 4, mesh)
    if nb is not None or br is not None:
        raise NotImplementedError(
            f"attention_decode_paged: a pool split along its block or row dim "
            f"({(nb, br, ke, de)}): those dims carry no label "
            "(transformer.PAGED_POOL_LABELS), so no policy places a pool so")
    heads = set(gspmd.entry_axes(ke)) | set(gspmd.entry_axes(de))
    be = gspmd.entry_of([a for a in gspmd.entry_axes(
        batch_entry(policy, mesh, q.shape[0])) if a not in heads])
    spec, every = (be, None, ke, de), (None, None, ke, de)
    kw = _head_dim_split(mesh, be, ke, de, q.shape[-1])
    ql = gspmd.constrain(q, mesh, spec).to_local()
    kl, vl = (gspmd.constrain(t, mesh, every).to_local() for t in (k_new, v_new))
    pk, pv = pool.k.to_local(), pool.v.to_local()
    write(kl, vl, pk, pv)
    rows = gspmd.local_block(torch.arange(q.shape[0], device=pk.device), (be,),
                             mesh)
    return gspmd.wrap_block(attend(ql, pk, pv, rows, **kw), mesh, spec)


def _decode_attend(q, k, v, valid, *, hd: int | None = None, sum_scores=None):
    """Masked attention for a single query against the whole cache buffer.
    ``valid`` is (S,) shared across the batch, or (b, S) per row (the paged
    decode path, where every slot sits at its own position).  On a block
    of the head dim, ``hd`` is the whole head dim (the score scale) and
    ``sum_scores`` sums the block's float32 partial scores across ranks."""
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    b, _, S, d = k.shape
    f32 = torch.float32
    qs = q.reshape(b, hkv, g, 1, d).to(f32) * ((hd or d) ** -0.5)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(f32))
    if sum_scores is not None:
        s = sum_scores(s)
    mask = valid[:, None, None, None, :] if valid.dim() == 2 else valid
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = torch.sum(pr, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr / l, v.to(f32))
    return o.reshape(b, hq, 1, d).to(q.dtype)


def _decode_partial(q, k, v, valid, *, hd: int | None = None, sum_scores=None):
    """One time block's softmax partials of a single query: the block's
    max score ``m`` (b, hq, 1, 1), its sum of ``exp(s - m)`` ``l`` (b, hq,
    1, 1) and the unnormalised output ``o`` (b, hq, 1, d), in float32, with
    ``_decode_attend``'s masking (``valid`` (S,) over the block) and its
    ``hd`` and ``sum_scores`` for a block of the head dim."""
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    b, _, S, d = k.shape
    f32 = torch.float32
    qs = q.reshape(b, hkv, g, 1, d).to(f32) * ((hd or d) ** -0.5)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(f32))
    if sum_scores is not None:
        s = sum_scores(s)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = torch.sum(pr, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.to(f32))
    return m.reshape(b, hq, 1, 1), l.reshape(b, hq, 1, 1), o.reshape(b, hq, 1, d)

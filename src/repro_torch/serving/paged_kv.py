"""Paged KV-cache plumbing for the serving tier.

Device side, the pool is ``models.attention.PagedKVCache`` — ``n_blocks``
blocks of ``block`` cache rows shared by every decode slot — and the
per-step lookup is the ``kv_block_gather`` OpDef, so the planner prices it
like any other op.  This module owns the *host* side: a free-list block
allocator, and the admission that copies a bucketed prefill's collected
caches into the pool under a slot's block table, and its recurrent states
(hymba, xLSTM) into the slot's rows.

Block 0 is reserved as scratch: idle slots keep all-zero table rows, so
their (masked, never-read) decode writes land there instead of in live
blocks.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree
from repro_torch.models.attention import PagedKVCache


class BlockAllocator:
    """Free-list allocator over pool blocks 1..n_blocks-1 (0 = scratch).

    ``alloc(n)`` hands out ``n`` block ids or ``None`` if the pool cannot
    satisfy the request (admission then waits for an eviction — all-or-
    nothing keeps table rows contiguous-by-request and deadlock analysis
    trivial).  ``release`` returns a request's blocks at eviction.
    """

    def __init__(self, n_blocks: int, block: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.n_blocks = int(n_blocks)
        self.block = int(block)
        # pop() from the tail -> ids hand out in 1, 2, 3, ... order
        self._free = list(range(self.n_blocks - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        return out

    def release(self, blocks: list[int]) -> None:
        live = set(self._free)
        for b in blocks:
            if not 0 < b < self.n_blocks or b in live:
                raise ValueError(f"release: bad/double-freed block {b}")
        self._free.extend(blocks)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache rows."""
        return -(-int(tokens) // self.block)


def _scatter_kv(pool: PagedKVCache, k, v, blocks) -> PagedKVCache:
    """Copy a prefill KV cache (L, 1, s, kh, hd) into a stacked pool
    (L, N, blk, kh, hd) under table row ``blocks`` (W,), in place.

    The source is padded with zeros or truncated to the full W*blk rows:
    rows past the prompt land either in the slot's own not-yet-reached
    blocks (decode overwrites row ``pos`` before any mask admits it) or —
    where the table row is 0-padded — in the scratch block.

    On a mesh the pool is a DTensor whose kv-head and head dims may be
    split (``transformer.paged_cache_specs``): the prefill's K/V, placed by
    the prefill's policy, are redistributed to the pool's placements
    (every other dim whole), and each rank copies its block into its block
    of the pool.
    """
    from torch.distributed.tensor import DTensor

    blk = pool.k.shape[2]
    rows = blocks.shape[0] * blk

    def prep(x):
        x = x[:, 0]                         # (L, s, kh, hd)
        L, s, kh, hd = x.shape
        if s < rows:
            x = torch.cat([x, x.new_zeros((L, rows - s, kh, hd))], dim=1)
        else:
            x = x[:, :rows]
        return x.reshape(L, -1, blk, kh, hd)

    blocks = blocks.long()
    for dst, src in ((pool.k, k), (pool.v, v)):
        if isinstance(dst, DTensor):
            src = src.redistribute(dst.device_mesh, dst.placements).to_local()
            dst = dst.to_local()
        dst[:, blocks] = prep(src)
    return pool


def _set_slot(state, src, slot):
    """Copy a batch-1 prefill state tree into row ``slot`` (an int, or a
    0-d integer tensor on the device, which a captured admission reads
    there) of the stacked decode state tree in place (leaves (L, b, ...)
    <- (L, 1, ...)).

    On a mesh a state leaf is a DTensor whose batch dim (1) may be split:
    the prefill's row is redistributed to the leaf's placements with that
    dim whole, and only the ranks whose batch block holds ``slot`` write
    it, at its index in their block (DTensor has no write of one row of a
    split dim); there ``slot`` is read on the host (a mesh runs eagerly)."""
    from torch.distributed.tensor import DTensor, Replicate

    for d, x in zip(tree.leaves(state), tree.leaves(src)):
        if not isinstance(d, DTensor):
            if isinstance(slot, torch.Tensor):
                d.index_copy_(1, _index(slot, d), x.to(d.dtype))
            else:
                d[:, slot] = x[:, 0]
            continue
        pl = [Replicate() if p.is_shard(1) else p for p in d.placements]
        x = x.redistribute(d.device_mesh, pl).to_local()
        block = d.to_local()
        lo = _row_offset(d, block)
        slot = int(slot)
        if lo <= slot < lo + block.shape[1]:
            block[:, slot - lo] = x[:, 0]
    return state


def _index(slot: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-d ``slot`` as the (1,) int64 index ``index_copy_`` takes."""
    return slot.reshape(1).to(device=like.device, dtype=torch.long)


def _row_offset(d, block) -> int:
    """The global index of the first batch row (dim 1) of this rank's
    ``block`` of DTensor ``d``: the mesh dims that split dim 1 nest its
    blocks in mesh order, major to minor."""
    mesh = d.device_mesh
    idx = 0
    for i, p in enumerate(d.placements):
        if p.is_shard(1):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * block.shape[1]


def make_admit_fn(cfg):
    """Admission: scatter one request's prefill caches into the paged decode
    caches and seed its first token.

    Signature: ``admit(caches, pre_caches, blocks, slot, tok0, tokens) ->
    (caches, tokens)`` with ``blocks`` the (W,) int table row on the
    device, ``slot`` an int or a 0-d integer tensor on the device (the
    reference's traced scalar: the engine's captured admission reads it
    from a fixed buffer), ``tok0`` the prefill argmax (1,) int32.  The
    pools and states may
    be DTensors (an engine on a mesh); the tokens are whole on every rank.
    Per pattern position, an ``attn`` block's KV goes into the pool under
    the table row; a ``hymba`` block's KV likewise, and its SSM state into
    the slot's row; ``mlstm`` and ``slstm`` states into the slot's rows.
    The pools and
    states are written in place (where the reference donates them).  The
    token buffer is not: the engine's step log holds the last decode step's
    token tensor, which is the buffer passed in, so the new token goes into
    a copy — writing the buffer itself would rewrite the logged token of
    the request that last held the slot.
    """
    pattern = cfg.block_pattern

    def admit(caches, pre_caches, blocks, slot: int, tok0, tokens):
        for blk_kind, cache, pre in zip(pattern, caches, pre_caches):
            if blk_kind == "attn":
                k, v = pre
                _scatter_kv(cache, k, v, blocks)
            elif blk_kind == "hymba":
                (k, v), st_pre = pre
                pool, st = cache
                _scatter_kv(pool, k, v, blocks)
                _set_slot(st, st_pre, slot)
            else:  # mlstm / slstm: per-slot recurrent state rows
                _set_slot(cache, pre, slot)
        tokens = tokens.clone()
        if isinstance(slot, torch.Tensor):
            tokens.index_copy_(0, _index(slot, tokens), tok0.view(1, 1).to(tokens.dtype))
        else:
            tokens[slot, 0] = tok0[0]
        return caches, tokens

    return admit

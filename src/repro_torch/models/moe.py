"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort dispatch,
grouped expert matmuls, optional always-on shared experts.

The production lowering of the reference (the relational one-hot form
lives in the EinGraph builders, ``models/eingraphs.py``): tokens are
sorted by expert, scattered into capacity buffers (GShard layout), the
experts run as grouped matmuls and the results are gathered back.

Dispatch modes:
  * global (``moe_groups <= 1``, every zoo config): one capacity region per
    expert; the three expert products go through ``kernels.ops.gmm`` (the
    grouped-matmul kernel on a card, its plain version on the CPU).
  * group-local (``moe_groups = G``): tokens split into G groups with a
    capacity per (group, expert); the products stay ``torch.einsum``, as
    the reference leaves them to XLA.

Translation notes: the sort is stable (``jnp.argsort`` is), so a token's
rank inside its expert, and hence which tokens a full expert drops, is the
reference's.  The combine sums each token's K contributions in k order in
the activations' dtype, without atomics, so a run on the card gives the
same bits every time.  The per-expert counts are a ``scatter_add_``, not
``bincount`` (whose output size depends on the data) or ``one_hot``
(which reads the ids to check them): the dispatch runs on abstract (meta)
blocks too, for the dry run (``launch/dryrun.py``), and counts the same
traffic there.

Under a mesh of more than one rank (``x`` a DTensor, ``policy`` and
``mesh`` given), global dispatch keeps the tokens where the policy's
``"b s a"`` spec puts them, and no rank holds a tensor with a dimension
of the global tokens (but the int32 counts of each batch row's entries
per expert):

  * the mesh axes fall in three kinds: those that split the tokens (the
    batch and sequence axes, less any that also split the expert width),
    those that split the experts or their width across ranks holding the
    same tokens (the "grid"), and the rest, along which ranks compute the
    same thing.  Each rank routes its own tokens;
  * global capacity slots: a token's slot in its expert is its rank among
    the entries bound there in the global batch-major order (t = b S + s,
    then k), as on one rank: this rank's ranks (``_slot_ranks``) plus the
    entries of earlier rows and earlier sequence blocks of the same row,
    from the per-(row, expert) counts all-gathered over the token axes.  So
    the capacity and the tokens a full expert drops are one rank's;
  * where an axis splits both the tokens and the experts, each kept (token,
    k) row goes to the rank of its expert block by one ``all_to_all`` over
    those axes (``_dispatch_a2a``: the split sizes and the slots the rows
    land in follow from the counts, read on the host), and its output comes
    back by another; the backward of each is the other, and the rank's
    (E/r, C, D) buffer takes its experts' kept entries from every rank.
    Otherwise (the experts whole, or split only across ranks holding the
    same tokens) each rank gathers, of its tokens, only the rows kept for
    its own expert block (``_dispatch_compute_combine`` with ``experts``)
    into an (E/r, C_loc, D) buffer: the entries a rank keeps for an expert
    are the first of its own, so it fills them in its own order, and C_loc
    is the most an expert of its block keeps there (read on the host from
    the counts, in the kernel's tiles of 128 rows, at most C).  Either way each rank runs the three
    ``ops.gmm`` products on its buffer — against its (E/r, D, F/r_f) and
    (E/r, F/r_f, D) weight blocks, where the policy splits the expert
    width too;
  * the combine weighs the returned rows and adds each token's K
    contributions in k order into a (T_loc, D) block; over the grid it is a
    partial sum (in float32 for a low-precision model, rounded once), which
    the ``"b s a"`` constraint reduces — a reduce-scatter back onto the
    sequence where an axis splits both the sequence and the expert width,
    after the tokens were gathered along it;
  * the aux loss takes the reference's mean gates and loads over the global
    tokens (2E floats summed across the token axes); every rank holds
    one rank's aux, whose gradient reaches the router through the first
    rank of the grid only.
  * group-local dispatch keeps its G groups split as the batch is split,
    and runs on each rank's groups with the weights whole; its aux loss
    takes the mean gates and loads summed over every rank's groups.

PERF.md's table of the dry run's MoE cells sets this layout's per-rank
peak beside the reference's (XLA's memory analysis) and that of the
layout before it, which gathered the global batch on every rank (2,373.63
GB a rank for qwen2-moe-a2.7b's train_4k cell on (2, 16, 16), where the
reference needs 120.61 GB).  An abstract run has counts without values:
its all-to-alls carry, and its buffers of whole experts hold, the rows of
an even routing (``_even_counts``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import ParamFactory, activation


def init_moe(pf: ParamFactory, cfg) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_e, cfg.d_ff
    p = {
        "router": pf.dense(D, E),
        "w1": pf.dense(E, D, Fd),
        "w2": pf.dense(E, Fd, D),
    }
    if cfg.gated_ffn:
        p["w3"] = pf.dense(E, D, Fd)
    if cfg.shared_expert_ff:
        p["shared"] = ffn_mod.init_ffn(pf, cfg, d_ff=cfg.shared_expert_ff)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_e * cfg.capacity_factor)
    return max(128, -(-c // 128) * 128)  # round up to the kernel's tile


def _route(p, xt, cfg, terms: bool = False):
    """xt (..., T, D) -> (top weights, top experts, aux loss); with
    ``terms`` the aux loss's inputs (gates, top experts) in its place."""
    E = cfg.n_e
    logits = torch.matmul(xt, p["router"]).to(torch.float32)
    if cfg.n_experts < E:  # padded dispatch slots never win routing
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = logits + torch.where(pad, -1e30, 0.0)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(gates, cfg.top_k, dim=-1)  # sorted, descending
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    if terms:
        return topw, tope, (gates, tope)
    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(gates.reshape(-1, E), dim=0)
    ce = _counts(tope.reshape(-1), E, torch.float32) / tope.numel()
    aux = E * torch.sum(me * ce)
    return topw, tope, aux


def _counts(e: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """(..., N) expert ids -> (..., E): how many entries name each expert.
    A ``scatter_add_``, which reads no data to check it (``one_hot`` does),
    so abstract and real blocks count the same traffic."""
    return torch.zeros(e.shape[:-1] + (E,), dtype=dtype, device=e.device).scatter_add_(
        -1, e, torch.ones(e.shape, dtype=dtype, device=e.device))


def _sum_k(vals: torch.Tensor, K: int) -> torch.Tensor:
    """(..., T*K, D) -> (..., T, D): each token's K contributions added in k
    order, in their dtype (the reference's scatter-add from zeros)."""
    v = vals.unflatten(-2, (vals.shape[-2] // K, K))
    out = v[..., 0, :]
    for k in range(1, K):
        out = out + v[..., k, :]
    return out


def _slot_ranks(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each routed (token, k) entry's rank among the entries bound for its
    expert, in token order (a stable sort): its capacity slot, kept where
    it is below the capacity."""
    order = torch.argsort(e_flat, stable=True)
    counts = _counts(e_flat, E, e_flat.dtype)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e_flat)
    rank[order] = (torch.arange(e_flat.shape[0], device=e_flat.device)
                   - starts[e_flat[order]])
    return rank


def _experts(p, buf, cfg):
    """The three expert products of capacity buffers: (E, C, D) -> (E, C, D)."""
    act = activation(cfg.act)
    h = ops.gmm(buf, p["w1"])                                    # (E, C, F)
    if cfg.gated_ffn:
        h = act(h) * ops.gmm(buf, p["w3"])
    else:
        h = act(h)
    return ops.gmm(h, p["w2"])                                   # (E, C, D)


def _weighed_sum_k(rows, w, idx, K: int, dtype=None):
    """Each token's K contributions: ``idx`` (T*K,) names each (token, k)
    entry's row of ``rows`` (N, D), or N for none; the N rows are weighed
    by ``w`` (N,) and the entries added in k order in ``dtype`` (default:
    the rows'), as ``_sum_k`` adds them -> (T, D)."""
    rows = rows * w[:, None].to(rows.dtype)
    rows = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    idx = idx.view(-1, K)
    out = None
    for k in range(K):
        c = rows[idx[:, k]]
        c = c if dtype is None else c.to(dtype)
        out = c if out is None else out + c
    return out


def _dispatch_compute_combine(p, xt, topw, tope, C, cfg, experts=None,
                              partial_dtype=None, rank=None, keep=None):
    """One dispatch group: xt (T, D) -> (T, D), through (n, C, D) capacity
    buffers.  ``experts`` = (first, count) restricts the buffer and the
    products to that block of experts (``p``'s expert weights are that
    block; default all E): only the rows kept for it are gathered, and only
    its outputs weighed, so the result is this block's share of the
    combine, summed over k in ``partial_dtype`` (default: the
    activations').  ``rank`` is each entry's slot in its expert's buffer
    (default: its rank in token order, ``_slot_ranks``), and ``keep`` which
    entries the capacity keeps (default: those whose rank is below C); a
    mesh keeps by the global slots and fills a buffer sized by its own
    tokens."""
    T, D = xt.shape
    E, K = cfg.n_e, cfg.top_k
    dev = xt.device
    lo, n = experts or (0, E)
    e_flat = tope.reshape(-1)                                    # (T*K,)
    w_flat = topw.reshape(-1).to(xt.dtype)
    if rank is None:
        rank = _slot_ranks(e_flat, E)
    if keep is None:
        keep = rank < C
    mine = keep & (e_flat >= lo) & (e_flat < lo + n)
    slot = torch.where(mine, (e_flat - lo) * C + rank, n * C)
    # the (token, k) entry in each slot of the block, T*K where none
    src = torch.full((n * C + 1,), T * K, dtype=slot.dtype, device=dev
                     ).scatter_(0, slot, torch.arange(T * K, device=dev))[: n * C]
    buf = torch.cat([xt, xt.new_zeros(1, D)])[src // K].view(n, C, D)
    y = _experts(p, buf, cfg)
    w = torch.cat([w_flat, w_flat.new_zeros(1)])[src]
    return _weighed_sum_k(y.reshape(n * C, D), w, slot, K, partial_dtype)


def _group_local(p, x, cfg, G: int, terms: bool = False):
    """Group-local dispatch: G structural groups of the batch, a capacity
    per (group, expert); the products are plain einsums.  Returns (out,
    aux), or with ``terms`` (out, gates, top experts) for an aux loss
    taken over more groups than these."""
    b, s, D = x.shape
    E, K = cfg.n_e, cfg.top_k
    Tg = b * s // G
    dev = x.device
    xg = x.reshape(G, Tg, D)
    topw, tope, aux = _route(p, xg, cfg, terms=terms)
    C = _capacity(Tg, cfg)

    e_flat = tope.reshape(G, Tg * K)
    t_flat = torch.arange(Tg, device=dev).repeat_interleave(K)   # shared
    w_flat = topw.reshape(G, Tg * K).to(x.dtype)
    gix = torch.arange(G, device=dev)[:, None]

    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = _counts(e_flat, E, e_flat.dtype)                   # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank_sorted = (torch.arange(Tg * K, device=dev)[None]
                   - torch.gather(starts, 1, e_sorted))
    rank = torch.empty_like(e_flat).scatter_(1, order, rank_sorted)

    keep = rank < C
    slot = torch.where(keep, e_flat * C + rank, E * C)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buf[gix, slot] = xg[gix, t_flat[None]]
    buf = buf[:, : E * C].reshape(G, E, C, D)

    act = activation(cfg.act)
    h = torch.einsum("geca,eaf->gecf", buf, p["w1"])
    if cfg.gated_ffn:
        h = act(h) * torch.einsum("geca,eaf->gecf", buf, p["w3"])
    else:
        h = act(h)
    y = torch.einsum("gecf,efa->geca", h, p["w2"])

    y_flat = y.reshape(G, E * C, D)
    gathered = torch.where(keep[..., None],
                           y_flat[gix, slot.clamp(max=E * C - 1)],
                           torch.zeros((), dtype=y.dtype, device=dev))
    out = _sum_k(gathered * w_flat[..., None], K)
    if terms:
        return (out.reshape(b, s, D),) + aux
    return out.reshape(b, s, D), aux


def moe_ffn(p: dict, x: torch.Tensor, cfg, *, policy=None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss).  On a mesh of more than one rank
    (``x`` a DTensor) ``out`` is a DTensor placed as the policy's ``"b s
    a"`` and ``aux_loss`` a plain tensor, the same on every rank (module
    docstring)."""
    from torch.distributed.tensor import DTensor

    b, s, D = x.shape
    G = max(1, cfg.moe_groups)
    grouped = G > 1 and b % G == 0
    if isinstance(x, DTensor):
        out, aux = (_group_local_placed(p, x, cfg, policy, mesh, G) if grouped
                    else _global_placed(p, x, cfg, policy, mesh))
    elif grouped:
        out, aux = _group_local(p, x, cfg, G)
    else:
        xt = x.reshape(b * s, D)
        topw, tope, aux = _route(p, xt, cfg)
        C = _capacity(b * s, cfg)
        out = _dispatch_compute_combine(p, xt, topw, tope, C, cfg)
        out = out.reshape(b, s, D)
    if cfg.shared_expert_ff:
        shared = ffn_mod.ffn(p["shared"], x, cfg)
        if isinstance(out, DTensor):
            from repro_torch.core.gspmd import constrain, spec_of_placements

            shared = constrain(shared, mesh, spec_of_placements(
                out.placements, 3, mesh))
        out = out + shared
    return out, aux


# ---------------------------------------------------------------------------
# Under a mesh of more than one rank
# ---------------------------------------------------------------------------


def _out_spec(x, policy, mesh) -> tuple:
    from repro_torch.models.policy import safe_spec

    return safe_spec(policy.act_spec("b s a"), x.shape, mesh)


def _global_placed(p, x, cfg, policy, mesh):
    """Global dispatch on DTensors (module docstring): (out placed as
    ``"b s a"``, aux loss)."""
    from repro_torch.core import gspmd

    b, s, D = x.shape
    E, K = cfg.n_e, cfg.top_k
    sizes = gspmd.mesh_sizes(mesh)

    def axes(*entries, drop=()):  # the split axes named, in mesh order
        named = {a for e in entries for a in gspmd.entry_axes(e)}
        return tuple(a for a in mesh.axis_names
                     if a in named and a not in drop and sizes[a] > 1)

    e_ent, _, f_ent = gspmd.spec_of_placements(p["w1"].placements, 3, mesh)
    b_ent, s_ent, _ = _out_spec(x, policy, mesh)
    f_axes = axes(f_ent)
    rows, seq = axes(b_ent, drop=f_axes), axes(s_ent, drop=f_axes)
    tok = axes(rows, seq)                   # the axes that split the tokens
    e_axes = axes(e_ent)
    a2a = tuple(a for a in e_axes if a in tok)
    grid = axes(e_ent, f_ent, drop=tok)     # blocks of the same tokens
    spec = (gspmd.entry_of(rows), gspmd.entry_of(seq), None)
    # each rank's tokens; where the experts or their width are split
    # across ranks holding the same tokens, each gradient is one share
    xl = gspmd.constrain(x, mesh, spec).to_local(
        grad_placements=gspmd.placements(spec, mesh, [(a, "sum") for a in grid]))
    lp = {"router": gspmd.local_param(p["router"], mesh, (None, None), tok + grid)}
    for k, wspec in (("w1", (e_ent, None, f_ent)), ("w2", (e_ent, f_ent, None)),
                     ("w3", (e_ent, None, f_ent))):
        if k in p:
            lp[k] = gspmd.local_param(p[k], mesh, wspec, tok)
    bw, sw = xl.shape[:2]
    xt = xl.reshape(bw * sw, D)
    topw, tope, (gates, _) = _route(lp, xt, cfg, terms=True)
    e_flat = tope.reshape(-1)
    C = _capacity(b * s, cfg)
    ranks = _slot_ranks(e_flat, E)

    # global slots: ranks among this rank's entries, plus the entries of
    # earlier rows and earlier sequence blocks of the same row
    counts = _counts(tope.reshape(bw, sw * K), E, torch.int32)  # (bw, E)
    allc = counts.unsqueeze(1)
    if tok:
        allc = gspmd.constrain(gspmd.wrap_block(allc, mesh, spec), mesh,
                               (None, None, None)).to_local()  # (b, s blocks, E)
    flat = allc.reshape(-1, E).long()
    off = (torch.cumsum(flat, 0) - flat).view(allc.shape)
    adj = (_block(off, mesh, rows, seq, mesh.coord)
           - (torch.cumsum(counts, 0, dtype=torch.long) - counts))
    row_of = torch.arange(bw, device=xt.device).repeat_interleave(sw * K)
    pos = ranks + adj[row_of, e_flat]

    n_blk = E // math.prod(sizes[a] for a in e_axes)
    lo = mesh.linear_index(e_axes) * n_blk
    partial = torch.float32 if grid else None
    if a2a:
        y = _dispatch_a2a(lp, xt, topw, e_flat, pos, C, cfg, mesh, allc,
                          rows, seq, e_axes, a2a, (lo, n_blk), partial)
    else:
        # the entries a rank keeps for an expert are the first of its own
        # (its ranks, not the global slots): a buffer as deep as the most
        # an expert of its block keeps, in the kernel's tiles
        kept, _ = _kept_counts(allc, sw * K, C, mesh)
        most = int(_block(kept, mesh, rows, seq, mesh.coord)[:, lo:lo + n_blk].sum(0).max())
        c_loc = min(C, max(128, -(-most // 128) * 128))
        y = _dispatch_compute_combine(lp, xt, topw, tope, c_loc, cfg,
                                      experts=(lo, n_blk), partial_dtype=partial,
                                      rank=ranks, keep=pos < C)

    # me and ce of the reference's aux loss, over the global tokens
    sums = torch.cat([torch.sum(gates.reshape(-1, E), dim=0),
                      torch.sum(counts, dim=0).to(torch.float32)])
    sums = gspmd.psum(sums, mesh, tok)
    T = b * s
    aux = E * torch.sum((sums[:E] / T) * (sums[E:] / (T * K)))
    y = y.reshape(bw, sw, D)
    if grid:
        # the aux loss's gradient reaches the router once over the grid
        first = float(mesh.linear_index(grid) == 0)
        aux = aux.detach() + (aux - aux.detach()) * first
        part = gspmd.wrap_block(y.unsqueeze(0), mesh, (gspmd.entry_of(grid),) + spec)
        out = torch.sum(part, dim=0)  # a partial sum over the grid
    else:
        out = gspmd.wrap_block(y, mesh, spec)
    out = gspmd.constrain(out, mesh, _out_spec(x, policy, mesh))
    return out.to(x.dtype), aux


def _even_counts(groups: int, n: int, E: int):
    """(groups, E) counts of groups of ``n`` entries, entry j of group q
    routed to expert (q n + j) mod E: the routing an abstract run assumes,
    every expert as loaded as any other."""
    q, e = np.arange(groups)[:, None], np.arange(E)[None]
    return n // E + ((e - q * n) % E < n % E).astype(np.int64)


def _kept_counts(allc, n, C, mesh):
    """(kept, earlier): of the all-gathered counts ``allc`` (b, s blocks,
    E) of ``n`` entries each, read on the host, how many entries of each
    (row, sequence block) each expert keeps, and how many it was bound
    before them.  An abstract mesh has no values: ``_even_counts`` stands
    in."""
    E = allc.shape[-1]
    if mesh.abstract:
        cnt = _even_counts(allc.shape[0] * allc.shape[1], n, E)
    else:
        cnt = allc.reshape(-1, E).cpu().numpy().astype(np.int64)
    off = np.cumsum(cnt, 0) - cnt
    return np.clip(C - off, 0, cnt).reshape(allc.shape), off.reshape(allc.shape)


def _block(t, mesh, rows, seq, coord):
    """A rank's (rows, E) share of a (b, s blocks, E) array: its batch rows
    along ``rows`` and its sequence block along ``seq``."""
    bw = t.shape[0] // math.prod(mesh.sizes[a] for a in rows)
    r0 = mesh.linear_index(rows, coord) * bw
    return t[r0:r0 + bw, mesh.linear_index(seq, coord)]


def _dispatch_a2a(lp, xt, topw, e_flat, pos, C, cfg, mesh, allc, rows, seq,
                  e_axes, a2a, experts, partial_dtype):
    """Global dispatch whose tokens and experts are split over the same
    axes ``a2a``: each kept (token, k) row goes to the rank of its expert
    block by one all-to-all over ``a2a`` and its output comes back by
    another.  The split sizes and the slots the rows land in follow from
    the all-gathered counts ``allc`` (b, s blocks, E), read on the host
    (an abstract mesh has no values: ``_even_counts`` stands in).  Returns
    this rank's tokens' combine (T_loc, D)."""
    from repro_torch.core import gspmd

    T, D = xt.shape
    E, K = cfg.n_e, cfg.top_k
    dev = xt.device
    lo, n_blk = experts
    sizes = gspmd.mesh_sizes(mesh)
    r = math.prod(sizes[a] for a in a2a)
    bw = allc.shape[0] // math.prod(sizes[a] for a in rows)
    kept, off = _kept_counts(allc, T * K // bw, C, mesh)

    # the a2a index of each expert's rank; -1 where its block lies off
    # this rank's coordinates along the experts' other axes (their ranks
    # hold these tokens too and take those entries themselves)
    dest = []
    for e in range(E):
        coord, j = dict(mesh.coord), e // n_blk
        for a in reversed(e_axes):
            j, coord[a] = divmod(j, sizes[a])
        same = all(coord[a] == mesh.coord[a] for a in e_axes if a not in a2a)
        dest.append(mesh.linear_index(a2a, coord) if same else -1)
    dest = np.asarray(dest)
    mine = _block(kept, mesh, rows, seq, mesh.coord)            # (bw, E)
    send = [int(mine[:, dest == i].sum()) for i in range(r)]
    # what each source sends here: by expert, then row, then slot
    recv, starts, lens = [], [], []
    for i in range(r):
        coord = mesh.coord_of(mesh.rank_at_linear(a2a, i))
        k_i = _block(kept, mesh, rows, seq, coord)[:, lo:lo + n_blk].T  # (n_blk, bw)
        o_i = _block(off, mesh, rows, seq, coord)[:, lo:lo + n_blk].T
        recv.append(int(k_i.sum()))
        starts.append((np.arange(n_blk)[:, None] * C + o_i).ravel())
        lens.append(k_i.ravel())
    starts, lens = np.concatenate(starts), np.concatenate(lens)
    n_recv = int(lens.sum())
    slots = (np.repeat(starts, lens) + np.arange(n_recv)
             - np.repeat(np.cumsum(lens) - lens, lens))
    slots = torch.as_tensor(slots, device=dev)

    d_e = torch.as_tensor(dest, device=dev)[e_flat]
    sent = (pos < C) & (d_e >= 0)
    key = torch.where(sent, d_e * E + e_flat, r * E)
    order = torch.argsort(key, stable=True)[: sum(send)]
    got = gspmd.all_to_all(xt[order // K], recv, send, mesh, a2a)
    buf = got.new_zeros(n_blk * C, D).index_copy(0, slots, got)
    y = _experts(lp, buf.view(n_blk, C, D), cfg)
    back = gspmd.all_to_all(y.reshape(n_blk * C, D)[slots], send, recv, mesh, a2a)
    n = back.shape[0]
    idx = torch.full((T * K,), n, dtype=order.dtype, device=dev).scatter_(
        0, order, torch.arange(n, device=dev))
    w = topw.reshape(-1).to(xt.dtype)[order]
    return _weighed_sum_k(back, w, idx, K, partial_dtype)


def _group_local_placed(p, x, cfg, policy, mesh, G: int):
    """Group-local dispatch on DTensors: the G groups split as the batch is
    (where the batch's axes divide G), each rank running ``_group_local``
    on its groups with the weights whole; the aux loss over every rank's
    groups."""
    from repro_torch.core import gspmd
    from repro_torch.models.policy import batch_entry

    b, s, D = x.shape
    E, K = cfg.n_e, cfg.top_k
    be = batch_entry(policy, mesh, G)
    rows = gspmd.entry_axes(be)
    r = math.prod(gspmd.mesh_sizes(mesh)[a] for a in rows)
    xl = gspmd.constrain(x, mesh, (be, None, None)).to_local()
    lp = {k: gspmd.local_param(w, mesh, (None,) * w.ndim, rows)
          for k, w in p.items() if k != "shared"}
    out, gates, tope = _group_local(lp, xl, cfg, G // r, terms=True)
    # me and ce of the reference's aux loss, over the global tokens
    sums = torch.cat([torch.sum(gates.reshape(-1, E), dim=0),
                      _counts(tope.reshape(-1), E, torch.float32)])
    sums = gspmd.psum(sums, mesh, rows)
    T = b * s
    aux = E * torch.sum((sums[:E] / T) * (sums[E:] / (T * K)))
    out = gspmd.wrap_block(out, mesh, (be, None, None))
    return gspmd.constrain(out, mesh, _out_spec(x, policy, mesh)), aux

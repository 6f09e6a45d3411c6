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
``mesh`` given) the layout is the one GSPMD gives the reference:

  * global dispatch routes all tokens together, so the capacity and the
    tokens a full expert drops are decided over the global batch, as on
    one rank: ``x`` is gathered whole on every rank (an all-gather of
    T x D), and the routing, the stable sort and the capacity slots run on
    every rank on plain local tensors, identically (DTensor propagates no
    ``scatter_`` or ``index_put_`` of the dispatch);
  * each rank fills the capacity buffer of its own expert block (the
    experts' mesh axes, read off the placement of ``w1``) and runs the
    three ``ops.gmm`` products on its blocks — (E/r, C, D) against its
    (E/r, D, F/r_f) and (E/r, F/r_f, D) weight blocks, where the policy
    also splits the expert width — with no communication;
  * each rank combines its experts' outputs into a partial sum over the
    expert and width axes (in float32 for a low-precision model, rounded
    once), which the ``"b s a"`` constraint reduces into place.  The
    router's gradient is then a partial sum over those axes too; the aux
    loss, the same on every rank, sends its gradient through the first
    rank of that grid only.
  * group-local dispatch keeps its G groups split as the batch is split,
    and runs on each rank's groups with the weights whole; its aux loss
    takes the mean gates and loads summed over every rank's groups.
"""
from __future__ import annotations

import math

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


def _dispatch_compute_combine(p, xt, topw, tope, C, cfg, experts=None,
                              partial_dtype=None):
    """One dispatch group: xt (T, D) -> (T, D).  ``experts`` = (first,
    count) restricts the capacity buffer and the products to that block
    of experts (``p``'s expert weights are that block); the result is then
    this block's share of the combine, summed over k in ``partial_dtype``
    (default: the activations')."""
    T, D = xt.shape
    E, K = cfg.n_e, cfg.top_k
    dev = xt.device
    e_flat = tope.reshape(-1)                                    # (T*K,)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    w_flat = topw.reshape(-1).to(xt.dtype)

    rank = _slot_ranks(e_flat, E)
    keep = rank < C
    if experts is not None:  # this rank's block of experts only
        lo, E = experts
        keep = keep & (e_flat >= lo) & (e_flat < lo + E)
        e_flat = e_flat - lo
    slot = torch.where(keep, e_flat * C + rank, E * C)           # overflow slot
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    buf[slot] = xt[t_flat]  # dropped tokens all land in the discarded row
    buf = buf[: E * C].view(E, C, D)

    act = activation(cfg.act)
    h = ops.gmm(buf, p["w1"])                                    # (E, C, F)
    if cfg.gated_ffn:
        h = act(h) * ops.gmm(buf, p["w3"])
    else:
        h = act(h)
    y = ops.gmm(h, p["w2"])                                      # (E, C, D)

    y_flat = y.reshape(E * C, D)
    gathered = torch.where(keep[:, None], y_flat[slot.clamp(max=E * C - 1)],
                           torch.zeros((), dtype=y.dtype, device=dev))
    contrib = gathered * w_flat[:, None]
    if partial_dtype is not None:
        contrib = contrib.to(partial_dtype)
    return _sum_k(contrib, K)


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
    E = cfg.n_e
    w1 = gspmd.spec_of_placements(p["w1"].placements, 3, mesh)
    e_ent, f_ent = w1[0], w1[2]
    e_axes = gspmd.entry_axes(e_ent)
    grid = tuple(a for a in mesh.axis_names
                 if a in e_axes or a in gspmd.entry_axes(f_ent))
    sizes = gspmd.mesh_sizes(mesh)
    whole = (None, None, None)
    # every token on every rank; the gradient of each rank's copy is its
    # expert block's share
    xl = gspmd.constrain(x, mesh, whole).to_local(
        grad_placements=gspmd.placements(whole, mesh,
                                         [(a, "sum") for a in grid]))
    lp = {"router": gspmd.local_param(p["router"], mesh, (None, None), grid),
          "w1": gspmd.constrain(p["w1"], mesh, (e_ent, None, f_ent)).to_local(),
          "w2": gspmd.constrain(p["w2"], mesh, (e_ent, f_ent, None)).to_local()}
    if cfg.gated_ffn:
        lp["w3"] = gspmd.constrain(p["w3"], mesh, (e_ent, None, f_ent)).to_local()
    xt = xl.reshape(b * s, D)
    topw, tope, aux = _route(lp, xt, cfg)
    n_blk = E // math.prod(sizes[a] for a in e_axes)
    lo = mesh.linear_index(e_axes) * n_blk
    y = _dispatch_compute_combine(
        lp, xt, topw, tope, _capacity(b * s, cfg), cfg, experts=(lo, n_blk),
        partial_dtype=torch.float32 if grid else None).reshape(b, s, D)
    if grid:
        # the aux loss's gradient reaches the router once over the grid
        first = float(mesh.linear_index(grid) == 0)
        aux = aux.detach() + (aux - aux.detach()) * first
        part = gspmd.wrap_block(y.unsqueeze(0), mesh,
                                (gspmd.entry_of(grid),) + whole)
        out = torch.sum(part, dim=0)  # a partial sum over the grid
    else:
        out = gspmd.wrap_block(y, mesh, whole)
    out = gspmd.constrain(out, mesh, _out_spec(x, policy, mesh))
    return out.to(x.dtype), aux


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
    sums = gspmd.wrap_block(sums.unsqueeze(0), mesh, (be, None))
    sums = gspmd.constrain(torch.sum(sums, dim=0), mesh, (None,)).to_local()
    T = b * s
    aux = E * torch.sum((sums[:E] / T) * (sums[E:] / (T * K)))
    out = gspmd.wrap_block(out, mesh, (be, None, None))
    return gspmd.constrain(out, mesh, _out_spec(x, policy, mesh)), aux

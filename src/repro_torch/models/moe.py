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
same bits every time.  ``policy`` and ``mesh`` are accepted and ignored:
MoE blocks run on one rank, and a mesh of more than one raises before
them (``transformer.check_mesh``; ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _route(p, xt, cfg):
    """xt (..., T, D) -> (top weights, top experts, aux loss)."""
    E = cfg.n_e
    logits = torch.matmul(xt, p["router"]).to(torch.float32)
    if cfg.n_experts < E:  # padded dispatch slots never win routing
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = logits + torch.where(pad, -1e30, 0.0)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(gates, cfg.top_k, dim=-1)  # sorted, descending
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(gates.reshape(-1, E), dim=0)
    ce = torch.mean(F.one_hot(tope.reshape(-1), E).to(torch.float32), dim=0)
    aux = E * torch.sum(me * ce)
    return topw, tope, aux


def _sum_k(vals: torch.Tensor, K: int) -> torch.Tensor:
    """(..., T*K, D) -> (..., T, D): each token's K contributions added in k
    order, in their dtype (the reference's scatter-add from zeros)."""
    v = vals.unflatten(-2, (vals.shape[-2] // K, K))
    out = v[..., 0, :]
    for k in range(1, K):
        out = out + v[..., k, :]
    return out


def _dispatch_compute_combine(p, xt, topw, tope, C, cfg):
    """One dispatch group: xt (T, D) -> (T, D)."""
    T, D = xt.shape
    E, K = cfg.n_e, cfg.top_k
    dev = xt.device
    e_flat = tope.reshape(-1)                                    # (T*K,)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    w_flat = topw.reshape(-1).to(xt.dtype)

    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e_flat)
    rank[order] = torch.arange(T * K, device=dev) - starts[e_sorted]

    keep = rank < C
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
    return _sum_k(gathered * w_flat[:, None], K)


def _group_local(p, x, cfg, G: int):
    """Group-local dispatch: G structural groups of the batch, a capacity
    per (group, expert); the products are plain einsums."""
    b, s, D = x.shape
    E, K = cfg.n_e, cfg.top_k
    Tg = b * s // G
    dev = x.device
    xg = x.reshape(G, Tg, D)
    topw, tope, aux = _route(p, xg, cfg)
    C = _capacity(Tg, cfg)

    e_flat = tope.reshape(G, Tg * K)
    t_flat = torch.arange(Tg, device=dev).repeat_interleave(K)   # shared
    w_flat = topw.reshape(G, Tg * K).to(x.dtype)
    gix = torch.arange(G, device=dev)[:, None]

    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = torch.sum(F.one_hot(e_flat, E), dim=1)             # (G, E)
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
    return out.reshape(b, s, D), aux


def moe_ffn(p: dict, x: torch.Tensor, cfg, *, policy=None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss)."""
    del policy, mesh  # one rank: transformer.check_mesh raises on more
    b, s, D = x.shape
    G = max(1, cfg.moe_groups)
    if G > 1 and b % G == 0:
        out, aux = _group_local(p, x, cfg, G)
    else:
        xt = x.reshape(b * s, D)
        topw, tope, aux = _route(p, xt, cfg)
        C = _capacity(b * s, cfg)
        out = _dispatch_compute_combine(p, xt, topw, tope, C, cfg)
        out = out.reshape(b, s, D)
    if cfg.shared_expert_ff:
        out = out + ffn_mod.ffn(p["shared"], x, cfg)
    return out, aux

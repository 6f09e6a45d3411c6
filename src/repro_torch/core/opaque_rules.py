"""Shard rules for opaque nodes: per-rank programs for fused ops.

An ``OpaqueShardRule`` turns (node, plan assignment, mesh sizes) into the
per-device program of a fused op (flash attention, MoE dispatch/combine,
recurrent scans).  The cost DP prices their internal movement through the
``comm`` declarations on the node's OpDef (``core/decomp._opaque_comm_cost``)
and ``validate_graph`` runs at plan time, so a plan never prices a schedule
no registered rule can lower.

Built-in rules (the registry; ``register_rule`` admits new ones):

  ``ring``      — sequence-parallel flash attention: q stays sharded on its
                  sequence axis, K/V circulate around the ring between
                  ranks (``batch_isend_irecv``) with the online-softmax
                  ``(m, l, acc)`` state carried across ring steps
                  (``kernels.ops.flash_attention_step``); causal /
                  sliding-window masks stay correct under rotation because
                  every step masks against the block's *absolute* kv offset.
                  With the ring label unsharded it is one local
                  ``kernels.ops.flash_attention`` call per rank.
  ``local``     — channel-parallel fused ops (the recurrent scans): each
                  rank runs the op on its local blocks, zero collectives.
  ``paged``     — the serving tier's block-table KV gather, zero
                  collectives.
  ``replicate`` — the fallback: gather inputs, run the fused op densely on
                  every rank, re-slice the output to the plan layout.
  ``a2a``       — expert-parallel MoE dispatch/combine: tokens stay
                  sequence-sharded, expert buffers expert-sharded; a tiny
                  all-gather of per-expert counts fixes every token's
                  global capacity slot, and ``all_to_all`` moves the slot
                  indices and the token payloads.

A rule's ``run(args, ctx)`` executes on every rank: ``args`` are the local
blocks, ``ctx`` the ``spmd.StepContext`` (this rank's mesh coordinate and
its collectives).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core import spmd as _spmd
from repro_torch.core.einsum import EinGraph, Node

#: step tuple shape shared with core/spmd.py (("slice", ax, dim), ...)
Layout = _spmd.Layout

_KIND_TO_RULE = {"ring": "ring", "a2a": "a2a"}


# ---------------------------------------------------------------------------
# Protocol + lowering result
# ---------------------------------------------------------------------------


@dataclass
class RuleLowering:
    """What a rule contributes to the static schedule for one opaque node:
    the layouts the executor repartitions each input into (``arg_layouts``),
    the output layout after ``post_steps``, the rule's internal collectives
    pre-priced as ``(kind, axes, elems, nbytes)`` events (an optional 5th
    element marks the event as overlapped with local compute, a 6th gives
    a ppermute's exact (src, dst) pairs), and ``run(args, ctx)``, the
    node's local program on each rank."""

    arg_layouts: list[Layout]
    out_layout: Layout
    run: Callable[[Sequence[Any], Any], Any]
    post_steps: list[tuple] = field(default_factory=list)
    events: list[tuple] = field(default_factory=list)


@runtime_checkable
class OpaqueShardRule(Protocol):
    """Given a node, its plan assignment and the mesh, emit the per-device
    program.  ``lower`` returns ``None`` when the rule's structural
    preconditions do not hold — the executor then falls back to
    ``replicate``."""

    name: str

    def lower(self, g: EinGraph, node: Node,
              ax_n: dict[str, tuple[str, ...]],
              sizes: dict[str, int]) -> RuleLowering | None: ...


# ---------------------------------------------------------------------------
# Registry + resolution
# ---------------------------------------------------------------------------

RULES: dict[str, OpaqueShardRule] = {}


def register_rule(rule: OpaqueShardRule) -> None:
    RULES[rule.name] = rule


def get_rule(name: str) -> OpaqueShardRule:
    return RULES[name]


def resolve_rule_name(node: Node) -> str:
    """Rule name declared for a node: its comm entries (explicit ``rule``
    key, else derived from ``kind``), falling back to the OpDef's bound
    ``shard_rule``; ``replicate`` when nothing is declared.  The comm
    declaration itself resolves through the OpDef
    (``opdef.comm_for_node``); explicit node params still override."""
    from repro_torch.core import opdef

    names = set()
    for entry in opdef.comm_for_node(node):
        name = entry.get("rule") or _KIND_TO_RULE.get(entry.get("kind"))
        if name is not None:
            names.add(name)
    if not names:
        return opdef.shard_rule_for_node(node) or "replicate"
    if len(names) > 1:
        raise ValueError(
            f"node {node.name!r}: comm entries declare conflicting shard "
            f"rules {sorted(names)} — one rule lowers the whole node")
    return names.pop()


def validate_graph(g: EinGraph) -> None:
    """Plan-time validation: every opaque node's declaration (OpDef comm
    template or per-node override) must resolve to a registered rule with
    known kinds, so the DP never prices a schedule the executor cannot
    lower."""
    from repro_torch.core import opdef

    for n in g.nodes:
        if n.kind != "opaque":
            continue
        for entry in opdef.comm_for_node(n):
            if entry.get("kind") not in _KIND_TO_RULE:
                raise ValueError(
                    f"node {n.name!r}: comm kind {entry.get('kind')!r} "
                    f"unknown (expected one of {sorted(_KIND_TO_RULE)})")
        name = resolve_rule_name(n)
        if name not in RULES:
            raise ValueError(
                f"node {n.name!r}: comm declares shard rule {name!r}, but "
                f"only {sorted(RULES)} are registered "
                "(core.opaque_rules.register_rule)")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


# byte accounting must match the einsum path's exactly: share spmd's helper
_itemsize = _spmd._itemsize


def moe_route(route):
    """Deterministic top-1 routing in sequence-major token order.

    ``route (B, S, E)`` -> ``(expert (T,), pos (T,), gate (T,), cnt (E,))``
    with ``T = S*B`` and token ``t = s*B + b``.  ``pos`` is the token's
    global slot within its expert — the count of *earlier* (sequence-major)
    tokens routed to the same expert — so capacity cutoffs (``pos >=
    capacity`` drops the token) are identical between the dense stubs
    (``models/opaque_stubs.py``) and the sharded a2a rule, whose per-rank
    counts only need a prefix over earlier sequence shards.  ``argmax``
    takes the first maximum, as ``jnp.argmax`` does; slots and counts are
    int32.
    """
    route = torch.as_tensor(route)
    B, S, E = route.shape
    r2 = route.transpose(0, 1).reshape(S * B, E)
    gates = torch.softmax(r2, dim=-1)
    expert = torch.argmax(r2, dim=-1)
    oneh = (expert[:, None] == torch.arange(E, device=route.device)[None, :]
            ).to(torch.int32)
    pos = (torch.cumsum(oneh, 0, dtype=torch.int32) - oneh).gather(
        1, expert[:, None])[:, 0]
    gate = gates.gather(1, expert[:, None])[:, 0]
    cnt = torch.sum(oneh, dim=0, dtype=torch.int32)
    return expert, pos, gate, cnt


def _rank_by(dest, n: int):
    """Rank of each token among the tokens sharing its destination (the
    packing order both sides of an all_to_all agree on)."""
    oneh = (dest[:, None] == torch.arange(n, device=dest.device)[None, :]
            ).to(torch.int32)
    return (torch.cumsum(oneh, 0, dtype=torch.int32) - oneh).gather(
        1, dest[:, None])[:, 0]


# ---------------------------------------------------------------------------
# replicate: the always-correct fallback
# ---------------------------------------------------------------------------


class ReplicateRule:
    """Gather every input to replicated, run the fused op densely on all
    ranks, re-slice the output to the plan layout (local, free)."""

    name = "replicate"

    def lower(self, g, node, ax_n, sizes):
        arg_layouts = [tuple(() for _ in g.nodes[a].shape)
                       for a in node.inputs]
        out_layout = _spmd._plan_layout(node, ax_n, sizes)
        post_steps = _spmd.plan_repart(tuple(() for _ in node.shape),
                                       out_layout)

        def run(args, ctx):
            from repro_torch.core import engine

            return engine.OPAQUE_FNS[node.op](*args, **node.call_params)

        return RuleLowering(arg_layouts=arg_layouts, out_layout=out_layout,
                            run=run, post_steps=post_steps)


# ---------------------------------------------------------------------------
# local: channel-parallel fused ops (recurrent scans) — zero collectives
# ---------------------------------------------------------------------------


class LocalRule:
    """Run the fused op on local blocks, no movement at all.

    An OpDef binds this rule to assert the op is *independent along every
    shardable label*: the local block of the output equals the global op
    applied to the local blocks of the inputs (the recurrent scans: the
    scan runs along the non-shardable sequence label, channel and batch
    labels are independent).

    Structural preconditions (``None`` → replicate): per-input labels are
    declared; a sharded label appearing in an input must also appear in
    the output; every sharded label's extent divides its shard count.
    """

    name = "local"

    def lower(self, g, node, ax_n, sizes):
        if not node.in_labels or len(node.in_labels) != len(node.inputs):
            return None

        def norm(label):
            return _spmd._norm_axes(ax_n.get(label, ()), sizes)

        in_label_set = {l for ls in node.in_labels for l in ls}
        arg_layouts: list[Layout] = []
        for ls, a in zip(node.in_labels, node.inputs):
            lay = []
            for l, b in zip(ls, g.nodes[a].shape):
                axes = norm(l)
                if axes and l not in node.labels:
                    return None  # sharded label vanishes: not local
                if b % max(_prod(sizes[x] for x in axes), 1):
                    return None
                lay.append(axes)
            arg_layouts.append(tuple(lay))
        out_layout = []
        for l, b in zip(node.labels, node.shape):
            axes = norm(l)
            if axes and l not in in_label_set:
                return None  # output-only sharded label: nothing to slice by
            if b % max(_prod(sizes[x] for x in axes), 1):
                return None
            out_layout.append(axes)

        def run(args, ctx):
            from repro_torch.core import opdef

            return opdef.executable(node.op)(*args, **node.call_params)

        return RuleLowering(arg_layouts=arg_layouts,
                            out_layout=tuple(out_layout), run=run)


# ---------------------------------------------------------------------------
# ring: sequence-parallel flash attention
# ---------------------------------------------------------------------------


class RingAttentionRule:
    """K/V circulate the ring; q stays put; (m, l, acc) carried across
    steps.  Structural contract: 3 inputs labeled ``q (b, h, s, d)``,
    ``k/v (b, k, ℓ, d)`` with ``ℓ`` the comm-declared ring label (``s``
    shared with q in prefill, the cache-time label in decode).  The q-head
    and kv-head dims are co-sharded on the union of their planned axes so
    the local GQA group mapping equals the global one; the head_dim must be
    unsharded.  When the ring label is unsharded the rule degenerates to
    one local flash-attention call per rank — zero collectives, which is
    exactly what the DP priced.

    On the ring each rank folds the K/V block it holds into its carry with
    the step kernel, then passes the block to the next rank and receives
    the previous rank's (``batch_isend_irecv``).  With ``double_buffer``
    (the default) step t+1's exchange is started before step t's fold —
    the hop has no data dependency on the fold, so the transfer overlaps
    the compute — and waited on after it.  The values are identical, only
    the issue order changes, and the trace marks the hops ``overlap=True``.
    The offsets are Python ints from this rank's coordinate."""

    name = "ring"
    double_buffer = True

    def lower(self, g, node, ax_n, sizes):
        if node.op != "flash_attention" or len(node.inputs) != 3:
            return None
        if len(node.in_labels) != 3 or any(len(ls) != 4
                                           for ls in node.in_labels):
            return None
        lq, lk, lv = node.in_labels
        if lk != lv:
            return None
        from repro_torch.core import opdef

        ring_labels = {c["label"] for c in opdef.comm_for_node(node)
                       if c.get("kind") == "ring"}
        if len(ring_labels) != 1:
            return None
        ell = next(iter(ring_labels))
        b_l, h_l, sq_l, d_l = lq
        if lk[0] != b_l or lk[2] != ell or lk[3] != d_l:
            return None
        if tuple(node.labels) != (b_l, h_l, sq_l, d_l):
            return None
        k_l = lk[1]

        def norm(label):
            return _spmd._norm_axes(ax_n.get(label, ()), sizes)

        ba, ha, ka, ra, da = norm(b_l), norm(h_l), norm(k_l), norm(ell), \
            norm(d_l)
        if da:
            return None  # head_dim sharded: no local kernel call possible
        if sq_l != ell and norm(sq_l):
            return None  # decode: a sharded q-seq has no ring to ride
        head_axes = ha + tuple(a for a in ka if a not in ha)

        qn = g.nodes[node.inputs[0]]
        kn = g.nodes[node.inputs[1]]
        h_total, k_total = qn.shape[1], kn.shape[1]
        ph = _prod(sizes[a] for a in head_axes)
        r = _prod(sizes[a] for a in ra)
        if (k_total == 0 or h_total % k_total or h_total % max(ph, 1)
                or k_total % max(ph, 1)):
            return None
        if kn.shape[2] % max(r, 1) or (sq_l == ell and qn.shape[2] % max(r, 1)):
            return None

        q_ring = sq_l == ell
        q_layout: Layout = (ba, head_axes, ra if q_ring else (), ())
        kv_layout: Layout = (ba, head_axes, ra, ())
        sizes = dict(sizes)
        call = dict(node.call_params)

        db = bool(self.double_buffer)
        events: list[tuple] = []
        if r > 1:
            n_dev = _prod(sizes.values())
            n_loc = _prod(_spmd.local_shape(kn.shape, kv_layout, sizes))
            item = _itemsize(kn.dtype)
            ring_perm = tuple((i, (i + 1) % r) for i in range(r))
            for _step in range(r - 1):
                for _tensor in range(2):  # k and v each take the ring hop
                    events.append(("ppermute", tuple(ra), n_dev * n_loc,
                                   n_dev * n_loc * item, db, ring_perm))

        def run(args, ctx):
            from repro_torch.kernels import ops

            q, k, v = args
            causal = call.get("causal", True)
            window = call.get("window", 0)
            scale = call.get("scale")
            q0 = call.get("q_offset", 0)
            if r <= 1:
                return ops.flash_attention(q, k, v, causal=causal,
                                           window=window, scale=scale,
                                           q_offset=q0)
            idx = ctx.mesh.linear_index(ra)
            sq_loc, sk_loc = q.shape[2], k.shape[2]
            q_off = q0 + idx * sq_loc if q_ring else q0
            carry = None
            for t in range(r):
                j = (idx - t) % r  # kv block resident at ring step t
                if db and t < r - 1:
                    # double buffer: start block t+1's exchange before
                    # block t's fold — no data dependency between them
                    nxt = ctx.ring_shift([k, v], tuple(ra))
                carry = ops.flash_attention_step(
                    q, k, v, carry, causal=causal, window=window, scale=scale,
                    q_offset=q_off, kv_offset=j * sk_loc)
                if t < r - 1:
                    if not db:
                        nxt = ctx.ring_shift([k, v], tuple(ra))
                    k, v = nxt.wait()
            return ops.attention_finalize(carry, q.dtype)

        return RuleLowering(arg_layouts=[q_layout, kv_layout, kv_layout],
                            out_layout=q_layout, run=run, events=events)


# ---------------------------------------------------------------------------
# paged: the serving tier's block-table KV gather — zero collectives
# ---------------------------------------------------------------------------


class PagedKVRule:
    """Per-shard lowering of ``kv_block_gather`` (the paged KV cache).

    The gather is independent along batch, kv-heads and head_dim: each
    rank looks its own table rows up in its own pool shard.  Structural
    contract: inputs ``pool (n, p, k, d)`` / ``tables (b, w)``, output
    ``(b, k, t, d)``; the block-index labels ``n``/``p``/``w`` must be
    unsharded, the pool is co-sharded with the output on the head labels,
    the table on batch.  A sharded cache-time label ``t`` is realized
    locally too when ``t = w*p`` exactly and the shard count divides ``w``
    (each rank's t-stripe is a whole number of blocks).  Zero wire either
    way; any failed precondition returns ``None`` → replicate fallback.
    """

    name = "paged"

    def lower(self, g, node, ax_n, sizes):
        if node.op != "kv_block_gather" or len(node.inputs) != 2:
            return None
        if len(node.in_labels) != 2 or len(node.in_labels[0]) != 4 \
                or len(node.in_labels[1]) != 2:
            return None
        n_l, p_l, k_l, d_l = node.in_labels[0]
        b_l, w_l = node.in_labels[1]
        if len(node.labels) != 4:
            return None
        t_l = node.labels[2]
        if tuple(node.labels) != (b_l, k_l, t_l, d_l):
            return None

        def norm(label):
            return _spmd._norm_axes(ax_n.get(label, ()), sizes)

        if norm(n_l) or norm(p_l) or norm(w_l):
            return None  # block-index labels stay whole
        ba, ka, ta, da = norm(b_l), norm(k_l), norm(t_l), norm(d_l)
        pool_n = g.nodes[node.inputs[0]]
        tab_n = g.nodes[node.inputs[1]]
        _n_blk, blk, kh, hd = pool_n.shape
        batch, w = tab_n.shape
        kv_len = node.shape[2]
        for extent, axes in ((batch, ba), (kh, ka), (hd, da)):
            if extent % max(_prod(sizes[x] for x in axes), 1):
                return None
        rt = _prod(sizes[x] for x in ta)
        if rt > 1 and (kv_len != w * blk or w % rt):
            return None  # t-stripes must be whole blocks, no truncated tail

        def run(args, ctx):
            from repro_torch.kernels import ops

            pool, tables = args
            kvl = kv_len if rt <= 1 else tables.shape[1] * pool.shape[1]
            return ops.kv_block_gather(pool, tables, kvl)

        return RuleLowering(
            arg_layouts=[((), (), ka, da), (ba, ta)],
            out_layout=(ba, ka, ta, da), run=run)


# ---------------------------------------------------------------------------
# a2a: expert-parallel MoE dispatch / combine
# ---------------------------------------------------------------------------


def _global_slots(route, ctx, a2a_axes, r: int, e_blk: int, cap: int):
    """This rank's tokens (sequence-major): (gate, keep, the rank owning
    the expert, the slot in its (e_blk*cap) buffer or -1, the token's rank
    among those bound for the same owner).  Global slots add the counts of
    the earlier sequence shards (one all-gather)."""
    expert, pos_l, gate, cnt = moe_route(route)
    idx = ctx.mesh.linear_index(a2a_axes)
    allc = ctx.all_gather_stacked(cnt, a2a_axes)               # (r, E)
    pos = pos_l + torch.sum(allc[:idx], dim=0, dtype=torch.int32)[expert]
    keep = pos < cap
    owner = expert // e_blk
    slot = torch.where(keep, (expert % e_blk) * cap + pos,
                       -1).to(torch.int32)
    return gate, keep, owner, slot, _rank_by(owner, r)


class A2AMoERule:
    """Tokens stay sequence-sharded; expert buffers stay expert-sharded;
    the only bulk movement is an all_to_all of token payloads (plus a tiny
    all-gather of per-expert counts that fixes the global capacity slots,
    and for dispatch or combine an int32 slot all_to_all).  Preconditions:
    the expert label carries the a2a mesh axes and divides E; the sequence
    extent divides the shard count.  The three collectives each rank
    issues per node are the three static events of ``_events``."""

    name = "a2a"

    def lower(self, g, node, ax_n, sizes):
        if node.op == "moe_dispatch":
            return self._lower_dispatch(g, node, ax_n, sizes)
        if node.op == "moe_combine":
            return self._lower_combine(g, node, ax_n, sizes)
        return None

    @staticmethod
    def _norm(ax_n, sizes, label):
        return _spmd._norm_axes(ax_n.get(label, ()), sizes)

    @staticmethod
    def _events(a2a_axes, n_dev, r, n_exp, t_loc, d_model, item):
        return [
            ("all_gather", tuple(a2a_axes), n_dev * (r - 1) * n_exp,
             n_dev * (r - 1) * n_exp * 4),
            ("all_to_all", tuple(a2a_axes), n_dev * (r - 1) * t_loc,
             n_dev * (r - 1) * t_loc * 4),
            ("all_to_all", tuple(a2a_axes), n_dev * (r - 1) * t_loc * d_model,
             n_dev * (r - 1) * t_loc * d_model * item),
        ]

    def _lower_dispatch(self, g, node, ax_n, sizes):
        # x (b, s, a), route (b, s, e) -> out (e, c, a)
        if len(node.inputs) != 2 or len(node.in_labels) != 2:
            return None
        lx, lr = node.in_labels
        if len(lx) != 3 or len(lr) != 3 or lx[:2] != lr[:2]:
            return None
        e_l, c_l, a_l = node.labels
        if lr[2] != e_l or lx[2] != a_l:
            return None
        a2a_axes = self._norm(ax_n, sizes, e_l)
        if self._norm(ax_n, sizes, a_l):
            return None
        r = _prod(sizes[a] for a in a2a_axes)
        if r <= 1:
            return None  # nothing crosses experts: dense replicate is priced
        xn = g.nodes[node.inputs[0]]
        batch, seq, d_model = xn.shape
        n_exp, cap, _ = node.shape
        if n_exp % r or seq % r:
            return None
        ca = self._norm(ax_n, sizes, c_l)
        if any(a in a2a_axes for a in ca):
            return None
        events = self._events(a2a_axes, _prod(sizes.values()), r, n_exp,
                              batch * (seq // r), d_model,
                              _itemsize(xn.dtype))
        e_blk = n_exp // r

        def run(args, ctx):
            x, route = args
            _gate, _keep, dest, slot, rank = _global_slots(
                route, ctx, a2a_axes, r, e_blk, cap)
            d = x.shape[-1]
            xt = x.transpose(0, 1).reshape(-1, d)                # (t_loc, D)
            t_loc = xt.shape[0]
            send_val = torch.zeros((r, t_loc, d), dtype=x.dtype,
                                   device=x.device)
            send_val[dest, rank] = xt
            send_slot = torch.full((r, t_loc), -1, dtype=torch.int32,
                                   device=x.device)
            send_slot[dest, rank] = slot
            recv_val = ctx.all_to_all_stacked(send_val, a2a_axes)
            recv_slot = ctx.all_to_all_stacked(send_slot, a2a_axes)
            rs = recv_slot.reshape(-1).long()
            valid = rs >= 0
            out = torch.zeros((e_blk * cap, d), dtype=x.dtype, device=x.device)
            out[rs[valid]] = recv_val.reshape(-1, d)[valid]  # slots are unique
            return out.reshape(e_blk, cap, d)

        return RuleLowering(
            arg_layouts=[((), tuple(a2a_axes), ()), ((), tuple(a2a_axes), ())],
            out_layout=(tuple(a2a_axes), tuple(ca), ()), run=run,
            post_steps=[("slice", ax, 1) for ax in ca], events=events)

    def _lower_combine(self, g, node, ax_n, sizes):
        # y (e, c, a), route (b, s, e) -> out (b, s, a)
        if len(node.inputs) != 2 or len(node.in_labels) != 2:
            return None
        ly, lr = node.in_labels
        if len(ly) != 3 or len(lr) != 3:
            return None
        e_l, c_l, a_l = ly
        b_l, s_l, a_out = node.labels
        if lr[2] != e_l or lr[:2] != (b_l, s_l) or a_out != a_l:
            return None
        a2a_axes = self._norm(ax_n, sizes, e_l)
        if self._norm(ax_n, sizes, a_l):
            return None
        r = _prod(sizes[a] for a in a2a_axes)
        if r <= 1:
            return None
        yn = g.nodes[node.inputs[0]]
        n_exp, cap, d_model = yn.shape
        batch, seq, _ = node.shape
        if n_exp % r or seq % r:
            return None
        events = self._events(a2a_axes, _prod(sizes.values()), r, n_exp,
                              batch * (seq // r), d_model,
                              _itemsize(yn.dtype))
        e_blk = n_exp // r

        def run(args, ctx):
            y, route = args
            gate, keep, owner, slot, rank = _global_slots(
                route, ctx, a2a_axes, r, e_blk, cap)
            t_loc = owner.shape[0]
            send_req = torch.full((r, t_loc), -1, dtype=torch.int32,
                                  device=y.device)
            send_req[owner, rank] = slot
            recv_req = ctx.all_to_all_stacked(send_req, a2a_axes).long()
            valid = (recv_req >= 0)[..., None].to(y.dtype)
            vals = y.reshape(e_blk * cap, d_model)[recv_req.clamp(min=0)] * valid
            back = ctx.all_to_all_stacked(vals, a2a_axes)          # (r, t_loc, D)
            out = back[owner, rank] * (gate * keep).to(y.dtype)[:, None]
            b_loc, s_loc = route.shape[0], route.shape[1]
            return out.reshape(s_loc, b_loc, d_model).transpose(0, 1)

        return RuleLowering(
            arg_layouts=[(tuple(a2a_axes), (), ()), ((), tuple(a2a_axes), ())],
            out_layout=((), tuple(a2a_axes), ()), run=run, events=events)


register_rule(ReplicateRule())
register_rule(LocalRule())
register_rule(RingAttentionRule())
register_rule(A2AMoERule())
register_rule(PagedKVRule())

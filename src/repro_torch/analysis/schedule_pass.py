"""Schedule pass (RA2xx): safety properties of the *static* collective
schedule (``spmd.build_schedule`` — pure Python, no backend).

The executor trusts this schedule: a non-bijective ppermute deadlocks or
silently drops shards at run time, a donated buffer read after its
aliasing step returns garbage, and a repartition chain whose shape
evolution breaks raises deep inside shard_map.  This pass verifies the
recorded schedule — including the exact ppermute (src, dst) pairs the
executor will issue (``CollectiveEvent.perm``) and the planner bounds the
benches assert dynamically (traced ≤ priced, per ruled opaque node and for
the whole program).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core import opdef
from repro_torch.core.decomp import Plan, opaque_node_bound
from repro_torch.core.einsum import EinGraph
from repro_torch.core.spmd import Schedule, _step_shape, _wire_elems, local_shape

from repro_torch.analysis.findings import Finding, WARNING

#: rules whose per-node traced-vs-bound contract holds on every zoo cell.
#: ``local`` is deliberately absent: its zero-collective scan contract is
#: pinned dynamically (bench_spmd, prefill), but decode plans may pay a
#: producer-layout gather that cost_repart ring-prices below the
#: all_gather's wire accounting — a known pricing slack, not a schedule bug.
_BOUNDED_RULES = ("ring", "a2a")


def _f(code: str, msg: str, n, severity: str = "") -> Finding:
    return Finding(code, msg, severity=severity, nid=n.nid, node=n.name,
                   srcloc=n.srcloc)


def _group_size(axes, sizes: dict[str, int]) -> int:
    return math.prod(sizes.get(a, 1) for a in axes)


def _replay_chain(shape: tuple[int, ...], steps, sizes: dict[str, int]
                  ) -> tuple[tuple[int, ...] | None, str]:
    """Replay one repartition chain; ("", final shape) on success, else an
    error string naming the offending step."""
    s = list(shape)
    for st in steps:
        kind = st[0]
        try:
            if kind == "all_gather":
                s[st[2]] *= sizes[st[1]]
            elif kind == "all_to_all":
                _, ax, i, j = st
                k = sizes[ax]
                if s[j] % k:
                    return None, (f"all_to_all over {ax!r} (x{k}) does not "
                                  f"divide dim {j} of {tuple(s)}")
                s[i] *= k
                s[j] //= k
            elif kind in ("slice", "psum_scatter"):
                k = sizes[st[1]]
                if s[st[2]] % k:
                    return None, (f"{kind} over {st[1]!r} (x{k}) does not "
                                  f"divide dim {st[2]} of {tuple(s)}")
                s[st[2]] //= k
            elif kind == "psum_scatter_grouped":
                for ax, d in st[1]:
                    k = sizes[ax]
                    if s[d] % k:
                        return None, (f"grouped psum_scatter over {ax!r} "
                                      f"(x{k}) does not divide dim {d} of "
                                      f"{tuple(s)}")
                    s[d] //= k
            # ppermute / psum / pmax / pmin / gather_reduce keep the shape
        except (IndexError, KeyError) as e:
            return None, f"step {st!r} is malformed for shape {tuple(s)}: {e}"
    return tuple(s), ""


def analyze_schedule(g: EinGraph, plan: Plan | None, sched: Schedule,
                     out_ids=None, donate: Sequence[str] = ()
                     ) -> list[Finding]:
    findings: list[Finding] = []
    sizes = sched.sizes
    trace = sched.trace
    consumers = g.consumers()
    out_set = set(out_ids) if out_ids is not None else set(g.outputs())

    # RA201: ppermute permutation bijectivity ------------------------------
    for e in trace.events:
        if e.kind != "ppermute":
            continue
        n = g.nodes[e.nid]
        group = _group_size(e.axes, sizes)
        if not e.perm:
            findings.append(_f(
                "RA201", f"ppermute over {e.axes} carries no (src, dst) "
                         "pairs — bijectivity cannot be verified",
                n, severity=WARNING))
            continue
        srcs = [p[0] for p in e.perm]
        dsts = [p[1] for p in e.perm]
        bad = []
        if len(e.perm) != group:
            bad.append(f"{len(e.perm)} pairs for a {group}-device group")
        if len(set(srcs)) != len(srcs):
            bad.append("duplicate sources (a device sends twice: deadlock)")
        if len(set(dsts)) != len(dsts):
            bad.append("duplicate destinations (shards collide: data loss)")
        outside = [v for v in srcs + dsts if not 0 <= v < group]
        if outside:
            bad.append(f"indices {sorted(set(outside))} outside the "
                       f"{group}-device group {e.axes}")
        if bad:
            findings.append(_f(
                "RA201", f"ppermute over {e.axes}: " + "; ".join(bad), n))

    # RA202/RA207: donation-aliasing safety --------------------------------
    by_name = {n.name: n for n in g.nodes if n.kind == "input"}
    for name in donate:
        n = by_name.get(name)
        if n is None:
            continue  # unknown donate names are a compile-time KeyError
        cons = sorted(consumers.get(n.nid, []))
        if not cons and n.nid not in out_set:
            findings.append(_f(
                "RA207", f"donated input {name!r} is never read — the "
                         "donation frees nothing", n))
            continue
        # the aliasing step is the first consumer (topo order): once it
        # runs, the donated buffer may have been overwritten in place
        if len(cons) > 1:
            later = [f"{g.nodes[c].name} (node {c})" for c in cons[1:]]
            findings.append(_f(
                "RA202", f"donated input {name!r} is read again after its "
                         f"aliasing step (node {cons[0]}, "
                         f"{g.nodes[cons[0]].name}) by {', '.join(later)}",
                n))
        if cons and n.nid in out_set:
            findings.append(_f(
                "RA202", f"donated input {name!r} is consumed and also "
                         "returned as a program output — the returned "
                         "buffer may alias the overwritten donation", n))

    # RA203: repartition-chain shape evolution -----------------------------
    for prog in sched.programs:
        n = g.nodes[prog.nid]
        for i, (a, steps) in enumerate(zip(n.inputs, prog.arg_steps)):
            if not steps:
                continue
            try:
                start = local_shape(g.nodes[a].shape, sched.layouts[a],
                                    sizes)
            except (ValueError, KeyError) as e:
                findings.append(_f(
                    "RA203", f"arg {i} ({g.nodes[a].name}): producer "
                             f"layout is not realizable: {e}", n))
                continue
            _, err = _replay_chain(start, steps, sizes)
            if err:
                findings.append(_f(
                    "RA203", f"arg {i} ({g.nodes[a].name}): {err}", n))
        # post_steps are not replayed: they start from the node's *compute*
        # shape (pre-reduction for einsum, the rule's out_layout for
        # opaque), which the Schedule does not record — build_schedule
        # itself asserts their evolution at lowering time

    # RA204: double-buffer overlap hazards ---------------------------------
    # (graph-wide lookahead prefetches also ride the overlap mark but are
    # attributed via prefetch_for and audited by RA208 below — the ring
    # rule's per-hop accounting must not see them)
    overlap_by_node: dict[int, int] = {}
    for e in trace.events:
        if not e.overlap or e.prefetch_for >= 0:
            continue
        n = g.nodes[e.nid]
        if not e.rule:
            findings.append(_f(
                "RA204", f"overlapped {e.kind} emitted outside any shard "
                         "rule — there is no compute loop to overlap "
                         "with", n))
        if e.kind != "ppermute":
            findings.append(_f(
                "RA204", f"overlapped {e.kind}: only ring ppermute hops "
                         "are double-buffered", n, severity=WARNING))
        else:
            overlap_by_node[e.nid] = overlap_by_node.get(e.nid, 0) + 1
    for nid, count in sorted(overlap_by_node.items()):
        n = g.nodes[nid]
        ring_entries = [e for e in opdef.comm_for_node(n)
                        if e.get("kind") == "ring"]
        hops = [e for e in trace.events
                if e.nid == nid and e.kind == "ppermute" and e.overlap]
        r = _group_size(hops[0].axes, sizes) if hops else 1
        limit = max(len(ring_entries), 1) * max(r - 1, 0)
        if count > limit:
            findings.append(_f(
                "RA204", f"over-rotated ring: {count} overlapped hops for "
                         f"{len(ring_entries)} circulating tensors on a "
                         f"{r}-device ring (limit {limit}) — the last "
                         "rotation returns data already seen", n))

    # RA208: lookahead prefetch hazards ------------------------------------
    # A hoisted issue is only safe when the consumer's argument is already
    # producible at the issue point: its producer's compute (topo position
    # == nid) must precede the issue node's iteration.  Two lifetimes for
    # one (consumer, arg) would alias one prefetch buffer — the runner's
    # keyed dict holds exactly one value per slot.  And every
    # prefetch_for-marked event must be covered by a recorded lifetime,
    # else the memory pass cannot charge the buffer it implies.
    prefetches = list(getattr(sched, "prefetches", ()) or ())
    seen_slots: set[tuple[int, int]] = set()
    recorded_consumers: set[int] = set()
    for pf in prefetches:
        if not 0 <= pf.consumer < len(g.nodes):
            findings.append(Finding(
                "RA208", f"prefetch names consumer node {pf.consumer}, "
                         "which does not exist"))
            continue
        n = g.nodes[pf.consumer]
        recorded_consumers.add(pf.consumer)
        if not 0 <= pf.arg < len(n.inputs):
            findings.append(_f(
                "RA208", f"prefetch arg index {pf.arg} out of range for "
                         f"{len(n.inputs)} inputs", n))
            continue
        if (pf.consumer, pf.arg) in seen_slots:
            findings.append(_f(
                "RA208", f"two prefetches alias arg {pf.arg}'s buffer — "
                         "the second overwrites the first before its "
                         "consumer reads it", n))
        seen_slots.add((pf.consumer, pf.arg))
        if pf.issue >= pf.consumer:
            findings.append(_f(
                "RA208", f"prefetch of arg {pf.arg} issues at node "
                         f"{pf.issue}, not before its consumer "
                         f"{pf.consumer} — nothing is hoisted", n))
            continue
        if not 0 <= pf.issue < len(g.nodes):
            findings.append(_f(
                "RA208", f"prefetch of arg {pf.arg} issues at node "
                         f"{pf.issue}, which does not exist", n))
            continue
        if g.nodes[pf.issue].kind == "input":
            findings.append(_f(
                "RA208", f"prefetch of arg {pf.arg} issues at input node "
                         f"{pf.issue} ({g.nodes[pf.issue].name}) — input "
                         "nodes never execute an iteration, so the issue "
                         "never happens", n))
        a = n.inputs[pf.arg]
        if g.nodes[a].kind != "input" and pf.issue <= a:
            findings.append(_f(
                "RA208", f"prefetch of arg {pf.arg} issues at node "
                         f"{pf.issue}, before its producer "
                         f"{g.nodes[a].name} (node {a}) has computed — "
                         "the chain would read a stale or missing "
                         "buffer", n))
    for e in trace.events:
        if e.prefetch_for < 0 or e.prefetch_for in recorded_consumers:
            continue
        recorded_consumers.add(e.prefetch_for)  # one finding per consumer
        where = (g.nodes[e.prefetch_for] if 0 <= e.prefetch_for < len(g.nodes)
                 else None)
        msg = (f"{e.kind} is marked prefetch_for node {e.prefetch_for} but "
               "the schedule records no matching Prefetch lifetime — the "
               "memory pass cannot charge its buffer")
        findings.append(_f("RA208", msg, where) if where is not None
                        else Finding("RA208", msg))

    # RA205/RA206: traced wire elems vs the planner's §7 prices ------------
    # The §7 objective treats graph inputs as pre-placed (§8.2): the cost
    # of distributing an *input* to its consumer's layout is excluded from
    # plan_cost / opaque_node_bound, while the schedule records that wire.
    # Mirror the exclusion by replaying each input-edge chain with the same
    # accounting _record_steps used, so the comparison is like-for-like.
    if plan is not None:
        n_dev = _group_size(sizes.keys(), sizes)
        placement: dict[int, int] = {}
        for prog in sched.programs:
            n = g.nodes[prog.nid]
            moved = 0
            for a, steps in zip(n.inputs, prog.arg_steps):
                if g.nodes[a].kind != "input" or not steps:
                    continue
                try:
                    shape = local_shape(g.nodes[a].shape,
                                        sched.layouts[a], sizes)
                except (ValueError, KeyError):
                    continue
                for st in steps:
                    moved += _wire_elems(st, shape, sizes, n_dev)
                    shape = _step_shape(shape, st, sizes)
            if moved:
                placement[prog.nid] = moved

        elems_by_node = trace.elems_by_node
        for nid, rule in sorted(trace.rule_by_node.items()):
            if rule not in _BOUNDED_RULES:
                continue
            traced = elems_by_node.get(nid, 0) - placement.get(nid, 0)
            try:
                bound = opaque_node_bound(g, plan, nid)
            except Exception:
                continue  # unpriceable node: plan pass already flagged it
            if traced > bound:
                findings.append(_f(
                    "RA205", f"{rule} rule moves {traced:,} wire elems "
                             "(input placement excluded, §8.2), over its "
                             f"_opaque_comm_cost bound {bound:,} — the "
                             "realized schedule diverged from the priced "
                             "one", g.nodes[nid]))
        total = trace.total_elems - sum(placement.values())
        if plan.cost and total > plan.cost:
            findings.append(Finding(
                "RA206", f"schedule moves {total:,} wire elems (input "
                         "placement excluded, §8.2), over the §7 "
                         f"plan_cost {plan.cost:,} the DP optimized"))
    return findings

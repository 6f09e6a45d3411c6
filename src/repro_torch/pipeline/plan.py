"""Per-stage §8 planning and the stitched full-graph plan.

Each stage subgraph is planned by the *existing* EinDecomp DP against the
intra-stage mesh (the combined mesh minus the ``pp`` axis), resolving
through the canonical plan cache — stage graphs hash on structure alone
(canon.graph_key), so repeated transformer layers plan once and every
repetition hits warm.

The per-stage plans are then **stitched** into one full-graph plan: every
stage node's entry transfers to its global node verbatim (extraction
preserves labels), cut stubs drop out (the producer's own stage owns its
entry), and graph inputs take the entry of their first consuming stage —
the same first-consumer-wins rule ``decomp._finalize_inputs`` applies.
The stitched plan is a complete, valid mesh-mode plan for the *unpipelined*
graph: compiling it through the ordinary shard_map executor is the
bit-identity baseline the pipeline executor is tested against.

Finally, every stage's input-stub entries are **overridden** to the
stitched layout of the tensor that actually arrives there (the producer's
planned layout for handoffs, the stitched entry for graph inputs).  Stage
schedules built from these exec plans therefore emit exactly the
repartition chains the full-graph schedule emits for the same edges, which
is what makes the pipelined and unpipelined executions realize the same
collectives on the same values.
"""
from __future__ import annotations

from math import prod

from repro_torch.core.decomp import (Plan, _consumer_sites, _in_labels_of,
                               cost_repart, eindecomp, plan_cost)
from repro_torch.core.einsum import EinGraph

from repro_torch.pipeline.partition import PipelineSpec, Stage


def _copy_plan(plan: Plan) -> Plan:
    out = Plan(p=plan.p, mode=plan.mode, cost=plan.cost)
    out.d_by_node = {k: dict(v) for k, v in plan.d_by_node.items()}
    out.axes_by_node = {k: {l: tuple(a) for l, a in v.items()}
                        for k, v in plan.axes_by_node.items()}
    return out


def plan_pipeline(
    g: EinGraph,
    stages: list[Stage],
    spec: PipelineSpec,
    *,
    intra_axes: dict[str, int],
    cache=None,
    offpath_repart: bool = True,
    cost_mode="paper",
) -> tuple[Plan, dict]:
    """Plan every stage (warm through ``cache``), stitch the full-graph
    plan, and override stub entries (see module doc).  Returns the
    stitched plan plus the plan-cache hit/miss delta this pipeline caused
    (how many stage plans resolved warm — the transformer-layer dedup the
    tests pin)."""
    p_intra = prod(intra_axes.values()) if intra_axes else 1
    before = dict(cache.stats) if cache is not None else {}
    for st in stages:
        st.plan = _copy_plan(eindecomp(
            st.graph, p_intra, mesh_axes=intra_axes,
            offpath_repart=offpath_repart, cost_mode=cost_mode, cache=cache))
    stats = {}
    if cache is not None:
        after = cache.stats
        stats = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("hits", "misses", "path_hits", "path_misses")}

    stitched = _stitch(g, stages, p_intra, spec)
    _override_stub_entries(stages, stitched)
    return stitched, stats


def _stitch(g: EinGraph, stages: list[Stage], p_intra: int,
            spec: PipelineSpec) -> Plan:
    """Per-stage plans -> one full-graph plan (see module doc).  ``g`` may
    be the unscaled graph: plan entries are {label: parts} maps, and any
    parts choice made at the b/m microbatch extent divides the full batch
    too, so the stitched plan is valid at both extents."""
    plan = Plan(p=p_intra, mode="mesh")
    for st in stages:
        for gn in st.nids:
            ln = st.lid_of[gn]
            plan.d_by_node[gn] = dict(st.plan.d_by_node[ln])
            if ln in st.plan.axes_by_node:
                plan.axes_by_node[gn] = {
                    l: tuple(a) for l, a in st.plan.axes_by_node[ln].items()}
    # graph inputs: first consuming stage's stub entry wins (stages are in
    # chain order and stub entries are the first local consumer's need, so
    # this agrees with decomp._finalize_inputs on the full graph)
    for st in stages:
        for gn, ln in sorted(st.lid_of.items()):
            if g.nodes[gn].kind != "input" or gn in plan.d_by_node:
                continue
            plan.d_by_node[gn] = dict(st.plan.d_by_node[ln])
            if ln in st.plan.axes_by_node:
                plan.axes_by_node[gn] = {
                    l: tuple(a) for l, a in st.plan.axes_by_node[ln].items()}
    plan.cost = plan_cost(g, plan)
    return plan


def _override_stub_entries(stages: list[Stage], stitched: Plan) -> None:
    """Point every stage-graph input entry at the layout the tensor
    actually arrives in: handoff stubs take the producer's stitched entry,
    graph-input stubs the stitched global input entry.  Labels transfer
    verbatim — extraction copies them unchanged."""
    for st in stages:
        for gn, ln in st.lid_of.items():
            if st.graph.nodes[ln].kind != "input":
                continue
            st.plan.d_by_node[ln] = dict(stitched.d_by_node[gn])
            if gn in stitched.axes_by_node:
                st.plan.axes_by_node[ln] = {
                    l: tuple(a) for l, a in stitched.axes_by_node[gn].items()}
            else:
                st.plan.axes_by_node.pop(ln, None)


def stage_priced_cost(stage: Stage) -> int:
    """The §7 price of one stage's schedule: ``plan_cost`` over the stage
    graph *plus* two terms the whole-graph bound amortizes away but a
    single stage cannot:

      * input-edge repartitions — stage inputs are not pre-placed the way
        §8.2 graph inputs are (a handoff arrives in the producer's layout,
        a shared graph input in its stitched layout), so the edges the
        stage schedule traces must be priced too;
      * replicate-ruled opaques — the fallback shard rule gathers every
        input to full replication, wire ``plan_cost`` never sees (the §7
        edge price targets the plan's layout, not the realized gather).
        Each such edge is priced as a gather to a replicated consumer at
        every one of the ``p`` sites: traced is n*(k-1), the surcharge
        alone is (p-1)*n >= it, so the bound is static and sound.

    This is the per-stage bound bench_pipeline --check holds traced wire
    under (the per-stage analogue of bench_spmd's whole-program
    ``traced <= plan_cost``)."""
    g, plan = stage.graph, stage.plan
    total = plan_cost(g, plan)
    rules = stage.sched.trace.rule_by_node if stage.sched is not None else {}
    for n in g.nodes:
        if n.kind not in ("einsum", "opaque"):
            continue
        d = plan.d_by_node[n.nid]
        replicated = n.kind == "opaque" and rules.get(n.nid) == "replicate"
        for ls, a in zip(_in_labels_of(n), n.inputs):
            na = g.nodes[a]
            da = tuple(plan.d_by_node[a].get(l, 1) for l in na.labels)
            if replicated:
                ones = tuple(1 for _ in na.labels)
                total += cost_repart(da, ones, na.shape, plan.p)
            elif na.kind == "input":
                target = tuple(d.get(l, 1) for l in ls)
                total += cost_repart(da, target, na.shape,
                                     _consumer_sites(n.kind, target, plan.p))
    return total

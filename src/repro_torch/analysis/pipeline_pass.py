"""Pipeline pass (RA4xx): the stage chain, handoff ordering, and
per-stage memory of a ``PipelineSchedule``.

What the pipeline tier promises statically, re-verified from the built
schedule rather than trusted from its builder:

  RA401  the stage graph is a *chain*: every handoff stub consumes a
         tensor produced by a strictly earlier stage (a back-edge means
         the cut was not dependency-closed — a cycle between stages);
  RA402  every handoff fires only after its producing (stage, microbatch)
         cell: in the combined trace, no intra-stage event of cell
         (s, mb) may appear after a rule="handoff" event tagged (s, mb)
         (the executor issues the ppermute when the cell's values exist —
         a premature handoff would ship garbage);
  RA403  per-stage peak live bytes: each stage schedule runs the memory
         pass on its own subgraph against ``--max-hbm`` — the pipeline's
         point is that *stages*, not the whole graph, must fit;
  RA404  stage imbalance: the realized max/mean compute ratio exceeds the
         partitioner's own ``balance`` cap (the DP doubled its cap to
         find a feasible cut — worth a warning, the bubble fraction the
         static tier prices assumes balanced stages);
  RA405  per-stage cost honesty: each stage schedule's traced intra-stage
         wire (one microbatch) stays within ``stage_priced_cost`` — the
         per-stage analogue of RA206.  The whole-graph RA206 convention
         does not transfer to a pipelined cell: the stitched plan is
         per-stage DP-optimal, not a whole-graph DP output, and the
         pipelined executor never runs the whole-graph schedule — the
         sound static bound is the per-stage price (plan_cost over the
         stage graph plus the input-edge and replicate-gather surcharges
         a single stage cannot amortize away).

Backend-free like every other pass: a ``PipelineSchedule`` is pure Python
over static shapes.
"""
from __future__ import annotations

from repro_torch.core.einsum import EinGraph

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.memory_pass import analyze_memory


def analyze_pipeline_schedule(g: EinGraph, psched,
                              max_hbm: int | None = None) -> list[Finding]:
    """All RA4xx checks over one built ``PipelineSchedule``."""
    findings: list[Finding] = []
    findings += _check_stage_chain(g, psched.stages)
    findings += _check_handoff_order(g, psched)
    findings += _check_stage_memory(psched, max_hbm)
    findings += _check_balance(g, psched)
    findings += _check_stage_wire(psched)
    return findings


def _check_stage_chain(g: EinGraph, stages) -> list[Finding]:
    out: list[Finding] = []
    stage_of = {gn: st.index for st in stages for gn in st.nids}
    for st in stages:
        for gn in st.recv:
            src = stage_of.get(gn)
            n = g.nodes[gn] if 0 <= gn < len(g.nodes) else None
            name = n.name if n is not None else f"<{gn}>"
            if src is None:
                out.append(Finding(
                    "RA401", f"stage {st.index} receives node {gn} "
                             f"({name}) that no stage produces",
                    nid=gn, node=name,
                    srcloc=n.srcloc if n is not None else ""))
            elif src >= st.index:
                out.append(Finding(
                    "RA401", f"stage {st.index} receives node {gn} "
                             f"({name}) produced by stage {src} — the "
                             "stage graph has a back-edge (not a chain)",
                    nid=gn, node=name,
                    srcloc=n.srcloc if n is not None else ""))
    return out


def _check_handoff_order(g: EinGraph, psched) -> list[Finding]:
    """A rule="handoff" event tagged (s, mb) must come after every
    intra-stage event of cell (s, mb) — the producing cell completes
    before its values ship."""
    out: list[Finding] = []
    handoff_seen: set[tuple[int, int]] = set()
    for e in psched.trace.events:
        cell = (e.stage, e.microbatch)
        if e.rule == "handoff":
            handoff_seen.add(cell)
        elif cell in handoff_seen:
            n = g.nodes[e.nid] if 0 <= e.nid < len(g.nodes) else None
            out.append(Finding(
                "RA402", f"cell (stage {e.stage}, microbatch "
                         f"{e.microbatch}) issues {e.kind} for node "
                         f"{e.nid} after its handoff already fired — "
                         "the ppermute ships values the cell has not "
                         "produced yet",
                nid=e.nid, node=n.name if n is not None else "",
                srcloc=n.srcloc if n is not None else ""))
    return out


def _check_stage_memory(psched, max_hbm: int | None) -> list[Finding]:
    out: list[Finding] = []
    if max_hbm is None:
        return out
    for st in psched.stages:
        if st.sched is None:
            continue
        local_outs = [st.lid_of[gn] for gn in st.out_gids]
        _, report = analyze_memory(st.graph, st.sched, local_outs, (), None)
        peak = report.get("peak_bytes", 0)
        if peak > max_hbm:
            out.append(Finding(
                "RA403", f"stage {st.index}: peak live bytes {peak:,} B "
                         f"per device exceed --max-hbm {int(max_hbm):,} B "
                         f"(the stage alone must fit)"))
    return out


def _check_stage_wire(psched) -> list[Finding]:
    """RA405: traced intra-stage wire of each stage (one microbatch — every
    microbatch replays the same stage schedule) within the sound per-stage
    §7 price (see module doc).  Skipped for hand-built schedules whose
    stages carry no plan/sched."""
    from repro_torch.pipeline.plan import stage_priced_cost

    out: list[Finding] = []
    for st in psched.stages:
        if st.plan is None or st.sched is None:
            continue
        traced = psched.stage_trace_elems(st.index)
        priced = stage_priced_cost(st)
        if traced > priced:
            out.append(Finding(
                "RA405", f"stage {st.index} schedule moves {traced:,} wire "
                         f"elems (one microbatch), over its per-stage §7 "
                         f"price {priced:,} — the realized stage schedule "
                         "diverged from the priced one"))
    return out


def _check_balance(g: EinGraph, psched) -> list[Finding]:
    """Re-verify the partitioner's own contract: max stage weight (the
    partitioner's join-size metric, recomputed here) within ``balance x
    total / p``.  Fires exactly when the DP had to double its cap to find
    a feasible cut — an unbalanced chain whose real bubble exceeds the
    static (p-1)/(m+p-1)."""
    from repro_torch.pipeline.partition import _node_weight

    stages = psched.stages
    p = len(stages)
    if p <= 1:
        return []
    ws = [sum(_node_weight(st.graph, st.lid_of[gn]) for gn in st.nids)
          for st in stages]
    total = sum(ws)
    if total == 0:
        return []
    cap = psched.spec.balance * total / p
    worst = max(ws)
    if worst > cap:
        s = ws.index(worst)
        return [Finding(
            "RA404", f"stage {s} carries {worst:,} of {total:,} weight vs "
                     f"the balance cap {cap:,.0f} (balance="
                     f"{psched.spec.balance}) — no balanced cut exists, "
                     f"so the static bubble fraction {psched.bubble:.3f} "
                     f"understates the realized one "
                     f"{psched.bubble_weighted:.3f}")]
    return []

"""The static GPipe microbatch schedule and its combined collective trace.

``build_pipeline_schedule`` is the pipeline tier's ``build_schedule``: a
pure function of (graph, PipelineSpec, combined mesh shape) — no tensors,
no devices — that partitions, plans, and lowers the whole pipeline:

  * stages come from the partitioner (repro_torch.pipeline.partition), planned
    and stitched by repro_torch.pipeline.plan;
  * each stage lowers through the ordinary ``spmd.build_schedule`` against
    the intra-stage mesh axes, at the per-microbatch batch extent;
  * the **cells** list is the GPipe fill/drain issue order — tick t runs
    cell (stage s, microbatch t - s) for every valid s, so the first p - 1
    and last p - 1 ticks are partially idle: the static bubble fraction
    (p-1)/(m+p-1) that ``core.cost.bubble_fraction`` prices;
  * stage handoffs lower to one cyclic ``ppermute`` per live tensor per
    boundary per microbatch over the ``pp`` mesh axis, appended to the
    combined trace (rule="handoff") *between* the producing and consuming
    cells — exactly where the executor issues them.  A tensor consumed k
    stages downstream is relayed through every intermediate boundary, so
    the trace prices the same wire the partitioner's objective minimized.

Every stage-trace event is re-emitted per microbatch with (stage,
microbatch) attribution and local node ids translated back to global ids,
so the combined trace slices cleanly by stage, by microbatch, or by rule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import spmd
from repro_torch.core.cost import bubble_fraction, bubble_fraction_weighted
from repro_torch.core.decomp import Plan
from repro_torch.core.einsum import EinGraph

from repro_torch.pipeline.partition import (PipelineSpec, Stage, _node_weight,
                                      partition_stages)
from repro_torch.pipeline.plan import plan_pipeline, stage_priced_cost


@dataclass
class PipelineSchedule:
    """Everything static about one pipelined compile (see module doc)."""

    spec: PipelineSpec
    stages: list[Stage]
    stitched: Plan                      # full-graph plan = bit-id baseline
    cells: list[tuple[int, int]]        # GPipe (stage, microbatch) order
    boundaries: list[list[int]]         # per boundary: global nids handed off
    trace: spmd.CollectiveTrace         # combined, (stage, mb)-tagged
    sizes: dict[str, int]               # combined mesh sizes (pp included)
    out_ids: list[int]                  # global program outputs
    cut_elems: list[int] = field(default_factory=list)   # per boundary / mb
    stage_compute: list[int] = field(default_factory=list)  # §7 proxy / mb
    bubble: float = 0.0                 # static (p-1)/(m+p-1)
    bubble_weighted: float = 0.0        # compute-weighted fill/drain bubble
    cache_stats: dict = field(default_factory=dict)

    @property
    def handoff_elems(self) -> int:
        return sum(e.elems for e in self.trace.events if e.rule == "handoff")

    def stage_trace_elems(self, s: int) -> int:
        """Intra-stage traced wire of stage ``s`` for ONE microbatch (every
        microbatch replays the same stage schedule)."""
        return sum(e.elems for e in self.trace.events
                   if e.stage == s and e.microbatch == 0
                   and e.rule != "handoff")

    def stage_priced(self, s: int) -> int:
        return stage_priced_cost(self.stages[s])


def build_pipeline_schedule(
    g: EinGraph,
    spec: PipelineSpec,
    mesh_axes: dict[str, int],
    out_ids=None,
    *,
    cache=None,
    offpath_repart: bool = True,
    cost_mode="paper",
    fuse: bool = True,
    lookahead: int = 1,
) -> PipelineSchedule:
    """Partition + plan + lower one pipelined compile (see module doc).
    ``mesh_axes`` is the combined mesh including the ``spec.axis`` entry
    (which may be absent or size 1 when ``spec.stages == 1``)."""
    sizes = {a: int(s) for a, s in mesh_axes.items()}
    pp = sizes.get(spec.axis, 1)
    if pp != spec.stages:
        raise ValueError(
            f"pipeline: spec.stages={spec.stages} but mesh axis "
            f"{spec.axis!r} has size {pp} — they must agree")
    intra = {a: s for a, s in sizes.items() if a != spec.axis}
    p, m = spec.stages, spec.microbatches
    out_ids = list(out_ids) if out_ids is not None else g.outputs()

    stages = partition_stages(g, spec)
    stitched, cache_stats = plan_pipeline(
        g, stages, spec, intra_axes=intra, cache=cache,
        offpath_repart=offpath_repart, cost_mode=cost_mode)

    # per-stage lowering: stage outs = cut producers + global outs, so the
    # reduce-scatter fusion never rewrites a boundary tensor's layout
    stage_of = {gn: st.index for st in stages for gn in st.nids}
    cons = g.consumers()
    last_stage = {u: max((stage_of[v] for v in cons[u] if v in stage_of),
                         default=-1) for u in stage_of}
    out_set = set(out_ids)
    for st in stages:
        st.out_gids = [gn for gn in st.nids
                       if gn in out_set or last_stage[gn] > st.index]
        local_outs = [st.lid_of[gn] for gn in st.out_gids]
        st.sched = spmd.build_schedule(st.graph, st.plan, intra, local_outs,
                                       fuse=fuse, lookahead=lookahead)

    boundaries = [sorted(u for u in stage_of
                         if stage_of[u] <= k < last_stage[u])
                  for k in range(p - 1)]
    cells = [(s, t - s) for t in range(m + p - 1)
             for s in range(p) if 0 <= t - s < m]

    n_dev = math.prod(sizes.values()) if sizes else 1
    perm = tuple((i, (i + 1) % pp) for i in range(pp))

    def handoff_layout(u: int):
        st = stages[stage_of[u]]
        return st.sched.layouts[st.lid_of[u]]

    trace = spmd.CollectiveTrace()
    for (s, mb) in cells:
        st = stages[s]
        trace.extend_tagged(st.sched.trace, stage=s, microbatch=mb,
                            nid_map=st.gid_of)
        if s < p - 1 and pp > 1:
            for u in boundaries[s]:
                st_p = stages[stage_of[u]]
                node = st_p.graph.nodes[st_p.lid_of[u]]
                loc = spmd.local_shape(node.shape, handoff_layout(u), intra)
                n_loc = int(np.prod(loc, dtype=np.int64)) if loc else 1
                elems = n_dev * n_loc
                trace.add("ppermute", (spec.axis,), u, elems,
                          elems * spmd._itemsize(node.dtype),
                          rule="handoff", perm=perm, stage=s, microbatch=mb)

    cut_elems = []
    for bset in boundaries:
        tot = 0
        for u in bset:
            st_p = stages[stage_of[u]]
            tot += int(np.prod(st_p.graph.nodes[st_p.lid_of[u]].shape,
                               dtype=np.int64))
        cut_elems.append(tot)

    # per-stage compute weight for the measured bubble: the partitioner's
    # own §7 join-size proxy (all decompositions of a node share its FLOP
    # count, and every stage runs on the same intra mesh, so the proxy is
    # placement-invariant — Schedule.compute_elems would weigh stages by
    # local *output* numel, a memory proxy that over-counts cheap wide maps)
    stage_compute = [sum(_node_weight(st.graph, st.lid_of[gn])
                         for gn in st.nids) for st in stages]
    return PipelineSchedule(
        spec=spec, stages=stages, stitched=stitched, cells=cells,
        boundaries=boundaries, trace=trace, sizes=sizes, out_ids=out_ids,
        cut_elems=cut_elems, stage_compute=stage_compute,
        bubble=bubble_fraction(p, m),
        bubble_weighted=bubble_fraction_weighted(stage_compute, m),
        cache_stats=cache_stats)

"""Stage partitioner: cut an EinGraph into a chain of pipeline stages.

The third parallelism axis (after the §6 data/model decomposition the DP
already searches): a contiguous cut of the topological node sequence into
``p`` stages, minimizing the bytes that cross stage boundaries subject to a
per-stage compute-balance cap.  Contiguity is sound because this IR's
``topo_order()`` *is* construction order — any prefix of it is a valid
dependency-closed unit — and it is what makes the cut a chain (stage s only
ever feeds stages > s), which the RA401 analysis pass re-verifies.

A tensor produced in stage s and consumed in stage s+k is *live* across k
boundaries and is charged at every one of them: the executor's handoff
lowering (repro_torch.pipeline.exec) relays it hop by hop over the ``pp`` mesh
axis, so the partitioner's objective prices exactly the wire the schedule
emits.

Stage subgraphs are materialized as standalone ``EinGraph``s: graph inputs
are copied verbatim (name preserved — canonical hashing never sees names),
cut tensors become fresh input stubs named ``handoff_<gnid>``.  Stub
creation is lazy, on first reference in global topo order, which preserves
the construction-order == topo-order invariant the rest of the stack
relies on.  ``canon.subgraph_key`` over the stage's global nids is the
stage identity: repeated transformer layers hash equal, which is what lets
their §8 plans resolve warm through the canonical plan cache.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import canon
from repro_torch.core.decomp import node_bounds
from repro_torch.core.spmd import _itemsize
from repro_torch.core.einsum import EinGraph


@dataclass(frozen=True)
class PipelineSpec:
    """How to pipeline a compile: ``stages`` cuts over the ``axis`` mesh
    axis, ``microbatches`` splits the ``batch_label`` dimension.  ``balance``
    caps each stage's compute weight at balance * total / stages (doubled
    until a feasible cut exists, so a pathological graph degrades to an
    unbalanced cut instead of failing)."""

    stages: int = 1
    microbatches: int = 1
    axis: str = "pp"
    batch_label: str = "b"
    balance: float = 1.25

    def __post_init__(self):
        if self.stages < 1 or self.microbatches < 1:
            raise ValueError(f"PipelineSpec: stages={self.stages}, "
                             f"microbatches={self.microbatches} must be >= 1")


@dataclass
class Stage:
    """One pipeline stage: a dependency-closed slice of the global graph,
    extracted as a standalone EinGraph the §8 DP can plan directly."""

    index: int
    nids: list[int]              # global non-input nids, topo order
    graph: EinGraph              # extracted stage subgraph
    gid_of: dict[int, int]       # local nid -> global nid (stubs included)
    lid_of: dict[int, int]       # global nid -> local nid
    recv: list[int]              # global nids consumed via handoff stubs
    key: str = ""                # canon.subgraph_key(g, nids)
    # filled by repro_torch.pipeline.plan / schedule:
    plan: object = None          # per-stage §8 plan (stub entries overridden)
    sched: object = None         # per-stage spmd.Schedule (microbatch-sized)
    out_gids: list[int] = field(default_factory=list)  # cut + global outs


def _in_label_sets(n):
    if n.kind == "einsum":
        return n.spec.in_labels
    if n.kind == "map":
        return (n.labels,)
    return n.in_labels or tuple((n.labels,) * len(n.inputs))


def batch_splittable(g: EinGraph, batch_label: str = "b") -> bool:
    """Whether splitting ``batch_label`` into microbatches is sound at the
    label level: every node consuming a batch-carrying input must carry the
    batch label on its own output (no reduction or rearrangement over the
    batch).  The MoE dispatch/combine pair fails this — capacity-dropped
    routing couples tokens across the whole batch — which is exactly why
    mixtral pipelines at m=1 only."""
    for n in g.nodes:
        if n.kind == "input":
            continue
        in_has = any(batch_label in ls for ls in _in_label_sets(n))
        if in_has and batch_label not in n.labels:
            return False
    return True


def _node_weight(g: EinGraph, nid: int) -> int:
    """Per-node compute proxy: join size (product of the node's label
    universe bounds) for einsum/opaque, output numel for map, 0 for
    inputs.  All decompositions of a node share its FLOP count (§7), so a
    partitioning-independent proxy is the right balance weight."""
    n = g.nodes[nid]
    if n.kind == "input":
        return 0
    if n.kind == "map":
        return int(np.prod(n.shape, dtype=np.int64))
    out = 1
    for b in node_bounds(g, nid).values():
        out *= int(b)
    return out


def cut_tensors(g: EinGraph, boundaries: list[int]) -> list[list[int]]:
    """Per boundary, the global nids *live* across it: produced at or
    before, consumed after.  ``boundaries[k]`` is the position (in the
    non-input topo sequence) where stage k+1 starts.  Graph inputs are
    never cut — they are pre-placed (§8.2) and fed to every stage
    directly."""
    seq = [nid for nid in g.topo_order() if g.nodes[nid].kind != "input"]
    pos = {nid: i for i, nid in enumerate(seq)}
    cons = g.consumers()
    last = {u: max((pos[v] for v in cs), default=-1)
            for u, cs in cons.items() if u in pos}
    return [[u for u in seq[:b] if last.get(u, -1) >= b] for b in boundaries]


def partition_stages(g: EinGraph, spec: PipelineSpec) -> list[Stage]:
    """Cut ``g`` into ``spec.stages`` stages minimizing cut-edge bytes under
    the balance cap, and extract each as a standalone EinGraph.

    ``spec.stages == 1`` with ``microbatches == 1`` is the identity fast
    path: one Stage whose ``graph`` IS ``g`` (object identity), so the
    downstream schedule is build_schedule(g, ...) verbatim — the serial
    schedule.  With m > 1 every stage graph (including the single-stage
    one) is batch-scaled to the per-microbatch extent b/m, which is the
    compute one (stage, microbatch) cell runs.
    """
    if spec.microbatches > 1 and not batch_splittable(g, spec.batch_label):
        raise ValueError(
            "pipeline: graph couples rows across the batch label "
            f"{spec.batch_label!r} (e.g. MoE capacity routing) — "
            "microbatches must be 1")
    gm = scale_graph_batch(g, spec.microbatches, spec.batch_label)
    seq = [nid for nid in gm.topo_order() if gm.nodes[nid].kind != "input"]
    p = spec.stages
    if p == 1:
        lid = {nid: nid for nid in gm.topo_order()}
        return [Stage(index=0, nids=list(seq), graph=gm, gid_of=dict(lid),
                      lid_of=dict(lid), recv=[],
                      key=canon.subgraph_key(gm, seq))]
    if p > len(seq):
        raise ValueError(
            f"pipeline: {p} stages over {len(seq)} non-input nodes")

    n = len(seq)
    pos = {nid: i for i, nid in enumerate(seq)}
    cons = gm.consumers()
    last = {u: max((pos[v] for v in cons[u]), default=-1) for u in pos}
    nbytes = {u: int(np.prod(gm.nodes[u].shape, dtype=np.int64))
              * _itemsize(gm.nodes[u].dtype) for u in pos}
    cut_cost = [0] * (n + 1)
    for b in range(1, n):
        cut_cost[b] = sum(nbytes[u] for u in seq[:b] if last[u] >= b)
    w = [_node_weight(gm, nid) for nid in seq]
    pref = [0]
    for x in w:
        pref.append(pref[-1] + x)

    def solve(cap: float) -> list[int] | None:
        inf = float("inf")
        f = [[inf] * (n + 1) for _ in range(p + 1)]
        back: dict[tuple[int, int], int] = {}
        f[0][0] = 0.0
        for k in range(1, p + 1):
            for j in range(k, n + 1):
                for i in range(k - 1, j):
                    if pref[j] - pref[i] > cap:
                        continue
                    c = f[k - 1][i] + (cut_cost[i] if i else 0)
                    if c < f[k][j]:
                        f[k][j] = c
                        back[(k, j)] = i
        if f[p][n] == inf:
            return None
        bounds, j = [], n
        for k in range(p, 0, -1):
            i = back[(k, j)]
            if i:
                bounds.append(i)
            j = i
        return sorted(bounds)

    cap = spec.balance * pref[-1] / p
    boundaries = solve(cap)
    while boundaries is None:
        cap *= 2
        boundaries = solve(cap)

    edges = [0] + boundaries + [n]
    stages = []
    for k in range(p):
        nids = seq[edges[k]:edges[k + 1]]
        stages.append(_extract_stage(gm, k, nids))
    return stages


def _extract_stage(g: EinGraph, index: int, nids: list[int]) -> Stage:
    """Materialize one stage as a standalone EinGraph (see module doc).
    ``g`` is the (already microbatch-scaled) global graph."""
    sg = EinGraph(f"{g.name}.stage{index}")
    lid_of: dict[int, int] = {}
    recv: list[int] = []

    def ensure(a: int) -> int:
        if a in lid_of:
            return lid_of[a]
        na = g.nodes[a]
        name = na.name if na.kind == "input" else f"handoff_{a}"
        if na.kind != "input":
            recv.append(a)
        lid_of[a] = sg.input(name, na.labels, na.shape, na.dtype)
        return lid_of[a]

    for gn in nids:
        node = g.nodes[gn]
        ins = tuple(ensure(a) for a in node.inputs)
        lid_of[gn] = len(sg.nodes)
        sg.nodes.append(dataclasses.replace(
            node, nid=len(sg.nodes), inputs=ins))

    gid_of = {l: gn for gn, l in lid_of.items()}
    return Stage(index=index, nids=list(nids), graph=sg, gid_of=gid_of,
                 lid_of=dict(lid_of), recv=recv,
                 key=canon.subgraph_key(g, nids))


def scale_graph_batch(g: EinGraph, m: int, batch_label: str = "b") -> EinGraph:
    """A copy of ``g`` with every batch-labeled extent divided by ``m`` —
    the per-microbatch global graph (identity when m == 1)."""
    if m == 1:
        return g
    for node in g.nodes:
        if batch_label in node.labels:
            b = node.shape[node.labels.index(batch_label)]
            if b % m:
                raise ValueError(
                    f"pipeline: batch bound {b} not divisible by "
                    f"microbatches={m} (node {node.name})")
    out = EinGraph(g.name)
    for node in g.nodes:
        out.nodes.append(dataclasses.replace(
            node,
            shape=tuple(s // m if l == batch_label else s
                        for l, s in zip(node.labels, node.shape))))
    return out

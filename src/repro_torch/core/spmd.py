"""Explicit-collective SPMD executor: the TRA rewrite executed literally.

A planned ``EinGraph`` lowers to one per-rank program over a mesh of
``torch.distributed`` ranks in which every data movement the §4.3
join→agg→repartition rewrite implies is an explicit collective:

  * the *join* is the per-rank local block computation (clean two-input
    contractions go through ``repro_torch.kernels.ops.matmul``, the
    hand-written matmul kernel on a card; everything else lowers through
    the engine's einsum semantics on local blocks);
  * the *aggregation* over mesh-mapped contracted labels is an
    ``all_reduce`` (SUM, MAX or MIN; ``prod`` gathers then reduces) on
    exactly the axes the plan assigned — fused to a ``reduce_scatter`` when
    every consumer wants the reduced output sharded on the same axis;
  * inter-node *repartitions* are derived statically from
    ``(d_from, d_to)``: un-sharding a dimension is an all-gather, moving a
    mesh axis between dimensions an all-to-all, swapping which axis shards
    a dimension a point-to-point exchange, and sharding a replicated
    dimension a free local slice.

The whole schedule is a pure function of (graph, plan, mesh shape), so it
is computed before anything runs: ``build_schedule`` returns the per-node
collective program plus a ``CollectiveTrace`` (count + wire bytes per
collective kind, attributed per node and per shard rule) without touching
a tensor.  That half is the reference's, line for line, and its output
equals the reference's event for event.

Opaque nodes dispatch through the shard-rule registry
(core/opaque_rules.py): ring attention circulates K/V between ranks with a
carried online-softmax state, and every opaque op without a declared rule
(or whose rule's preconditions fail) falls back to the replicate-gather
path: inputs gathered, dense compute, consumers re-slice.

The run half (``make_spmd_runner``) executes the schedule on
``torch.distributed``: one process per rank, each holding its local blocks
on its device (``launch/mesh.py`` builds the mesh and its process groups).
On a mesh whose axes all have size 1 no collective is emitted and no
process group is needed: the one-card case.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.einsum import EinGraph, EinSpec, Node

#: a layout maps each tensor dimension to the (major→minor) mesh axes that
#: shard it — the executor-side mirror of a PartitionSpec.
Layout = tuple[tuple[str, ...], ...]

#: collective kinds that move data over the wire (local slices are free).
#: a grouped reduce-scatter records as kind "psum_scatter" (one event).
WIRE_KINDS = ("all_gather", "all_to_all", "ppermute", "psum", "psum_scatter",
              "psum_scatter_grouped", "pmax", "pmin", "gather_reduce")


# ---------------------------------------------------------------------------
# Collective trace
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveEvent:
    """One emitted collective: what, where, and how many wire bytes."""

    kind: str                # one of WIRE_KINDS
    axes: tuple[str, ...]    # mesh axes the collective runs over
    nid: int                 # graph node the movement belongs to
    elems: int               # floats crossing the wire, summed over devices
    nbytes: int              # elems * itemsize
    rule: str = ""           # shard rule that emitted it ("" = einsum path)
    fused: bool = False      # emitted by the fused repartition planner
    overlap: bool = False    # issued to overlap with local compute
    # ppermute only: the exact (src, dst) pairs the executor will issue over
    # the flattened device group — the static analyzer's bijectivity check
    # (repro.analysis RA201) runs over this, so it verifies the permutation
    # that actually executes, not a re-derivation.
    perm: tuple = ()
    # graph-wide lookahead attribution: the consumer node whose argument
    # this event prefetches (-1 = not a hoisted issue).  ``nid`` stays the
    # consumer, so per-node bounds and elems_by_node are issue-order
    # independent; rule-internal overlaps (the ring's double buffer) keep
    # prefetch_for = -1 and are never double-counted against a hoist.
    prefetch_for: int = -1
    # pipeline attribution (repro.pipeline): which stage's sub-schedule
    # emitted the event and during which microbatch it runs (-1 = the
    # unpipelined executor).  Stage handoffs record as rule="handoff"
    # ppermute events over the `pp` axis with both fields set.
    stage: int = -1
    microbatch: int = -1


class CollectiveTrace:
    """Count + wire bytes per collective kind for one compiled program.

    Filled statically at schedule-build time (the schedule is a pure
    function of graph/plan/mesh shape, so no tracing is needed); the same
    numbers the executed program realizes.  Wire costs use ring pricing —
    all-gather moves (k-1)·n_loc per device, all-reduce 2·(k-1)/k·n_loc,
    all-to-all (k-1)/k·n_loc, reduce-scatter (k-1)/k·n_loc, permute n_loc —
    matching launch/hlo_analysis.py's accounting of the GSPMD path.

    Events carry their node and the shard rule that emitted them
    (``rule_by_node`` records which rule lowered each opaque node), so the
    ring/a2a traffic of an opaque hot spot is separable from the einsum
    repartition flow: ``by_rule`` / ``bytes_by_node`` are what
    ``bench_spmd --check`` asserts the per-node ``_opaque_comm_cost`` bound
    against.
    """

    def __init__(self):
        self.events: list[CollectiveEvent] = []
        self.rule_by_node: dict[int, str] = {}

    def add(self, kind: str, axes: Sequence[str], nid: int, elems: int,
            nbytes: int, rule: str = "", *, fused: bool = False,
            overlap: bool = False, perm: Sequence = (),
            prefetch_for: int = -1, stage: int = -1,
            microbatch: int = -1) -> None:
        self.events.append(CollectiveEvent(kind, tuple(axes), nid,
                                           int(elems), int(nbytes), rule,
                                           fused, overlap,
                                           tuple(tuple(p) for p in perm),
                                           int(prefetch_for), int(stage),
                                           int(microbatch)))

    def extend(self, other: "CollectiveTrace") -> None:
        self.events.extend(other.events)
        self.rule_by_node.update(other.rule_by_node)

    def extend_tagged(self, other: "CollectiveTrace", *, stage: int,
                      microbatch: int,
                      nid_map: dict[int, int] | None = None) -> None:
        """Re-emit ``other``'s events with pipeline (stage, microbatch)
        attribution — how the pipeline tier replays one stage's static
        sub-schedule per microbatch into the combined trace.  ``nid_map``
        translates the stage schedule's local node ids back to global
        graph ids, so per-node accounting stays meaningful."""
        remap = nid_map or {}
        self.events.extend(
            dataclasses.replace(e, nid=remap.get(e.nid, e.nid),
                                stage=int(stage),
                                microbatch=int(microbatch))
            for e in other.events)
        self.rule_by_node.update(
            (remap.get(n, n), r) for n, r in other.rule_by_node.items())

    def reset(self) -> None:
        self.events.clear()
        self.rule_by_node.clear()

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    @property
    def elems_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + e.elems
        return out

    @property
    def bytes_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + e.nbytes
        return out

    @property
    def total_elems(self) -> int:
        return sum(e.elems for e in self.events)

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.events)

    @property
    def elems_by_node(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for e in self.events:
            out[e.nid] = out.get(e.nid, 0) + e.elems
        return out

    @property
    def bytes_by_node(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for e in self.events:
            out[e.nid] = out.get(e.nid, 0) + e.nbytes
        return out

    @property
    def fused_elems(self) -> int:
        """Wire elems carried by fused-planner repartitions — each event is
        attributed to the originating (d_from, d_to) pair's consumer node,
        never recorded alongside the unfused steps it replaced."""
        return sum(e.elems for e in self.events if e.fused)

    @property
    def overlapped_elems(self) -> int:
        """Wire elems issued to overlap with local compute — the ring's
        double-buffered K/V hops plus the graph-wide lookahead prefetches
        — the statically auditable overlap attribution.  Each event counts
        once: a hoisted chain is marked ``prefetch_for >= 0``, a
        rule-internal overlap keeps ``prefetch_for = -1``; no event is
        ever both."""
        return sum(e.elems for e in self.events if e.overlap)

    @property
    def prefetched_elems(self) -> int:
        """Wire elems carried by graph-wide lookahead prefetches only
        (hoisted arg repartitions; excludes rule-internal overlaps like
        the ring's double buffer)."""
        return sum(e.elems for e in self.events if e.prefetch_for >= 0)

    @property
    def overlap_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            if e.overlap:
                out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def by_rule(self) -> dict[str, dict[str, dict[str, int]]]:
        """{rule: {kind: {"count": n, "elems": e, "bytes": b}}} — the
        per-rule breakdown surfaced as
        ``CompiledProgram.collectives_by_rule``.  Einsum-path events group
        under ``""``."""
        out: dict[str, dict[str, dict[str, int]]] = {}
        for e in self.events:
            slot = out.setdefault(e.rule, {}).setdefault(
                e.kind, {"count": 0, "elems": 0, "bytes": 0})
            slot["count"] += 1
            slot["elems"] += e.elems
            slot["bytes"] += e.nbytes
        return out

    def __len__(self) -> int:
        return len(self.events)

    def summary(self) -> str:
        if not self.events:
            return "collectives: none (fully local program)"
        lines = ["collectives (kind: count / wire bytes):"]
        nb = self.bytes_by_kind
        for kind, cnt in sorted(self.counts.items()):
            lines.append(f"  {kind:14s} {cnt:4d}  {nb[kind]:,} B")
        lines.append(f"  {'total':14s} {len(self.events):4d}  "
                     f"{self.total_bytes:,} B")
        for rule, kinds in sorted(self.by_rule().items()):
            if not rule:
                continue
            tot = sum(s["bytes"] for s in kinds.values())
            cnt = sum(s["count"] for s in kinds.values())
            lines.append(f"  [{rule}]{'':9s} {cnt:4d}  {tot:,} B")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Repartition planning: (d_from, d_to) -> explicit collective steps
# ---------------------------------------------------------------------------
#
# A *step* is a tuple whose head names the op:
#   ("all_gather", ax, dim)             un-shard dim's minor-most axis
#   ("all_to_all", ax, src_dim, dst_dim) move ax between dims
#   ("ppermute", ax_old, ax_new, dim)   swap which axis shards dim
#   ("slice", ax, dim)                  shard a replicated dim (local, free)
#   ("psum"|"pmax"|"pmin", axes)        cross-device reduction
#   ("psum_scatter", ax, dim)           fused reduce + shard of dim
#   ("psum_scatter_grouped", ((ax, dim), ...))
#                                       one reduce-scatter over the combined
#                                       axis group, scattering several dims
#                                       at once (same wire bytes as the
#                                       sequential per-axis form, one pass)
#   ("gather_reduce", ax, reducer)      gather + local reduce (prod)


def plan_repart(src: Layout, dst: Layout) -> list[tuple]:
    """Decompose a repartition into explicit collective steps.

    Per-axis moves use ``all_to_all`` when the axis is minor-most on both
    sides, axis swaps on a single dimension use ``ppermute``, and the
    general fallback is gather-to-prefix + local re-slice — always correct,
    never silently wrong, at worst pricier than optimal.  Idle axes whose
    target extends a dimension's already-correct prefix are sliced *early*
    (free), both shrinking every later transfer and unlocking ``all_to_all``
    moves whose destination prefix they complete — e.g. replicated →
    ``(data, model)``-on-one-dim with ``model`` arriving from another dim is
    slice(data) + all_to_all(model), not gather + slice + slice.
    """
    if len(src) != len(dst):
        raise ValueError(f"repartition rank mismatch: {src} vs {dst}")
    cur = [list(t) for t in src]
    want = [tuple(t) for t in dst]
    steps: list[tuple] = []

    def dim_of(ax: str, layout) -> int | None:
        for d, axes in enumerate(layout):
            if ax in axes:
                return d
        return None

    # 1. interleave (a) free slices of idle axes that extend a dim's correct
    #    prefix with (b) all_to_all moves: ax minor-most at its source dim,
    #    landing minor-most at a destination dim whose prefix is in place.
    changed = True
    while changed:
        changed = False
        for d in range(len(cur)):
            while (len(cur[d]) < len(want[d])
                   and tuple(cur[d]) == want[d][:len(cur[d])]
                   and dim_of(want[d][len(cur[d])], cur) is None):
                ax = want[d][len(cur[d])]
                steps.append(("slice", ax, d))
                cur[d].append(ax)
                changed = True
        for i, axes in enumerate(cur):
            if not axes:
                continue
            ax = axes[-1]
            j = dim_of(ax, want)
            if j is None or j == i:
                continue
            if want[j] == tuple(cur[j]) + (ax,):
                steps.append(("all_to_all", ax, i, j))
                cur[i].pop()
                cur[j].append(ax)
                changed = True

    # 2. ppermute: dim stays sharded but by a different (same-size checked by
    #    the caller) axis, old axis sharding nothing else, new axis idle.
    for d in range(len(cur)):
        if (len(cur[d]) == 1 and len(want[d]) == 1
                and cur[d][0] != want[d][0]
                and dim_of(want[d][0], cur) is None
                and dim_of(cur[d][0], want) in (None, d)):
            steps.append(("ppermute", cur[d][0], want[d][0], d))
            cur[d] = [want[d][0]]

    # 3. gather: pop minor-most axes until each dim is a prefix of its target.
    for d in range(len(cur)):
        while cur[d] and tuple(cur[d]) != want[d][:len(cur[d])]:
            steps.append(("all_gather", cur[d][-1], d))
            cur[d].pop()

    # 4. slice: append the remaining target axes major→minor (local, free).
    for d in range(len(cur)):
        for ax in want[d][len(cur[d]):]:
            steps.append(("slice", ax, d))
            cur[d].append(ax)

    assert [tuple(t) for t in cur] == list(want), (src, dst, steps)
    return steps


def plan_repart_fused(src: Layout, dst: Layout,
                      sizes: dict[str, int]) -> list[tuple]:
    """Fused repartition planner: the same (d_from, d_to) chain as
    ``plan_repart`` with the all_to_all landing condition *relaxed* so
    consecutive gather+re-slice pairs collapse into single collectives.

    ``plan_repart`` only fires an all_to_all when the moved axis completes
    the destination dim's target outright (``want[j] == cur[j] + (ax,)``);
    axes that land mid-prefix fall through to gather-to-prefix + local
    re-slice, which pays the full ``(k-1)·n_loc`` gather for data the next
    step throws away.  Here an axis may land whenever it is the *next
    prefix element* of its destination dim (``want[j][len(cur[j])] == ax``),
    so e.g. the zoo's lm_head chain

        [all_gather(model, 0), all_gather(data, 2), slice(data, 0)]

    becomes ``[all_gather(model, 0), all_to_all(data, 2, 0)]`` — the
    gather+slice pair fused into one all_to_all at 1/k the wire cost.
    When no free slice / all_to_all / equal-size ppermute applies, one
    minor-most axis of the first out-of-place dim is gathered and the
    passes rerun — gathers interleave with fusions instead of running as a
    monolithic gather-all phase.

    Termination: whenever every dim's current layout is a prefix of its
    target but the repartition is unfinished, some dim's next-needed axis
    is either idle (a free slice fires) or parked minor-most under a
    non-prefix dim (the gather fallback fires, since a mesh axis appears
    at most once per layout); every pass therefore makes progress.
    """
    if len(src) != len(dst):
        raise ValueError(f"repartition rank mismatch: {src} vs {dst}")
    cur = [list(t) for t in src]
    want = [tuple(t) for t in dst]
    steps: list[tuple] = []

    def dim_of(ax: str, layout) -> int | None:
        for d, axes in enumerate(layout):
            if ax in axes:
                return d
        return None

    def is_prefix(d: int) -> bool:
        return tuple(cur[d]) == want[d][:len(cur[d])]

    n_axes = sum(len(t) for t in src) + sum(len(t) for t in dst)
    for _ in range(4 * n_axes + 8):
        if [tuple(t) for t in cur] == list(want):
            break
        progress = False
        # (a) free slices: an idle axis extends a dim's correct prefix
        for d in range(len(cur)):
            while (is_prefix(d) and len(cur[d]) < len(want[d])
                   and dim_of(want[d][len(cur[d])], cur) is None):
                ax = want[d][len(cur[d])]
                steps.append(("slice", ax, d))
                cur[d].append(ax)
                progress = True
        # (b) relaxed all_to_all: ax minor-most at its source dim, landing
        #     as the NEXT prefix element of its destination dim
        for i in range(len(cur)):
            if not cur[i]:
                continue
            ax = cur[i][-1]
            j = dim_of(ax, want)
            if j is None or j == i:
                continue
            if (is_prefix(j) and len(cur[j]) < len(want[j])
                    and want[j][len(cur[j])] == ax):
                steps.append(("all_to_all", ax, i, j))
                cur[i].pop()
                cur[j].append(ax)
                progress = True
        if progress:
            continue
        # (c) ppermute: dim stays sharded but by a different equal-size
        #     axis, old axis idle in the target, new axis idle now
        for d in range(len(cur)):
            if (len(cur[d]) == 1 and len(want[d]) == 1
                    and cur[d][0] != want[d][0]
                    and sizes[cur[d][0]] == sizes[want[d][0]]
                    and dim_of(want[d][0], cur) is None
                    and dim_of(cur[d][0], want) is None):
                steps.append(("ppermute", cur[d][0], want[d][0], d))
                cur[d] = [want[d][0]]
                progress = True
        if progress:
            continue
        # (d) stalled: gather one minor-most axis off the first dim whose
        #     layout is not a prefix of its target, then rerun the passes
        for d in range(len(cur)):
            if cur[d] and not is_prefix(d):
                steps.append(("all_gather", cur[d][-1], d))
                cur[d].pop()
                progress = True
                break
        assert progress, (src, dst, cur, want, steps)

    assert [tuple(t) for t in cur] == list(want), (src, dst, steps)
    return steps


def _chain_wire_elems(steps: list[tuple], shape: tuple[int, ...],
                      sizes: dict[str, int], n_devices: int) -> int:
    """Total ring-priced wire elems of a step chain applied to local blocks
    of ``shape`` (the shape evolves step to step)."""
    total = 0
    for st in steps:
        total += _wire_elems(st, shape, sizes, n_devices)
        shape = _step_shape(shape, st, sizes)
    return total


def plan_repart_best(src: Layout, dst: Layout, sizes: dict[str, int],
                     src_local: tuple[int, ...],
                     n_devices: int) -> tuple[list[tuple], bool]:
    """``(steps, fused)`` — the cheaper of the fused and unfused chains by
    traced wire elems (ties broken toward fewer steps, then the unfused
    unfused path).  Taking the min guarantees the fused executor never moves
    more elements than the unfused one on any (src, dst) pair."""
    unfused = _plan_repart_sized(src, dst, sizes)
    fused = plan_repart_fused(src, dst, sizes)
    if fused == unfused:
        return unfused, False
    cu = _chain_wire_elems(unfused, src_local, sizes, n_devices)
    cf = _chain_wire_elems(fused, src_local, sizes, n_devices)
    if cf < cu or (cf == cu and len(fused) < len(unfused)):
        return fused, True
    return unfused, False


def _ppermute_size_ok(step, sizes) -> bool:
    return sizes[step[1]] == sizes[step[2]]


def _plan_repart_sized(src: Layout, dst: Layout,
                       sizes: dict[str, int]) -> list[tuple]:
    """plan_repart, demoting any ppermute whose two axes differ in size
    (the swap is only a pure permutation for equal sizes) to gather+slice."""
    steps = plan_repart(src, dst)
    if all(st[0] != "ppermute" or _ppermute_size_ok(st, sizes)
           for st in steps):
        return steps
    out: list[tuple] = []
    for st in steps:
        if st[0] == "ppermute" and not _ppermute_size_ok(st, sizes):
            _, ax_old, ax_new, dim = st
            out.append(("all_gather", ax_old, dim))
            out.append(("slice", ax_new, dim))
        else:
            out.append(st)
    return out


def local_shape(shape: Sequence[int], layout: Layout,
                sizes: dict[str, int]) -> tuple[int, ...]:
    """Per-device block shape of a tensor under a layout."""
    out = []
    for s, axes in zip(shape, layout):
        k = math.prod(sizes[a] for a in axes) if axes else 1
        if s % k != 0:
            raise ValueError(f"axes {axes} (x{k}) do not divide dim {s}")
        out.append(s // k)
    return tuple(out)


def _step_shape(shape: tuple[int, ...], step: tuple,
                sizes: dict[str, int]) -> tuple[int, ...]:
    """Local block shape after one repartition step."""
    s = list(shape)
    kind = step[0]
    if kind == "all_gather":
        s[step[2]] *= sizes[step[1]]
    elif kind == "all_to_all":
        _, ax, i, j = step
        s[i] *= sizes[ax]
        s[j] //= sizes[ax]
    elif kind == "slice":
        s[step[2]] //= sizes[step[1]]
    elif kind == "psum_scatter":
        s[step[2]] //= sizes[step[1]]
    elif kind == "psum_scatter_grouped":
        for ax, d in step[1]:
            s[d] //= sizes[ax]
    # ppermute / psum / pmax / pmin / gather_reduce keep the block shape
    return tuple(s)


def _wire_elems(step: tuple, shape: tuple[int, ...], sizes: dict[str, int],
                n_devices: int) -> int:
    """Ring-priced floats crossing the wire, summed over all devices, for
    one step applied to local blocks of ``shape``."""
    n_loc = math.prod(shape) if shape else 1
    kind = step[0]
    if kind == "all_gather":
        k = sizes[step[1]]
        return n_devices * (k - 1) * n_loc
    if kind == "all_to_all":
        k = sizes[step[1]]
        return n_devices * (k - 1) * n_loc // k
    if kind == "ppermute":
        return n_devices * n_loc
    if kind in ("psum", "pmax", "pmin"):
        k = math.prod(sizes[a] for a in step[1])
        return n_devices * 2 * (k - 1) * n_loc // k
    if kind == "psum_scatter":
        k = sizes[step[1]]
        return n_devices * (k - 1) * n_loc // k
    if kind == "psum_scatter_grouped":
        k = math.prod(sizes[ax] for ax, _ in step[1])
        # identical to the sequential per-axis total: n·(k1k2-1)/(k1k2)
        return n_devices * (k - 1) * n_loc // k
    if kind == "gather_reduce":
        k = sizes[step[1]]
        return n_devices * (k - 1) * n_loc
    return 0  # slice: local


# ---------------------------------------------------------------------------
# Schedule: per-node collective programs + layouts, computed before tracing
# ---------------------------------------------------------------------------


@dataclass
class NodeProgram:
    """Everything the body needs to execute one node: per-arg repartition
    steps, the post-compute reduction/slice steps, and the output layout.
    Opaque nodes additionally carry the shard rule that lowered them and
    its ``run`` closure (the per-device local program).

    ``prefetch`` lists the (consumer nid, arg index) chains the lookahead
    pass hoisted to this node: the runner issues them before this node's
    local compute block, so the wire flies while the block runs.
    ``prefetch_src`` is the consumer-side mirror — arg index → the node
    whose iteration issues that arg's chain."""

    nid: int
    arg_steps: list[list[tuple]] = field(default_factory=list)
    post_steps: list[tuple] = field(default_factory=list)
    layout: Layout = ()
    rule: str = ""
    run: Callable | None = None
    prefetch: list[tuple[int, int]] = field(default_factory=list)
    prefetch_src: dict[int, int] = field(default_factory=dict)


@dataclass(frozen=True)
class Prefetch:
    """One hoisted repartition's buffer lifetime: consumer node
    ``consumer``'s argument ``arg`` has its wire chain issued just before
    node ``issue``'s local compute block, so the repartitioned shard is
    live from ``issue`` until ``consumer`` reads it.  ``elems`` is the
    chain's total ring-priced wire elems (the overlappable volume the
    cost model's exposed-wire term hides behind ``issue``'s compute
    window)."""

    consumer: int
    arg: int
    issue: int
    elems: int


@dataclass
class Schedule:
    """The full static lowering of (graph, plan, mesh shape).

    ``lookahead`` records the window the schedule was built with;
    ``prefetches`` the hoisted buffer lifetimes (empty at lookahead=0 —
    that lowering is verbatim the serial one); ``compute_elems`` a
    per-node local-compute window proxy (local output elems) bounding how
    much wire each node's compute can hide."""

    programs: list[NodeProgram]
    layouts: dict[int, Layout]
    trace: CollectiveTrace
    sizes: dict[str, int]
    lookahead: int = 0
    prefetches: list[Prefetch] = field(default_factory=list)
    compute_elems: dict[int, int] = field(default_factory=dict)

    def exposed_wire_elems(self) -> int:
        """Wire elems left exposed after overlap: total minus what each
        issue site's local-compute window can hide (``cost.exposed_wire``
        — overlap can't hide unbounded traffic behind a small block).
        Rule-internal overlaps (ring double buffer) hide behind their own
        node's compute; hoisted chains behind their issue node's."""
        from repro_torch.core.cost import exposed_wire

        overlap_by_site: dict[int, int] = {}
        for e in self.trace.events:
            if e.overlap and e.prefetch_for < 0:
                overlap_by_site[e.nid] = (overlap_by_site.get(e.nid, 0)
                                          + e.elems)
        for pf in self.prefetches:
            overlap_by_site[pf.issue] = (overlap_by_site.get(pf.issue, 0)
                                         + pf.elems)
        return exposed_wire(self.trace.total_elems, overlap_by_site,
                            self.compute_elems)


def _norm_axes(axes, sizes: dict[str, int]) -> tuple[str, ...]:
    """Drop size-1 mesh axes — they shard nothing and must not show up as
    collectives (an all-"None" plan emits zero collectives)."""
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def _plan_layout(node: Node, axes_by_label: dict[str, tuple[str, ...]],
                 sizes: dict[str, int]) -> Layout:
    return tuple(_norm_axes(axes_by_label.get(l, ()), sizes)
                 for l in node.labels)


def _itemsize(dtype) -> int:
    """Bytes an element of ``dtype``: a torch dtype's own, else numpy's,
    else that of the torch dtype of that name (``"bfloat16"``, which the
    reference's numpy knows through ml_dtypes).  Raises on a dtype that
    neither can size."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        named = getattr(torch, str(dtype), None)
        if isinstance(named, torch.dtype):
            return named.itemsize
        raise TypeError(f"cannot size an element of dtype {dtype!r}") from None


def _record_steps(trace: CollectiveTrace, steps: list[tuple],
                  shape: tuple[int, ...], sizes: dict[str, int],
                  n_devices: int, nid: int, itemsize: int,
                  rule: str = "", *, fused: bool = False) -> tuple[int, ...]:
    """Account every step in the trace; returns the final local shape.

    When ``fused`` is set the chain came from the fused planner: every
    event carries the flag and is attributed to the consumer node of the
    originating (d_from, d_to) pair — the steps it replaced are never
    recorded, so per-node bounds compare like-for-like with no
    double-counting."""
    for st in steps:
        kind = st[0]
        if kind in WIRE_KINDS:
            perm: tuple = ()
            if kind in ("psum", "pmax", "pmin"):
                axes = tuple(st[1])
            elif kind == "ppermute":
                axes = (st[1], st[2])
                # mirror the executor's transpose formula exactly (the
                # run-time closure below) so the static analyzer verifies
                # the permutation that actually ships
                k = sizes[st[1]]
                perm = tuple((j * k + i, i * k + j)
                             for i in range(k) for j in range(k))
            elif kind == "psum_scatter_grouped":
                axes = tuple(ax for ax, _ in st[1])
            else:
                axes = (st[1],)
            elems = _wire_elems(st, shape, sizes, n_devices)
            rec = "psum_scatter" if kind == "psum_scatter_grouped" else kind
            trace.add(rec, axes, nid, elems, elems * itemsize, rule,
                      fused=fused, perm=perm)
        shape = _step_shape(shape, st, sizes)
    return shape


def _scatter_dim(g: EinGraph, plan, nid: int, ax: str,
                 consumers: dict[int, list[int]], out_ids: set[int],
                 sizes: dict[str, int]) -> int | None:
    """Output dim to psum_scatter axis ``ax`` onto: defined when every
    consumer wants exactly that axis on the same output dimension (and the
    node is not itself a program output, whose layout the plan pins)."""
    if nid in out_ids or not consumers.get(nid):
        return None
    dims: set[int] = set()
    for m in consumers[nid]:
        ax_m = plan.axes_by_node.get(m, {})
        for ls in g.edge_labels(m, nid):
            found = [d for d, l in enumerate(ls)
                     if _norm_axes(ax_m.get(l, ()), sizes) == (ax,)]
            if len(found) != 1:
                return None
            dims.add(found[0])
    return dims.pop() if len(dims) == 1 else None


def _lower_einsum(g: EinGraph, n: Node, plan, ax_n, layouts, sizes,
                  trace: CollectiveTrace, n_dev: int, consumers,
                  out_set, fuse: bool = True,
                  spans: dict | None = None) -> NodeProgram:
    """join→agg lowering of one einsum node: per-arg repartitions to the
    plan layout, then the aggregation collectives (psum / pmax / pmin /
    gather-reduce), with sum-aggregations fused to reduce-scatters when the
    consumers pin the scattered dim — one *grouped* reduce-scatter when
    several contracted axes scatter to distinct output dims."""
    nid = n.nid
    spec = n.spec
    prog = NodeProgram(nid=nid)
    itemsize = _itemsize(n.dtype)
    for ai, (ls, a) in enumerate(zip(spec.in_labels, n.inputs)):
        req = tuple(_norm_axes(ax_n.get(l, ()), sizes) for l in ls)
        src_shape = local_shape(g.nodes[a].shape, layouts[a], sizes)
        if fuse:
            steps, was_fused = plan_repart_best(layouts[a], req, sizes,
                                                src_shape, n_dev)
        else:
            steps, was_fused = _plan_repart_sized(layouts[a], req,
                                                  sizes), False
        prog.arg_steps.append(steps)
        e0 = len(trace.events)
        got = _record_steps(trace, steps, src_shape, sizes, n_dev,
                            nid, _itemsize(g.nodes[a].dtype),
                            fused=was_fused)
        if spans is not None:
            spans[(nid, ai)] = (e0, len(trace.events))
        want_shape = local_shape(g.nodes[a].shape, req, sizes)
        assert got == want_shape, (nid, a, got, want_shape)

    prog.layout = _plan_layout(n, ax_n, sizes)
    agg_axes: list[str] = []
    for l in spec.agg_labels:
        agg_axes.extend(_norm_axes(ax_n.get(l, ()), sizes))
    if agg_axes:
        out_loc = list(local_shape(n.shape, prog.layout, sizes))
        if spec.agg == "sum":
            plain: list[str] = []
            scatters: list[tuple[str, int]] = []
            for ax in agg_axes:
                d = _scatter_dim(g, plan, nid, ax, consumers,
                                 out_set, sizes)
                if (d is not None and not prog.layout[d]
                        and d not in [sd for _, sd in scatters]):
                    scatters.append((ax, d))
                    lay = list(prog.layout)
                    lay[d] = (ax,)
                    prog.layout = tuple(lay)
                else:
                    plain.append(ax)
            if len(scatters) == 1:
                prog.post_steps.append(("psum_scatter",) + scatters[0])
            elif scatters:
                prog.post_steps.append(
                    ("psum_scatter_grouped", tuple(scatters)))
            if plain:
                # reduce first, then scatter the fused axes
                prog.post_steps.insert(0, ("psum", tuple(plain)))
        elif spec.agg in ("max", "min"):
            prog.post_steps.append(
                ("pmax" if spec.agg == "max" else "pmin",
                 tuple(agg_axes)))
        else:  # prod: gather partial products, reduce locally
            for ax in agg_axes:
                prog.post_steps.append(("gather_reduce", ax, "prod"))
        _record_steps(trace, prog.post_steps, tuple(out_loc), sizes,
                      n_dev, nid, itemsize)
    return prog


def _lower_opaque(g: EinGraph, n: Node, ax_n, layouts, sizes,
                  trace: CollectiveTrace, n_dev: int,
                  fuse: bool = True,
                  spans: dict | None = None) -> NodeProgram:
    """Dispatch one opaque node through the shard-rule registry
    (core/opaque_rules.py).  The resolved rule requests per-input layouts
    (repartitioned by the generic machinery, so arbitrary producers are
    handled), contributes its internal collective events to the trace
    (ring ppermute hops, a2a token payloads), and supplies the ``run``
    closure executed on every rank.  Rules whose structural
    preconditions fail fall back to the replicate-gather path."""
    from repro_torch.core import opaque_rules

    nid = n.nid
    prog = NodeProgram(nid=nid)
    rule_name = opaque_rules.resolve_rule_name(n)
    low = None
    if rule_name != "replicate":
        rule = opaque_rules.RULES.get(rule_name)
        low = rule.lower(g, n, ax_n, sizes) if rule is not None else None
    if low is None:
        rule_name = "replicate"
        low = opaque_rules.RULES["replicate"].lower(g, n, ax_n, sizes)
    prog.rule = rule_name
    prog.run = low.run
    trace.rule_by_node[nid] = rule_name

    for ai, (a, req) in enumerate(zip(n.inputs, low.arg_layouts)):
        src_shape = local_shape(g.nodes[a].shape, layouts[a], sizes)
        if fuse:
            steps, was_fused = plan_repart_best(layouts[a], req, sizes,
                                                src_shape, n_dev)
        else:
            steps, was_fused = _plan_repart_sized(layouts[a], req,
                                                  sizes), False
        prog.arg_steps.append(steps)
        e0 = len(trace.events)
        got = _record_steps(trace, steps, src_shape, sizes, n_dev, nid,
                            _itemsize(g.nodes[a].dtype), rule_name,
                            fused=was_fused)
        if spans is not None:
            spans[(nid, ai)] = (e0, len(trace.events))
        want_shape = local_shape(g.nodes[a].shape, req, sizes)
        assert got == want_shape, (nid, a, got, want_shape)
    for ev in low.events:
        # rules may tag an event as overlapped (5th element) — the ring's
        # double-buffered K/V hops issued alongside local compute — and
        # expose the exact ppermute (src, dst) pairs (6th element) for the
        # static bijectivity check
        kind, axes, elems, nbytes = ev[:4]
        overlap = bool(ev[4]) if len(ev) > 4 else False
        perm = tuple(ev[5]) if len(ev) > 5 else ()
        trace.add(kind, axes, nid, elems, nbytes, rule_name,
                  overlap=overlap, perm=perm)
    prog.post_steps = list(low.post_steps)
    prog.layout = low.out_layout
    # rule post steps are layout-conforming local slices (free, no wire
    # events); any internal wire movement must be declared via low.events
    assert all(st[0] == "slice" for st in prog.post_steps), prog.post_steps
    return prog


#: arg repartition chains are composed of exactly these wire kinds (plus
#: free local slices) — the hoistable set of the lookahead pass.
_HOISTABLE_KINDS = ("all_gather", "all_to_all", "ppermute")


def _hoist_prefetches(g: EinGraph, programs: list[NodeProgram],
                      trace: CollectiveTrace, spans: dict,
                      lookahead: int) -> list[Prefetch]:
    """Graph-wide lookahead pass: each wire-carrying arg chain of an
    einsum/opaque consumer M hoists to the ``lookahead``-th computing node
    before M — never before the chain's *own* producer (per-argument
    readiness: the chain reads only that producer's value, so sibling args
    still in flight don't serialize it) — and the collectives fly while
    the intervening local compute blocks run.  Topo positions equal nids
    (``topo_order`` is construction order — the invariant the memory pass
    already relies on).  Hoisted events are retroactively marked
    ``overlap=True, prefetch_for=M``; their ``nid`` stays M so per-node
    attribution is issue-order independent.  Returns the hoisted buffer
    lifetimes."""
    progs = {p.nid: p for p in programs}
    prefetches: list[Prefetch] = []
    for n in g.nodes:
        if n.kind in ("input", "map"):
            continue  # inputs don't execute; maps repartition nothing
        m = n.nid
        prog = progs[m]
        for ai in range(len(prog.arg_steps)):
            span = spans.get((m, ai))
            if not span or span[0] == span[1]:
                continue  # slice-only chain: nothing crosses the wire
            evs = trace.events[span[0]:span[1]]
            if any(e.kind not in _HOISTABLE_KINDS for e in evs):
                continue
            # per-arg readiness: the chain needs its own producer computed
            # (graph inputs are bound before the loop — always ready)
            a = n.inputs[ai]
            ready = a + 1 if g.nodes[a].kind != "input" else 0
            # the issue point is the ``lookahead``-th *computing* node
            # before M (input nodes never execute an iteration, so they
            # don't consume the window), clamped at readiness
            issue, p, seen = m, m - 1, 0
            while p >= ready and seen < lookahead:
                if g.nodes[p].kind != "input":
                    issue, seen = p, seen + 1
                p -= 1
            if issue >= m:
                continue  # no intervening compute to hide the wire behind
            for idx in range(span[0], span[1]):
                trace.events[idx] = dataclasses.replace(
                    trace.events[idx], overlap=True, prefetch_for=m)
            progs[issue].prefetch.append((m, ai))
            prog.prefetch_src[ai] = issue
            prefetches.append(Prefetch(m, ai, issue,
                                       sum(e.elems for e in evs)))
    return prefetches


def build_schedule(g: EinGraph, plan, mesh_axes: dict[str, int],
                   out_ids: Sequence[int] | None = None, *,
                   fuse: bool = True, lookahead: int = 1) -> Schedule:
    """Lower (graph, plan, mesh shape) to the static collective schedule.

    Pure Python over static shapes — no tensors, no devices — so trace
    assertions (e.g. "an unsharded plan emits zero collectives") run on any
    host, and the runner body just replays the recorded decisions.

    ``fuse=True`` (the default) routes every repartition through
    ``plan_repart_best`` — the fused chain when it moves strictly fewer
    wire elems, the unfused chain otherwise; ``fuse=False`` restores
    the unfused lowering verbatim (the equivalence baseline
    the fused-vs-unfused tests diff against).

    ``lookahead`` (default 1) is the graph-wide overlap window: each ready
    consumer's wire-carrying arg chains are hoisted up to ``lookahead``
    nodes before the consumer (never before the consumer's producers), so
    the collectives issue while the intervening local compute runs —
    recorded as ``Prefetch`` lifetimes and ``prefetch_for``-marked events.
    ``lookahead=0`` restores the serial lowering verbatim.
    """
    sizes = {a: int(s) for a, s in mesh_axes.items()}
    n_dev = math.prod(sizes.values()) if sizes else 1
    out_set = set(out_ids) if out_ids is not None else set(g.outputs())
    consumers = g.consumers()
    trace = CollectiveTrace()
    layouts: dict[int, Layout] = {}
    programs: list[NodeProgram] = []
    compute_elems: dict[int, int] = {}
    spans: dict[tuple[int, int], tuple[int, int]] = {}

    for nid in g.topo_order():
        n = g.nodes[nid]
        ax_n = plan.axes_by_node.get(nid, {}) if plan is not None else {}

        if n.kind == "input":
            prog = NodeProgram(nid=nid)
            prog.layout = _plan_layout(n, ax_n, sizes)
        elif n.kind == "map":
            # elementwise on the local block; layout rides through untouched
            prog = NodeProgram(nid=nid)
            prog.layout = layouts[n.inputs[0]]
        elif n.kind == "einsum":
            prog = _lower_einsum(g, n, plan, ax_n, layouts, sizes, trace,
                                 n_dev, consumers, out_set, fuse, spans)
        else:
            prog = _lower_opaque(g, n, ax_n, layouts, sizes, trace, n_dev,
                                 fuse, spans)

        layouts[nid] = prog.layout
        programs.append(prog)
        if n.kind != "input":
            try:
                compute_elems[nid] = math.prod(
                    local_shape(n.shape, prog.layout, sizes))
            except (ValueError, KeyError):
                pass  # unrealizable layout: the analysis passes flag it

    prefetches: list[Prefetch] = []
    if lookahead > 0:
        prefetches = _hoist_prefetches(g, programs, trace, spans,
                                       int(lookahead))

    return Schedule(programs=programs, layouts=layouts, trace=trace,
                    sizes=sizes, lookahead=int(lookahead),
                    prefetches=prefetches, compute_elems=compute_elems)


# ---------------------------------------------------------------------------
# Local einsum compute: contraction -> kernels.ops.matmul when it is one
# ---------------------------------------------------------------------------


def _as_matmul(spec: EinSpec) -> tuple[list[str], list[str], list[str]] | None:
    """(free_x, contracted, free_y) when the node is a clean matmul: binary
    mul+sum, the shared labels are exactly the contracted ones (no batch
    labels), every label partitions into one of the three groups."""
    if not (spec.is_contraction and len(spec.in_labels) == 2):
        return None
    lx, ly = spec.in_labels
    shared = [l for l in lx if l in ly]
    if set(shared) != set(spec.agg_labels):
        return None
    free_x = [l for l in lx if l not in shared]
    free_y = [l for l in ly if l not in shared]
    if set(spec.out_labels) != set(free_x) | set(free_y):
        return None
    return free_x, shared, free_y


def local_einsum(spec: EinSpec, x, y=None):
    """One node's *local* join block.  Clean 2-ary contractions go through
    ``repro_torch.kernels.ops.matmul`` (the matmul kernel for CUDA tensors,
    its plain version for CPU tensors); everything else lowers through the
    engine semantics.  The operands reach the kernel as 2-d views of the
    permuted blocks; where a permuted block cannot be viewed as 2-d (the
    o_proj input ``(b, h, s, d) -> (b·s, h·d)``) ``reshape`` copies it."""
    from repro_torch.core import engine

    args = (x,) if y is None else (x, y)
    mm = _as_matmul(spec) if y is not None else None
    if mm is not None and all(a.is_floating_point() for a in args):
        from repro_torch.kernels import ops

        free_x, shared, free_y = mm
        lx, ly = spec.in_labels
        xa = x.permute([lx.index(l) for l in free_x + shared])
        ya = y.permute([ly.index(l) for l in shared + free_y])
        fx_shape = xa.shape[:len(free_x)]
        fy_shape = ya.shape[len(shared):]
        k = math.prod(xa.shape[len(free_x):])  # 1 for outer products
        z = ops.matmul(xa.reshape(-1, k), ya.reshape(k, -1))
        z = z.reshape(tuple(fx_shape) + tuple(fy_shape))
        order = free_x + free_y
        return z.permute([order.index(l) for l in spec.out_labels])
    return engine.lower_einsum(spec, *args)


# ---------------------------------------------------------------------------
# Step execution on torch.distributed
# ---------------------------------------------------------------------------


def _merge_leading(t, dim: int):
    """(k, *shape) -> shape with dim ``dim`` k times larger, block i of the
    leading axis at offset i (a tiled concatenation along ``dim``)."""
    return t.movedim(0, dim).flatten(dim, dim + 1)


def _split_leading(x, k: int, dim: int):
    """shape -> (k, *shape with dim ``dim`` k times smaller), contiguous:
    block i along ``dim`` becomes entry i of the leading axis."""
    return x.unflatten(dim, (k, x.shape[dim] // k)).movedim(dim, 0).contiguous()


class _Pending:
    """A collective in flight: ``wait()`` blocks on its work handles, then
    finishes the value (and any local steps that follow it)."""

    def __init__(self, works, finish, then=None, keep=()):
        self._works = works
        self._finish = finish
        self._then = then
        self._keep = keep  # send buffers stay alive until the wait

    def wait(self):
        for w in self._works:
            w.wait()
        self._keep = ()
        v = self._finish()
        return self._then(v) if self._then is not None else v


class StepContext:
    """One rank's view of a running schedule: its mesh coordinate, the
    collectives of every step kind, and the record of what it issued.

    ``issued`` lists ``(nid, kind, axes, elems)`` for every wire collective
    this rank started, with ``elems`` ring-priced from the tensor actually
    sent (``_wire_elems``) — the run-time twin of the static trace.  The
    gathers that assemble the program's outputs are not recorded: they are
    the counterpart of ``shard_map`` handing back a global array.

    gloo moves host memory only, so where gloo ranks hold CUDA blocks
    (several ranks sharing one card) every collective stages its blocks
    through the host; NCCL ranks hand their CUDA blocks over as they are.
    """

    _OPS = {"psum": "SUM", "pmax": "MAX", "pmin": "MIN"}

    def __init__(self, mesh, sizes: dict[str, int]):
        self.mesh = mesh
        self.sizes = sizes
        self.n_dev = math.prod(sizes.values()) if sizes else 1
        self.nid = -1
        self.issued: list[tuple] = []
        self._stage = (mesh.device.type == "cuda" and mesh.world_size > 1
                       and _backend() == "gloo")

    # -- layouts ----------------------------------------------------------------

    def shard(self, x, layout: Layout):
        """This rank's block of a global tensor under ``layout``."""
        for d, axes in enumerate(layout):
            for ax in axes:
                x = self._slice(x, ax, d)
        return x

    def assemble(self, x, layout: Layout):
        """The global tensor from every rank's block (unrecorded gathers,
        minor axis first)."""
        for d, axes in enumerate(layout):
            for ax in reversed(axes):
                x = self._issue(x, ("all_gather", ax, d)).wait()
        return x

    def _slice(self, x, ax: str, dim: int):
        sz = x.shape[dim] // self.sizes[ax]
        return x.narrow(dim, self.mesh.coord[ax] * sz, sz)

    # -- steps ------------------------------------------------------------------

    def run(self, x, steps: list[tuple], nid: int | None = None):
        """Apply ``steps`` to ``x`` now."""
        for st in steps:
            if st[0] == "slice":
                x = self._slice(x, st[1], st[2])
            else:
                x = self._record(x, st, nid)._issue(x, st).wait()
        return x

    def start(self, x, steps: list[tuple], nid: int) -> _Pending:
        """Start a hoisted repartition chain: every step up to its last
        collective runs now, that collective is left in flight
        (``async_op=True``), and the local slices after it run at
        ``wait()``, where the consumer reads the value."""
        last = max(i for i, st in enumerate(steps) if st[0] in WIRE_KINDS)
        x = self.run(x, steps[:last], nid)
        pending = self._record(x, steps[last], nid)._issue(x, steps[last])
        rest = steps[last + 1:]
        pending._then = lambda v: self.run(v, rest, nid)
        return pending

    def _record(self, x, st: tuple, nid: int | None) -> "StepContext":
        kind = st[0]
        if kind in ("psum", "pmax", "pmin"):
            axes = tuple(st[1])
        elif kind == "ppermute":
            axes = (st[1], st[2])
        elif kind == "psum_scatter_grouped":
            axes = tuple(ax for ax, _ in st[1])
        else:
            axes = (st[1],)
        rec = "psum_scatter" if kind == "psum_scatter_grouped" else kind
        self.issued.append((self.nid if nid is None else nid, rec, axes,
                            _wire_elems(st, tuple(x.shape), self.sizes,
                                        self.n_dev)))
        return self

    def _issue(self, x, st: tuple) -> _Pending:
        if not self._stage:
            return self._collective(x, st)
        dev = x.device
        pending = self._collective(x.cpu(), st)
        finish = pending._finish
        pending._finish = lambda: finish().to(dev)
        return pending

    def _collective(self, x, st: tuple) -> _Pending:
        kind = st[0]
        mesh = self.mesh
        if kind == "all_gather":
            _, ax, dim = st
            w, out = self._gather(x, ax)
            return _Pending([w], lambda: _merge_leading(out, dim))
        if kind == "all_to_all":
            _, ax, src_dim, dst_dim = st
            inp = _split_leading(x, self.sizes[ax], dst_dim)
            out = torch.empty_like(inp)
            w = dist.all_to_all_single(out, inp, group=mesh.group((ax,)),
                                       async_op=True)
            return _Pending([w], lambda: _merge_leading(out, src_dim))
        if kind == "ppermute":
            # rank (old=i, new=j) ends up with block j, sourced from
            # (old=j, new=i): each rank trades blocks with the rank whose
            # two coordinates are swapped (the reference's linearised perm)
            _, ax_old, ax_new, _dim = st
            peer = dict(mesh.coord)
            peer[ax_old], peer[ax_new] = (mesh.coord[ax_new],
                                          mesh.coord[ax_old])
            return self._exchange([x], mesh.rank_at(peer),
                                  mesh.rank_at(peer), lambda r: r[0])
        if kind in self._OPS:
            y = x.contiguous()  # post-step inputs are fresh join outputs
            op = getattr(dist.ReduceOp, self._OPS[kind])
            w = dist.all_reduce(y, op=op, group=mesh.group(tuple(st[1])),
                                async_op=True)
            return _Pending([w], lambda: y)
        if kind == "psum_scatter":
            _, ax, dim = st
            return self._reduce_scatter(_split_leading(x, self.sizes[ax], dim),
                                        (ax,))
        if kind == "psum_scatter_grouped":
            # one reduce-scatter over the combined axis group, scattering
            # several dims at once: split each target dim into (k_i, rest),
            # bring the k_i factors to the front in axis order (the
            # row-major linearisation of the axes tuple), flatten, scatter
            pairs = st[1]
            ks = [self.sizes[ax] for ax, _ in pairs]
            dims = [d for _, d in pairs]
            new_shape: list[int] = []
            split_pos: dict[int, int] = {}
            for i, s in enumerate(x.shape):
                if i in dims:
                    k = ks[dims.index(i)]
                    split_pos[i] = len(new_shape)
                    new_shape += [k, s // k]
                else:
                    new_shape.append(s)
            y = x.reshape(new_shape)
            front = [split_pos[d] for d in dims]
            rest = [i for i in range(len(new_shape)) if i not in front]
            y = y.permute(front + rest)
            y = y.reshape((math.prod(ks),) + tuple(y.shape[len(front):]))
            return self._reduce_scatter(y.contiguous(),
                                        tuple(ax for ax, _ in pairs))
        if kind == "gather_reduce":
            if st[2] != "prod":  # the only agg without a ring collective
                raise ValueError(f"gather_reduce reducer {st[2]!r} unknown")
            w, out = self._gather(x, st[1])
            return _Pending([w], lambda: torch.prod(out, dim=0))
        raise ValueError(f"unknown step {st}")

    def _gather(self, x, ax: str):
        """Start an all-gather of ``x`` over ``ax``: (work, the (k, *shape)
        result).  The collective runs on flat buffers, the one form every
        backend takes."""
        x = x.contiguous()
        k = self.sizes[ax]
        out = torch.empty(k * x.numel(), dtype=x.dtype, device=x.device)
        w = dist.all_gather_into_tensor(out, x.reshape(-1),
                                        group=self.mesh.group((ax,)),
                                        async_op=True)
        return w, out.view((k,) + tuple(x.shape))

    def _reduce_scatter(self, y, axes: tuple[str, ...]) -> _Pending:
        """Sum-scatter ``y``'s leading axis over ``axes``: this rank keeps
        entry ``mesh.linear_index(axes)`` (row-major over ``axes`` in the
        given order).  A process group orders its members by global rank,
        so the entries are permuted into that order first."""
        order = self.mesh.member_indices(axes)
        if order != sorted(order):
            y = y[torch.tensor(order, device=y.device)]
        out = torch.empty(tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
        w = dist.reduce_scatter_tensor(out.view(-1), y.contiguous().view(-1),
                                       op=dist.ReduceOp.SUM,
                                       group=self.mesh.group(axes),
                                       async_op=True)
        return _Pending([w], lambda: out)

    def _exchange(self, xs, send_to: int, recv_from: int, finish) -> _Pending:
        """Send every tensor of ``xs`` to rank ``send_to`` and receive as
        many from ``recv_from`` (``batch_isend_irecv``); ``finish`` maps the
        received list to the value."""
        if send_to == self.mesh.rank:
            return _Pending([], lambda: finish(list(xs)))
        xs = [x.contiguous() for x in xs]
        bufs = [torch.empty_like(x) for x in xs]
        ops = ([dist.P2POp(dist.isend, x, send_to) for x in xs]
               + [dist.P2POp(dist.irecv, b, recv_from) for b in bufs])
        return _Pending(dist.batch_isend_irecv(ops), lambda: finish(bufs),
                        keep=xs)

    def ring_shift(self, xs, axes: tuple[str, ...], *, nid: int | None = None,
                   sizes: dict[str, int] | None = None) -> _Pending:
        """Pass every tensor of ``xs`` one hop around the ring over
        ``axes`` (linear index i -> i + 1), recorded as one ppermute event
        per tensor for ``nid`` (default: the current node) and ring-priced
        over ``sizes`` (default: this context's; a pipeline handoff rides
        the pp axis, which a stage's context does not span, and is priced
        over the whole mesh); ``wait()`` returns the received list."""
        mesh = self.mesh
        sizes = self.sizes if sizes is None else sizes
        nid = self.nid if nid is None else nid
        n_dev = math.prod(sizes.values())
        r = math.prod(sizes[a] for a in axes)
        idx = mesh.linear_index(axes)
        for x in xs:
            self.issued.append((nid, "ppermute", tuple(axes), n_dev * x.numel()))
        finish = lambda got: got  # noqa: E731
        if self._stage:
            dev = xs[0].device
            xs = [x.cpu() for x in xs]
            finish = lambda got: [g.to(dev) for g in got]  # noqa: E731
        return self._exchange(xs, mesh.rank_at_linear(axes, (idx + 1) % r),
                              mesh.rank_at_linear(axes, (idx - 1) % r),
                              finish)

    # -- the a2a rule's collectives ------------------------------------------------
    #
    # Both index their stacked entries by the row-major linear index along
    # ``axes`` (``mesh.linear_index``), as the reference's tuple-axis
    # collectives do; a process group orders its members by global rank, so
    # the entries are permuted between the two orders around the call.

    def _group_order(self, axes) -> torch.Tensor | None:
        order = self.mesh.member_indices(axes)
        return None if order == sorted(order) else torch.tensor(order)

    def all_gather_stacked(self, x, axes: tuple[str, ...]):
        """(r, *x.shape): entry i is the block of the rank at linear index
        i along ``axes``.  Recorded as one all_gather event."""
        r = math.prod(self.sizes[a] for a in axes)
        self.issued.append((self.nid, "all_gather", tuple(axes),
                            self.n_dev * (r - 1) * x.numel()))
        dev = x.device
        y = x.contiguous()
        if self._stage:
            y = y.cpu()
        out = torch.empty((r,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out.view(-1), y.view(-1),
                                    group=self.mesh.group(axes))
        order = self._group_order(axes)
        if order is not None:
            out = out[torch.argsort(order).to(out.device)]
        return out.to(dev)

    def all_to_all_stacked(self, x, axes: tuple[str, ...]):
        """``x (r, ...)``: entry i goes to the rank at linear index i along
        ``axes``; entry j of the result came from the rank at index j.
        Recorded as one all_to_all event."""
        r = math.prod(self.sizes[a] for a in axes)
        self.issued.append((self.nid, "all_to_all", tuple(axes),
                            self.n_dev * (r - 1) * x.numel() // r))
        dev = x.device
        order = self._group_order(axes)
        if order is not None:
            x = x[order.to(dev)]
        inp = x.contiguous()
        if self._stage:
            inp = inp.cpu()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=self.mesh.group(axes))
        if order is not None:
            out = out[torch.argsort(order).to(out.device)]
        return out.to(dev)


def _backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


class SpmdRunner:
    """``f(*global_inputs) -> tuple(global outputs)`` over one mesh.

    Each rank is handed the global inputs, keeps its blocks under the
    schedule's input layouts (local slices), runs the per-node programs
    with explicit collectives, and hands back the global outputs (gathered
    from every rank's block).  ``issued`` holds what this rank issued in
    the last call (``StepContext.issued``)."""

    def __init__(self, g: EinGraph, sched: Schedule, out_ids: list[int],
                 mesh):
        self.graph = g
        self.schedule = sched
        self.out_ids = out_ids
        self.mesh = mesh
        self.issued: list[tuple] = []

    def __call__(self, *arrays):
        g, sched, dev = self.graph, self.schedule, self.mesh.device
        ctx = StepContext(self.mesh, sched.sizes)
        vals: dict[int, Any] = {}
        for i, arr in zip(g.input_ids(), arrays):
            x = ctx.shard(torch.as_tensor(arr), sched.layouts[i])
            vals[i] = x.to(dev)
        run_schedule_body(g, sched, vals, ctx, keep=set(self.out_ids))
        self.issued = ctx.issued
        return tuple(ctx.assemble(vals[o], sched.layouts[o])
                     for o in self.out_ids)


def make_spmd_runner(
    g: EinGraph,
    out_ids: Sequence[int] | None = None,
    *,
    plan,
    mesh,
    trace: CollectiveTrace | None = None,
    fuse: bool = True,
    lookahead: int = 1,
) -> SpmdRunner:
    """Build the per-rank runner executing the planned graph with explicit
    collectives over ``mesh`` (a ``launch.mesh.Mesh``).

    Requires a mesh-mode plan (``plan.axes_by_node``); ``trace`` (optional)
    receives the static ``CollectiveEvent`` schedule at build time.
    ``fuse=False`` disables the fused repartition planner (the unfused
    lowering, kept as the equivalence baseline).  ``lookahead`` (default 1)
    enables the graph-wide overlap pass: ready consumers' arg repartitions
    are issued (``async_op=True``) before an earlier node's compute block
    and waited on by the consumer — the same values flow through the same
    collectives in a different issue order, so outputs are bit-identical
    to ``lookahead=0``.
    """
    from repro_torch.core import engine

    if plan is None or mesh is None:
        raise ValueError("make_spmd_runner: shard_map execution needs both "
                         "a plan and a mesh")
    if plan.mode != "mesh":
        raise ValueError(
            f"make_spmd_runner: plan mode {plan.mode!r} is not mesh-mode — "
            "plan with mesh_axes so labels map to named mesh axes")
    out_ids = list(out_ids) if out_ids is not None else g.outputs()
    sched = build_schedule(g, plan, engine.mesh_axes_dict(mesh), out_ids,
                           fuse=fuse, lookahead=lookahead)
    if trace is not None:
        trace.extend(sched.trace)
    return SpmdRunner(g, sched, out_ids, mesh)


def _last_uses(g: EinGraph, live: set[int]) -> dict[int, list[int]]:
    """{nid: node ids whose last reader among ``live`` is nid}."""
    last: dict[int, int] = {}
    for n in g.nodes:
        if n.nid not in live:
            continue
        for a in n.inputs:
            last[a] = max(last.get(a, -1), n.nid)
    out: dict[int, list[int]] = {}
    for a, nid in last.items():
        out.setdefault(nid, []).append(a)
    return out


def run_schedule_body(g: EinGraph, sched: Schedule, vals: dict[int, Any],
                      ctx: StepContext,
                      keep: set[int] | None = None) -> dict[int, Any]:
    """Execute a built ``Schedule``'s per-node programs on this rank.
    ``vals`` maps every input node id to its local block on entry; on
    return it additionally holds the computed nodes' local values — all of
    them, or with ``keep`` only those in ``keep``: every other value is
    dropped after its last reader, so its memory goes back to the
    allocator (an eager runner's counterpart of the buffer reuse a
    compiler does), and nodes ``keep`` does not depend on are not run
    (``engine.live_nodes``: the dead code a compiler drops, with its
    collectives — every rank skips the same nodes).

    Hoisted repartition chains (``prog.prefetch``) are started before the
    issuing node's compute block and waited on by their consumer."""
    from repro_torch.core import engine

    progs = {p.nid: p for p in sched.programs}
    live = (engine.live_nodes(g, keep) if keep is not None
            else {n.nid for n in g.nodes})
    frees = _last_uses(g, live) if keep is not None else {}
    prefetched: dict[tuple[int, int], _Pending] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind == "input":
            continue
        prog = progs[nid]
        for (m, ai) in prog.prefetch:
            if m not in live:
                continue
            a = g.nodes[m].inputs[ai]
            prefetched[(m, ai)] = ctx.start(vals[a], progs[m].arg_steps[ai],
                                            nid=m)
        if nid not in live:
            continue
        ctx.nid = nid
        args = [prefetched.pop((nid, i)).wait()
                if (nid, i) in prefetched
                else ctx.run(vals[a], steps, nid)
                for i, (a, steps) in enumerate(zip(n.inputs,
                                                   prog.arg_steps))]
        if n.kind == "einsum":
            v = local_einsum(n.spec, *args)
            v = ctx.run(v, prog.post_steps, nid)
        elif n.kind == "map":
            v = engine.MAP_FNS[n.op](vals[n.inputs[0]], **n.params)
        else:  # opaque: the shard rule's per-rank program
            v = prog.run(args, ctx)
            v = ctx.run(v, prog.post_steps, nid)
        del args
        vals[nid] = v
        for a in frees.get(nid, ()):
            if a not in keep:
                vals.pop(a, None)
    return vals

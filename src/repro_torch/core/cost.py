"""Communication-cost model for a decomposition (paper §7).

All costs are *upper bounds on floating-point numbers transferred*, exactly
as in the paper: every input to a dataflow node is assumed to be moved to
the processor where it is used.  All decompositions of a node have identical
FLOP counts, so comparing transfer volume is sufficient (§7).

Three cost terms per EinSum node:

  cost_join   — moving sub-tensors to the p join sites.
  cost_agg    — moving joined sub-tensors to their aggregation sites.
  cost_repart — re-slicing a producer's output relation into the
                partitioning the consumer requires.

The paper's §7 worked examples are reproduced in tests/test_cost.py.
(One known erratum: the paper's join example prints "8 x (16+16)" while its
own figures count 16 kernel calls for d=[4,1,1,4]; the *formula* is
p x (n_X + n_Y) with p = N(lX,lY,d) join results, which we implement.)

A second, *beyond-paper* cost mode ("collective") prices repartitions and
aggregations at torus-collective cost instead of point-to-point upper
bounds: all-gather / reduce-scatter at ring cost (k-1)/k * bytes, all-to-all
at bytes/k.  See DESIGN.md §2 (second adaptation).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.einsum import EinSpec
from repro_torch.core.tra import ld_concat, project

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def n_join_results(lx: Sequence[str], ly: Sequence[str], d_by_label: dict[str, int]) -> int:
    """N(lX, lY, d) (§6): number of tuple pairs matched by the join =
    product of d over the *unique* labels of the two inputs."""
    return _prod(d_by_label[l] for l in ld_concat(lx, ly))


def sub_numel(bounds: dict[str, int], d: dict[str, int], labels: Sequence[str]) -> int:
    """Floats per sub-tensor of a tensor with the given labels: prod(b/d)."""
    return _prod(bounds[l] // d[l] for l in labels)


# ---------------------------------------------------------------------------
# §7 cost terms.  All take d as a {label: parts} map plus {label: bound}.
# ---------------------------------------------------------------------------


def cost_join(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """p * (n_X + n_Y): each of the p join sites receives one sub-tensor
    from each side.  Unary nodes move nothing (map runs in place)."""
    if len(spec.in_labels) == 1:
        return 0
    lx, ly = spec.in_labels
    p = n_join_results(lx, ly, d)
    nx = sub_numel(bounds, d, lx)
    ny = sub_numel(bounds, d, ly)
    return p * (nx + ny)


def cost_agg(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """(p / n_agg) * (n_agg - 1) * n_Z: per aggregation group, all but one
    of the n_agg sub-tensors must move to the aggregation site."""
    if not spec.agg_labels:
        return 0
    if len(spec.in_labels) == 2:
        lx, ly = spec.in_labels
        p = n_join_results(lx, ly, d)
    else:
        p = _prod(d[l] for l in spec.in_labels[0])
    n_agg = _prod(d[l] for l in spec.agg_labels)
    if n_agg == 1:
        return 0
    n_z = sub_numel(bounds, d, spec.out_labels)
    return (p // n_agg) * (n_agg - 1) * n_z


def cost_repart(
    d_from: Sequence[int], d_to: Sequence[int], bound: Sequence[int],
    sites: int = 1,
) -> int:
    """§7 re-partitioning upper bound, from the producer's partitioning
    ``d_from`` to the consumer's required ``d_to`` over a tensor ``bound``.

    n_p   floats per producer sub-tensor        = prod(bound / d_from)
    n_c   floats per consumer sub-tensor        = prod(bound / d_to)
    n_int floats a producer block contributes
          to one consumer block                 = prod(min of block shapes)
    n     floats in the whole tensor            = prod(bound)

    cost = (n_c/n_int - 1) * (n/n_c) * (n_c + n_p)
           [+ n_p * (n/n_c) if n_p != n_int]

    ``sites`` counts *distinct consumer placement sites* the repartitioned
    relation must land on.  The §7 bound above delivers the tensor to one
    consumer-block site each; when the consumer runs replicated on ``sites``
    device groups (a gather to a replicated opaque consumer on a p-device
    mesh has sites = p / prod(d_to)), every extra group must receive the
    full tensor once more, adding (sites - 1) * n.  The default sites=1 is
    byte-identical to the historical single-site bound.
    """
    d_from = tuple(int(x) for x in d_from)
    d_to = tuple(int(x) for x in d_to)
    if d_from == d_to:
        return 0
    bp = [b // df for b, df in zip(bound, d_from)]   # producer block shape
    bc = [b // dt for b, dt in zip(bound, d_to)]     # consumer block shape
    n_p = _prod(bp)
    n_c = _prod(bc)
    n_int = _prod(min(a, b) for a, b in zip(bp, bc))
    n = _prod(bound)
    cost = (n_c // n_int - 1) * (n // n_c) * (n_c + n_p)
    if n_p != n_int:
        cost += n_p * (n // n_c)
    if sites > 1:
        cost += (sites - 1) * n
    return cost


def node_cost(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """cost_join + cost_agg for executing one node under d (repartition of
    the *inputs* into this d is charged separately by the DP)."""
    return cost_join(spec, d, bounds) + cost_agg(spec, d, bounds)


# ---------------------------------------------------------------------------
# Beyond-paper: collective-aware cost mode (DESIGN.md §2, adaptation 2).
#
# On a torus, a repartition is not p2p block shuffling, it lowers to one of:
#   * all-gather   (un-splitting a dimension):    (k-1)/k * n   per device row
#   * all-to-all   (moving split between dims):   ~ n / k
#   * reduce-scatter (during aggregation):        (k-1)/k * n
# We price the aggregated tensor movement accordingly.  This changes the
# *relative* cost of plans that re-shard between ops vs plans that aggregate,
# and is measured as a §Perf iteration, never silently substituted.
# ---------------------------------------------------------------------------


def repart_collective_terms(
    d_from: Sequence[int], d_to: Sequence[int], bound: Sequence[int]
) -> dict[str, int]:
    """Collective repartition price decomposed by collective kind, so a
    calibrated ``CostModel`` can weight each kind by its measured constant."""
    d_from = tuple(int(x) for x in d_from)
    d_to = tuple(int(x) for x in d_to)
    terms = {"all_gather": 0, "all_to_all": 0}
    if d_from == d_to:
        return terms
    n = _prod(bound)
    for df, dt in zip(d_from, d_to):
        if df == dt:
            continue
        if df > dt:
            k = df // max(dt, 1)
            terms["all_gather"] += (k - 1) * n // max(k, 1)
        else:
            k = dt // max(df, 1)
            terms["all_to_all"] += n // max(k, 1)  # scatter / all-to-all
    return terms


def cost_repart_collective(
    d_from: Sequence[int], d_to: Sequence[int], bound: Sequence[int],
    sites: int = 1,
) -> int:
    """Collective repartition price; with ``sites`` > 1 every distinct
    consumer placement group runs its own collective over the same volume
    (the traced schedule replays the gather once per replica group)."""
    return max(sites, 1) * sum(
        repart_collective_terms(d_from, d_to, bound).values())


def cost_agg_collective(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """reduce-scatter pricing: (k-1)/k of the *output* tensor per reduction
    group, instead of the paper's (n_agg-1) full sub-tensor moves."""
    if not spec.agg_labels:
        return 0
    n_agg = _prod(d[l] for l in spec.agg_labels)
    if n_agg == 1:
        return 0
    out_total = _prod(bounds[l] for l in spec.out_labels)
    return (n_agg - 1) * out_total // n_agg


def cost_join_collective(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """Collective pricing of the join's input movement.

    Partitioning vector ``d`` yields p = N(lX, lY, d) join sites; input i,
    stored as n_i = prod(d over its own labels) blocks, is therefore needed
    at r_i = p / n_i sites per block.  On a torus that replication is a
    broadcast / all-gather over each replica group: the copy already
    resident is free and every one of the (r_i - 1) extra copies crosses
    the wire exactly once, so the term is (r_i - 1) * numel_i per input —
    exactly the §7 p2p join bound r_i * numel_i minus the resident copies.
    Unary nodes move nothing (map runs in place).
    """
    if len(spec.in_labels) == 1:
        return 0
    lx, ly = spec.in_labels
    p = n_join_results(lx, ly, d)
    total = 0
    for ls in (lx, ly):
        n_i = _prod(d[l] for l in ls)
        r = p // n_i
        if r > 1:
            total += (r - 1) * _prod(bounds[l] for l in ls)
    return total


def node_cost_collective(spec: EinSpec, d: dict[str, int], bounds: dict[str, int]) -> int:
    """cost_join_collective + cost_agg_collective — the collective-mode
    counterpart of ``node_cost``.  (Historically the collective mode
    silently dropped the join term entirely, which made any replicating
    partitioning look free; regression-pinned in tests/test_cost.py.)"""
    return (cost_join_collective(spec, d, bounds)
            + cost_agg_collective(spec, d, bounds))


# ---------------------------------------------------------------------------
# Beyond-paper: overlap-aware exposed wire (graph-wide lookahead prefetch).
#
# The §7 terms price wire *volume*; wall-clock pays only the part not hidden
# behind local compute.  The shard_map executor's lookahead pass issues each
# ready consumer's repartition chain before an earlier node's compute block
# (core/spmd.py), so the wire it moves is overlappable — but a compute block
# can only hide so much: we bound the hidden volume per issue site by that
# site's local-compute window (its local output elems), so the term can't
# pretend unbounded traffic disappears behind a tiny block.
# ---------------------------------------------------------------------------


def exposed_wire(total_elems: int, overlap_by_site: dict[int, int],
                 window_by_site: dict[int, int]) -> int:
    """Exposed (non-hidden) wire elems of a schedule.

    ``total_elems`` is the schedule's total traced wire volume;
    ``overlap_by_site`` maps each issue site (node id) to the overlappable
    wire elems issued behind its compute block (hoisted prefetch chains at
    their issue node, rule-internal overlaps like the ring's double buffer
    at their own node); ``window_by_site`` maps each node to its
    local-compute window (``Schedule.compute_elems`` — local output elems,
    the proxy for how much wire that block can hide).

        exposed = max(total − Σ_site min(overlap, window), 0)
    """
    hidden = sum(min(int(v), int(window_by_site.get(site, 0)))
                 for site, v in overlap_by_site.items())
    return max(int(total_elems) - hidden, 0)


# ---------------------------------------------------------------------------
# Beyond-paper: pipeline-bubble pricing (GPipe fill/drain over a `pp` axis).
#
# The §7 terms price wire; a pipeline additionally pays *idle* device time
# while the schedule fills and drains.  With p stages and m microbatches the
# GPipe schedule runs m + p - 1 ticks of which p - 1 are fill/drain, so the
# static bubble fraction is (p-1)/(m+p-1) — independent of tensor sizes.
# The measured variant replaces the uniform tick with per-stage compute
# weights: makespan = sum(c_s) + (m-1) * max(c_s) (every microbatch after
# the first waits on the slowest stage), busy = m * sum(c_s) over p workers.
# ---------------------------------------------------------------------------


def bubble_fraction(stages: int, microbatches: int) -> float:
    """Static GPipe bubble fraction (p - 1) / (m + p - 1)."""
    p, m = int(stages), int(microbatches)
    if p <= 1:
        return 0.0
    return (p - 1) / (m + p - 1)


def bubble_fraction_weighted(stage_compute: Sequence[int],
                             microbatches: int) -> float:
    """Bubble fraction under per-stage compute weights ``stage_compute``
    (per-microbatch cost proxies, e.g. local compute elems).  Equals the
    static ``bubble_fraction`` exactly when the stages are balanced and
    degrades gracefully under imbalance (the slowest stage paces the
    steady state)."""
    cs = [int(c) for c in stage_compute]
    p, m = len(cs), int(microbatches)
    if p <= 1 or sum(cs) == 0:
        return 0.0
    makespan = sum(cs) + (m - 1) * max(cs)
    busy = m * sum(cs)
    return max(1.0 - busy / (p * makespan), 0.0)


# ---------------------------------------------------------------------------
# CostModel: the pricing strategy the §8 DP runs with.
# ---------------------------------------------------------------------------


class CostModel:
    """Paper (§7 p2p upper bound) vs collective (torus ring) pricing —
    DESIGN.md §2 second adaptation.  The DP is identical; only the repart
    and aggregation prices change.

    In collective mode an optional ``coeffs`` map scales each collective
    kind's ring-formula price by a measured constant (relative to
    all-gather), so the DP prices with *observed* interconnect behavior
    instead of the analytic formulas.  Build one from a
    ``bench_spmd.py --emit-costs`` dump via ``CostModel.with_measured``.
    """

    def __init__(self, mode: str = "paper",
                 coeffs: dict[str, float] | None = None):
        assert mode in ("paper", "collective")
        self.mode = mode
        self.coeffs = dict(coeffs) if coeffs else None

    def describe(self) -> str:
        """Stable one-line description of the pricing this model applies —
        recorded alongside benchmark output so BENCH artifacts say which
        cost model produced their numbers."""
        if not self.coeffs:
            return self.mode
        co = ", ".join(f"{k}={v:.3f}" for k, v in sorted(self.coeffs.items()))
        return f"{self.mode}[{co}]"

    def __repr__(self):
        return f"CostModel({self.describe()})"

    def repart(self, d_from, d_to, bound, sites: int = 1):
        if self.mode == "collective":
            if self.coeffs:
                terms = repart_collective_terms(d_from, d_to, bound)
                return int(max(sites, 1) * sum(v * self.coeffs.get(k, 1.0)
                                               for k, v in terms.items()))
            return cost_repart_collective(d_from, d_to, bound, sites=sites)
        return cost_repart(d_from, d_to, bound, sites=sites)

    def node(self, spec, d, bounds):
        if self.mode == "collective":
            if self.coeffs:
                join = cost_join_collective(spec, d, bounds)
                agg = cost_agg_collective(spec, d, bounds)
                return int(join * self.coeffs.get("all_gather", 1.0)
                           + agg * self.coeffs.get("psum_scatter", 1.0))
            return node_cost_collective(spec, d, bounds)
        return node_cost(spec, d, bounds)

    def exposed(self, total_elems: int, overlap_by_site: dict[int, int],
                window_by_site: dict[int, int]) -> int:
        """Overlap-aware exposed wire of a realized schedule (see
        ``exposed_wire``) — the volume left after hiding each issue site's
        overlappable traffic behind its local-compute window.  Mode- and
        coefficient-independent: overlap changes *when* wire moves, not
        how a kind is priced."""
        return exposed_wire(total_elems, overlap_by_site, window_by_site)

    @classmethod
    def with_measured(cls, source) -> "CostModel":
        """Collective-mode model calibrated from measured constants.

        ``source`` is a path to (or dict of) the JSON that
        ``benchmarks/bench_spmd.py --emit-costs out.json`` writes:
        ``{"kinds": {kind: {"ns_per_elem": float, ...}, ...}, ...}``.
        Each kind's price is scaled by its measured ns-per-element relative
        to all-gather's (the reference collective); kinds the measurement
        missed keep coefficient 1.0.
        """
        import json
        from pathlib import Path

        obj = source if isinstance(source, dict) else json.loads(
            Path(source).read_text())
        kinds = obj.get("kinds", obj)
        ns = {k: float(v["ns_per_elem"]) for k, v in kinds.items()
              if isinstance(v, dict) and v.get("ns_per_elem")}
        if not ns:
            return cls("collective")
        base = ns.get("all_gather") or (sum(ns.values()) / len(ns))
        return cls("collective",
                   coeffs={k: v / base for k, v in ns.items()})

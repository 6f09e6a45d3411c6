"""EinDecomp (paper §6, §8): choose a partitioning vector per EinGraph node.

Two search spaces (DESIGN.md §2, first adaptation):

* ``viable_pow2`` — the paper's space: every unique label gets a power-of-two
  partition count, the product over unique labels is exactly p ("enough
  parallel work": p join results = p kernel calls, §6).  Counting matches
  §8.1's balls-in-buckets formula.  Used by the reference TRA runtime and
  the paper-figure benchmarks.

* ``viable_mesh`` — the torus-conformable subset: assignments of whole named
  mesh axes to labels.  Every axis must be assigned (idle axes = replicated
  compute), so the product is exactly p = prod(mesh shape) whenever bounds
  permit.  Each element also records the label->axes map needed to emit a
  ``PartitionSpec`` (core/plan.py).

The DP is §8.2/8.3 verbatim: a table M[(v, d_Z)] = optimal cost of the
subgraph up to v given output partitioning d_Z, filled in topological order;
the input-side ``min over d_X of M[vX, dX] + cost_repart(...)`` is memoized
per (producer, target) pair.  General DAGs are linearized per §8.4.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

# CostModel lives in core/cost.py (where the calibration hook is); it is
# re-exported here because the planner surface historically owned it.
from repro_torch.core.cost import CostModel, cost_repart, node_cost  # noqa: F401
from repro_torch.core.einsum import EinGraph, EinSpec, Node
from repro_torch.core.tra import ld_concat, project

# ---------------------------------------------------------------------------
# Partitioning enumeration (§8.1)
# ---------------------------------------------------------------------------


def _pow2_splits(total_log2: int, n_buckets: int):
    """All ways to place `total_log2` balls into `n_buckets` buckets."""
    if n_buckets == 0:
        if total_log2 == 0:
            yield ()
        return
    for first in range(total_log2 + 1):
        for rest in _pow2_splits(total_log2 - first, n_buckets - 1):
            yield (first,) + rest


def count_partitionings(n_log2p: int, n_labels: int) -> int:
    """(N + D - 1)! / (N! (D-1)!) — §8.1."""
    return math.comb(n_log2p + n_labels - 1, n_labels - 1)


def node_label_universe(node: Node) -> tuple[str, ...]:
    """Unique labels of a node: for einsum the ⊙ of its input labels (join +
    agg structure); for opaque/input/map, output labels plus any declared
    input labels."""
    if node.kind == "einsum":
        if len(node.spec.in_labels) == 2:
            return tuple(ld_concat(*node.spec.in_labels))
        return tuple(node.spec.in_labels[0])
    labels = list(node.labels)
    for ls in node.in_labels:
        for l in ls:
            if l not in labels:
                labels.append(l)
    return tuple(labels)


def node_bounds(g: EinGraph, nid: int) -> dict[str, int]:
    """{label: bound} for every label in the node's universe."""
    node = g.nodes[nid]
    bounds: dict[str, int] = {}
    for l, s in zip(node.labels, node.shape):
        bounds[l] = s
    if node.kind == "einsum":
        for ls, a in zip(node.spec.in_labels, node.inputs):
            for l, s in zip(ls, g.nodes[a].shape):
                bounds[l] = s
    elif node.in_labels:
        for ls, a in zip(node.in_labels, node.inputs):
            for l, s in zip(ls, g.nodes[a].shape):
                bounds[l] = s
    return bounds


def viable_pow2(
    g: EinGraph, nid: int, p: int, *, divisible: bool = True
) -> list[dict[str, int]]:
    """All {label: parts} maps with power-of-two entries whose product over
    the node's unique labels is exactly p (§6: exactly p kernel calls).

    For opaque nodes, non-shardable labels are pinned to 1; if p parallel
    pieces are unreachable, the largest reachable power of two is used
    (beyond-paper necessity: the paper has no opaque nodes).
    """
    node = g.nodes[nid]
    labels = node_label_universe(node)
    bounds = node_bounds(g, nid)
    n = p.bit_length() - 1
    assert (1 << n) == p, "p must be a power of two (§8.1)"

    shardable = [True] * len(labels)
    if node.kind == "opaque" and node.shardable is not None:
        shardable = [l in node.shardable for l in labels]

    # per-label max log2 parts (2^m must divide the bound)
    def maxlog(l: str) -> int:
        b = bounds[l]
        m = 0
        while b % 2 == 0:
            m += 1
            b //= 2
        return m if divisible else max(0, bounds[l].bit_length() - 1)

    caps = [maxlog(l) if s else 0 for l, s in zip(labels, shardable)]
    target = min(n, sum(caps))
    out: list[dict[str, int]] = []
    for split in _pow2_splits(target, len(labels)):
        if all(e <= c for e, c in zip(split, caps)):
            out.append({l: 1 << e for l, e in zip(labels, split)})
    return out


@dataclass(frozen=True)
class MeshChoice:
    """One torus-conformable partitioning: parts per label + axis map."""

    d: tuple[tuple[str, int], ...]          # sorted (label, parts)
    axes: tuple[tuple[str, tuple[str, ...]], ...]  # label -> mesh axes

    @property
    def d_by_label(self) -> dict[str, int]:
        return dict(self.d)

    @property
    def axes_by_label(self) -> dict[str, tuple[str, ...]]:
        return dict(self.axes)


def viable_mesh(
    g: EinGraph, nid: int, mesh_axes: dict[str, int], *, allow_idle: bool = False
) -> list[MeshChoice]:
    """Torus-conformable partitionings: each named mesh axis is assigned to
    exactly one label (or left idle when ``allow_idle`` / unavoidable).
    Parts per label = product of its axes' sizes; must divide the bound."""
    node = g.nodes[nid]
    labels = node_label_universe(node)
    bounds = node_bounds(g, nid)
    shardable = set(labels)
    if node.kind == "opaque" and node.shardable is not None:
        shardable = {l for l in labels if l in node.shardable}

    axis_names = list(mesh_axes)
    options: list[MeshChoice] = []
    # each axis -> one of the labels, or None (idle).  Labels are offered in
    # node order so tie-optimal plans are deterministic across processes
    # (python set order is hash-randomized).
    ordered = [l for l in labels if l in shardable]
    slots: list[list[str | None]] = []
    for ax in axis_names:
        slots.append(ordered + [None])
    seen = set()
    for assign in itertools.product(*slots):
        if not allow_idle and any(a is None for a in assign):
            continue
        d: dict[str, int] = {l: 1 for l in labels}
        ax_map: dict[str, list[str]] = {}
        ok = True
        for ax, lab in zip(axis_names, assign):
            if lab is None:
                continue
            d[lab] *= mesh_axes[ax]
            ax_map.setdefault(lab, []).append(ax)
        for l in labels:
            if bounds[l] % d[l] != 0:
                ok = False
                break
        if not ok:
            continue
        key = (tuple(sorted(d.items())), tuple(sorted((k, tuple(v)) for k, v in ax_map.items())))
        if key in seen:
            continue
        seen.add(key)
        options.append(MeshChoice(
            tuple(sorted(d.items())),
            tuple(sorted((k, tuple(v)) for k, v in ax_map.items())),
        ))
    if not options and not allow_idle:
        return viable_mesh(g, nid, mesh_axes, allow_idle=True)
    return options


# ---------------------------------------------------------------------------
# Input partitioning domains
# ---------------------------------------------------------------------------


def input_partitionings(shape: Sequence[int], p: int) -> list[tuple[int, ...]]:
    """Possible pre-partitionings for a graph input: power-of-two slicings
    with total parts <= p (inputs are placed offline, §8.2: cost 0)."""
    n = p.bit_length() - 1
    caps = []
    for b in shape:
        m = 0
        bb = int(b)
        while bb % 2 == 0:
            m += 1
            bb //= 2
        caps.append(m)
    outs = set()
    for total in range(n + 1):
        for split in _pow2_splits(total, len(caps)):
            if all(e <= c for e, c in zip(split, caps)):
                outs.add(tuple(1 << e for e in split))
    return sorted(outs)


# ---------------------------------------------------------------------------
# The DP (§8.2, §8.3)
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """Result of EinDecomp: per-node partitioning (+ mesh axes if mesh mode)."""

    p: int
    d_by_node: dict[int, dict[str, int]] = field(default_factory=dict)
    axes_by_node: dict[int, dict[str, tuple[str, ...]]] = field(default_factory=dict)
    cost: int = 0
    mode: str = "pow2"  # or "mesh"

    def out_parts(self, g: EinGraph, nid: int) -> tuple[int, ...]:
        d = self.d_by_node[nid]
        return tuple(d.get(l, 1) for l in g.nodes[nid].labels)

    def to_json(self) -> dict:
        return {
            "p": self.p,
            "mode": self.mode,
            "cost": self.cost,
            "d": {str(k): v for k, v in self.d_by_node.items()},
            "axes": {str(k): {l: list(a) for l, a in v.items()}
                     for k, v in self.axes_by_node.items()},
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Plan":
        plan = cls(p=obj["p"], mode=obj.get("mode", "pow2"), cost=obj.get("cost", 0))
        plan.d_by_node = {int(k): dict(v) for k, v in obj["d"].items()}
        plan.axes_by_node = {
            int(k): {l: tuple(a) for l, a in v.items()}
            for k, v in obj.get("axes", {}).items()}
        return plan


class _DPState:
    """M table + choice backpointers + memoized best-input costs."""

    def __init__(self, g: EinGraph, p: int, cm: "CostModel | None" = None):
        self.g = g
        self.p = p
        self.cm = cm or CostModel()
        # M[(nid, dZ)] = cost; dZ a tuple over node.labels
        self.M: dict[tuple[int, tuple[int, ...]], float] = {}
        # choice[(nid, dZ)] = full d_by_label achieving it
        self.choice: dict[tuple[int, tuple[int, ...]], dict[str, int]] = {}
        self._best_in: dict[tuple[int, tuple[int, ...], int], float] = {}

    def entries(self, nid: int) -> list[tuple[tuple[int, ...], float]]:
        return [(dz, c) for (v, dz), c in self.M.items() if v == nid]

    def best_input_cost(self, a: int, target: tuple[int, ...],
                        sites: int = 1) -> float:
        """min over dA of M[a, dA] + cost_repart(dA -> target)  (§8.3)."""
        key = (a, target, sites)
        if key in self._best_in:
            return self._best_in[key]
        bound = self.g.nodes[a].shape
        best = math.inf
        for da, c in self.entries(a):
            best = min(best, c + self.cm.repart(da, target, bound, sites=sites))
        self._best_in[key] = best
        return best


def _node_choices(g: EinGraph, nid: int, p: int,
                  mesh_axes: dict[str, int] | None) -> list[tuple[dict[str, int], dict]]:
    """(d_by_label, axes_by_label) candidates for a node."""
    if mesh_axes is None:
        return [(d, {}) for d in viable_pow2(g, nid, p)]
    return [(c.d_by_label, c.axes_by_label) for c in viable_mesh(g, nid, mesh_axes)]


def eindecomp(
    g: EinGraph,
    p: int,
    *,
    mesh_axes: dict[str, int] | None = None,
    offpath_repart: bool = False,
    cost_mode: str = "paper",
    cache: "object | None" = None,
) -> Plan:
    """Run EinDecomp over a general DAG via §8.4 linearization.

    ``offpath_repart=True`` is the beyond-paper EinDecomp+ refinement: when an
    off-path input already has a partitioning assigned from a previous path,
    charge the true repartition cost instead of ignoring it.

    ``cache`` is an optional ``core.plancache.PlanCache``.  When given, the
    cache is consulted first under the canonical key of ``(g, p, mesh_axes,
    cost_mode, offpath_repart)`` — a hit returns a label-translated copy of
    the stored plan without running the DP at all — and on a miss the fresh
    plan is inserted before returning.  The per-path DP is additionally
    memoized on canonical path signatures (plancache.path_memo_key), so
    isomorphic layers inside one graph plan once.

    ``cost_mode`` may also be a ``CostModel`` instance (e.g.
    ``CostModel.with_measured(...)``) — its calibration coefficients then
    enter the cache key, so calibrated and formula-priced plans never
    collide.
    """
    # plan-time validation: every opaque comm declaration must resolve to a
    # registered shard rule, so the executor can realize what the DP priced
    from repro_torch.core import opaque_rules

    opaque_rules.validate_graph(g)
    if isinstance(cost_mode, CostModel):
        cm = cost_mode
        cost_mode = cm.mode if not cm.coeffs else (
            f"{cm.mode}|{sorted(cm.coeffs.items())}")
    else:
        cm = CostModel(cost_mode)
    cache_kw = dict(mesh_axes=mesh_axes, cost_mode=cost_mode,
                    offpath_repart=offpath_repart, algo="eindecomp")
    if cache is not None:
        hit = cache.lookup(g, p, **cache_kw)
        if hit is not None:
            return hit
        from repro_torch.core import plancache as _pc

    mode = "mesh" if mesh_axes is not None else "pow2"
    plan = Plan(p=p, mode=mode)
    labeled: set[int] = set()

    while True:
        path = _longest_unlabeled_path(g, labeled)
        if not path:
            break
        memo_key = memo_val = None
        if cache is not None:
            memo_key = _pc.path_memo_key(g, path, labeled, plan, p,
                                         mesh_axes, cost_mode, offpath_repart)
            memo_val = cache.path_memo_get(memo_key)
        if memo_val is not None:
            _pc.apply_path(g, path, memo_val, plan)
        else:
            _optimize_path(g, path, p, plan, labeled, mesh_axes,
                           offpath_repart, cm=cm)
            if cache is not None:
                cache.path_memo_put(memo_key, _pc.snapshot_path(g, path, plan))
        labeled.update(path)

    # inputs + map nodes inherit partitionings from consumers / producers
    _finalize_inputs(g, plan)
    # the per-path DP cost is an upper bound (it double-counts off-path
    # boundaries); report the exact §7 objective of the final labeling
    # (always the *paper* objective so plans are comparable across modes)
    plan.cost = plan_cost(g, plan)
    if cache is not None:
        cache.insert(g, p, plan, **cache_kw)
    return plan


def eindecomp_tree(
    g: EinGraph, p: int, *, mesh_axes: dict[str, int] | None = None,
    cache: "object | None" = None,
) -> Plan:
    """The exact §8.2 DP — valid when no non-input vertex has >1 consumer.
    Used by the tests to validate the linearized version against optimal.
    ``cache`` behaves as in ``eindecomp`` (keyed separately: the tree DP's
    reported cost is the exact DP objective, not ``plan_cost``)."""
    from repro_torch.core import opaque_rules

    opaque_rules.validate_graph(g)
    cache_kw = dict(mesh_axes=mesh_axes, algo="tree")
    if cache is not None:
        hit = cache.lookup(g, p, **cache_kw)
        if hit is not None:
            return hit
    cons = g.consumers()
    for n in g.nodes:
        if n.kind != "input" and len(cons[n.nid]) > 1:
            raise ValueError("eindecomp_tree requires single-consumer graphs (§8.4)")
    order = [nid for nid in g.topo_order() if g.nodes[nid].kind != "input"]
    plan = Plan(p=p, mode="mesh" if mesh_axes else "pow2")
    cost = _optimize_path(g, order, p, plan, set(), mesh_axes, False,
                          include_all_inputs=True, cm=CostModel())
    _finalize_inputs(g, plan)
    plan.cost = cost
    if cache is not None:
        cache.insert(g, p, plan, **cache_kw)
    return plan


def _longest_unlabeled_path(g: EinGraph, labeled: set[int]) -> list[int]:
    """Longest directed path through unlabeled non-input vertices (§8.4)."""
    best_len: dict[int, int] = {}
    best_pred: dict[int, int | None] = {}
    order = g.topo_order()
    for nid in order:
        n = g.nodes[nid]
        if n.kind == "input" or nid in labeled:
            continue
        best_len[nid] = 1
        best_pred[nid] = None
        for a in n.inputs:
            if a in best_len and best_len[a] + 1 > best_len[nid]:
                best_len[nid] = best_len[a] + 1
                best_pred[nid] = a
    if not best_len:
        return []
    end = max(best_len, key=lambda k: (best_len[k], k))
    path = [end]
    while best_pred[path[-1]] is not None:
        path.append(best_pred[path[-1]])
    path.reverse()
    return path


def _optimize_path(
    g: EinGraph,
    path: list[int],
    p: int,
    plan: Plan,
    labeled: set[int],
    mesh_axes: dict[str, int] | None,
    offpath_repart: bool,
    include_all_inputs: bool = False,
    cm: "CostModel | None" = None,
) -> int:
    """DP along one path (or a whole tree when include_all_inputs)."""
    cm = cm or CostModel()
    state = _DPState(g, p, cm)
    onpath = set(path)
    axes_choice: dict[tuple[int, tuple[int, ...]], dict] = {}

    # graph inputs need no seeding: _in_table/_input_cost enumerate their
    # pre-partitionings (§8.2, cost 0) directly wherever they are consumed

    for nid in path:
        n = g.nodes[nid]
        if n.kind == "map":
            # transparent: inherit the input's table (zero cost, no movement)
            a = n.inputs[0]
            for da, c in _in_table(state, g, a, p, onpath, labeled, plan,
                                   include_all_inputs, offpath_repart):
                key = (nid, da)
                if c < state.M.get(key, math.inf):
                    state.M[key] = c
                    state.choice[key] = dict(zip(n.labels, da))
            continue

        bounds = node_bounds(g, nid)
        for d, ax in _node_choices(g, nid, p, mesh_axes):
            if n.kind == "einsum":
                own = cm.node(n.spec, d, bounds)
            else:
                own = _opaque_comm_cost(g, n, d, bounds, p)
            total = float(own)
            feasible = True
            in_label_sets = (n.spec.in_labels if n.kind == "einsum" else
                             (n.in_labels or (n.labels,) * len(n.inputs)))
            for ls, a in zip(in_label_sets, n.inputs):
                target = tuple(d.get(l, 1) for l in ls)
                sites = _consumer_sites(n.kind, target, p)
                c = _input_cost(state, g, a, target, p, onpath, labeled, plan,
                                include_all_inputs, offpath_repart, sites)
                if c is None:
                    feasible = False
                    break
                total += c
            if not feasible:
                continue
            if offpath_repart:
                # EinDecomp+ (beyond §8.4): consumers already labeled on a
                # previous path pin their required input partitioning —
                # charge the true repart instead of ignoring the boundary.
                dz_here = tuple(d.get(l, 1) for l in n.labels)
                for m in _labeled_consumers(g, nid, labeled, onpath, plan):
                    for ls_m in g.edge_labels(m, nid):
                        dm = plan.d_by_node[m]
                        tgt = tuple(dm.get(l, 1) for l in ls_m)
                        total += cm.repart(
                            dz_here, tgt, n.shape,
                            sites=_consumer_sites(g.nodes[m].kind, tgt, p))
            dz = tuple(d.get(l, 1) for l in n.labels)
            key = (nid, dz)
            if total < state.M.get(key, math.inf):
                state.M[key] = total
                state.choice[key] = d
                axes_choice[key] = ax

    # pick the best final entry and backtrack
    finals = state.entries(path[-1])
    if not finals:
        raise RuntimeError(f"no feasible partitioning for path ending at {path[-1]}")
    dz_best, cost = min(finals, key=lambda t: (t[1], t[0]))
    _backtrack(g, state, axes_choice, path, dz_best, plan, p, onpath,
               labeled, include_all_inputs, offpath_repart)
    return int(cost)


def _consumer_sites(kind: str, target: Sequence[int], p: int) -> int:
    """Distinct consumer placement groups an input edge delivers to
    (ROADMAP fix: gathers to replicated consumers traced ~k× the priced
    cost).  Einsum consumers stay at 1 — ``cost_join`` already prices
    replication delivery to the join sites, so charging the edge again
    would double-count.  An opaque consumer with prod(target) distinct
    blocks on a p-device mesh runs each block on p // prod(target)
    replica groups; every group beyond the first receives the tensor
    once more (``cost_repart``'s ``sites`` term)."""
    if kind != "opaque":
        return 1
    t = 1
    for x in target:
        t *= int(x)
    return max(1, p // max(t, 1))


def _labeled_consumers(g, nid, labeled, onpath, plan):
    out = []
    for m in g.nodes:
        if nid in m.inputs and m.nid in plan.d_by_node and m.nid not in onpath:
            out.append(m.nid)
    return out


def _in_table(state, g, a, p, onpath, labeled, plan, include_all, offpath_repart):
    """Enumerate (parts, cost) options for consuming node `a`'s output."""
    node_a = g.nodes[a]
    if a in onpath or (include_all and node_a.kind != "input"):
        return state.entries(a)
    if node_a.kind == "input":
        return [(dparts, 0.0) for dparts in input_partitionings(node_a.shape, p)]
    if a in labeled:
        da = tuple(plan.d_by_node[a].get(l, 1) for l in node_a.labels)
        return [(da, 0.0)]  # its cost was already counted on its own path
    return None  # unlabeled off-path: §8.4 ignores it entirely


def _input_cost(state, g, a, target, p, onpath, labeled, plan,
                include_all, offpath_repart, sites=1):
    node_a = g.nodes[a]
    if a in onpath or (include_all and node_a.kind != "input"):
        c = state.best_input_cost(a, target, sites)
        return None if math.isinf(c) else c
    if node_a.kind == "input":
        # inputs are pre-placed: choose the best pre-partitioning, cost 0
        # if target itself is a valid pre-partitioning else min repart.
        opts = input_partitionings(node_a.shape, p)
        if target in opts:
            return 0.0
        return min(state.cm.repart(o, target, node_a.shape, sites=sites)
                   for o in opts)
    if a in labeled:
        if not offpath_repart:
            return 0.0  # paper-faithful §8.4: ignore cross-path repart
        da = tuple(plan.d_by_node[a].get(l, 1) for l in node_a.labels)
        return float(state.cm.repart(da, target, node_a.shape, sites=sites))
    return 0.0  # unlabeled off-path input: ignored (§8.4)


def _backtrack(g, state, axes_choice, path, dz_final, plan, p, onpath,
               labeled, include_all, offpath_repart):
    """Walk the path backwards assigning the d that realized each optimum."""
    need: dict[int, tuple[int, ...]] = {path[-1]: dz_final}
    for nid in reversed(path):
        n = g.nodes[nid]
        dz = need.get(nid)
        if dz is None:
            # node's output partitioning determined by its consumer's need —
            # if no on-path consumer recorded a need, pick its own best entry
            entries = state.entries(nid)
            dz = min(entries, key=lambda t: (t[1], t[0]))[0]
        key = (nid, dz)
        d = state.choice[key]
        plan.d_by_node[nid] = dict(d)
        if key in axes_choice and axes_choice[key]:
            plan.axes_by_node[nid] = dict(axes_choice[key])
        # propagate required partitionings to on-path producers
        in_label_sets = (n.spec.in_labels if n.kind == "einsum" else
                         (n.in_labels or ((n.labels,) * len(n.inputs))))
        if n.kind == "map":
            in_label_sets = (n.labels,)
        for ls, a in zip(in_label_sets, n.inputs):
            if a in onpath and g.nodes[a].kind != "input":
                target = tuple(d.get(l, 1) for l in ls)
                # producer chooses its own best dA for this target
                best, best_da = math.inf, None
                for da, c in state.entries(a):
                    t = c + cost_repart(da, target, g.nodes[a].shape)
                    if t < best:
                        best, best_da = t, da
                if best_da is not None and a not in plan.d_by_node:
                    need[a] = best_da


def _finalize_inputs(g: EinGraph, plan: Plan) -> None:
    """Assign input-node partitionings: what their first consumer requires.
    Map nodes missing (single-node paths edge cases) inherit their input.

    Labels are node-local, so entries are keyed by the node's *own* labels,
    translating positionally from the consumer's (or producer's) labels —
    the two may differ even though the graphs are semantically identical,
    and plan entries in foreign label spaces would not survive canonical
    translation (core/canon.py)."""
    for n in g.nodes:
        if n.nid in plan.d_by_node:
            continue
        if n.kind == "input":
            cons = [m for m in g.nodes if n.nid in m.inputs and m.nid in plan.d_by_node]
            if cons:
                m = cons[0]
                dm = plan.d_by_node[m.nid]
                for ls_i, a in zip(_in_labels_of(m), m.inputs):
                    if a == n.nid:
                        plan.d_by_node[n.nid] = {
                            nl: dm.get(cl, 1)
                            for nl, cl in zip(n.labels, ls_i)}
                        if m.nid in plan.axes_by_node:
                            am = plan.axes_by_node[m.nid]
                            plan.axes_by_node[n.nid] = {
                                nl: am[cl]
                                for nl, cl in zip(n.labels, ls_i) if cl in am}
                        break
            else:
                plan.d_by_node[n.nid] = {l: 1 for l in n.labels}
        elif n.kind == "map":
            a = n.inputs[0]
            if a in plan.d_by_node:
                src = plan.d_by_node[a]
                al = g.nodes[a].labels
                plan.d_by_node[n.nid] = {
                    nl: src.get(sl, 1) for nl, sl in zip(n.labels, al)}
                if a in plan.axes_by_node:
                    sax = plan.axes_by_node[a]
                    plan.axes_by_node[n.nid] = {
                        nl: sax[sl] for nl, sl in zip(n.labels, al)
                        if sl in sax}


def _in_labels_of(m: Node):
    if m.kind == "einsum":
        return m.spec.in_labels
    if m.kind == "map":
        return (m.labels,)
    return m.in_labels or tuple((m.labels,) * len(m.inputs))


def _opaque_comm_cost(g: EinGraph, n: Node, d: dict[str, int],
                      bounds: dict[str, int], p: int | None = None) -> int:
    """Internal communication of fused opaque ops (beyond-paper: the paper
    has no opaque nodes).  The declaration comes from the op's **OpDef**
    (``opdef.comm_for_node``: the registered comm template renamed into the
    node's instance labels; an explicit per-node ``params["comm"]`` still
    overrides), as entries
    [{"kind": "ring"|"a2a", "label": l, "input": i, "rule": name?}, ...]
    where ``input`` is an input index, or ``-1`` for the node's own output
    (the moved buffer of a combine-style op is its token-sided result, not
    its expert-sided input):

      ring — partitioning `l` r ways makes the referenced tensor circulate
             a ring: (r-1) * numel total floats (each device passes its
             1/r block r-1 hops — ring/flash sequence parallelism).
      a2a  — partitioning `l` r ways makes the referenced tensor cross an
             all-to-all: (r-1) * numel * (p/r) floats.  A *static-shape*
             all-to-all must size every (sender, receiver) lane for the
             worst case (one destination may claim a sender's whole block),
             so the per-group price equals the ring's, and when only r of
             the p processors shard `l` the remaining p/r groups carry the
             (replicated) buffer redundantly — the executor's shard rules
             (core/opaque_rules.py) emit exactly this schedule, which is
             what keeps traced-within-priced honest.  (The ragged
             (r-1)/r * numel ideal would under-price every realizable
             static schedule by p×.)  Without ``p`` the single-group price
             is used.

    The optional ``rule`` names the ``core.opaque_rules`` shard rule that
    *realizes* this schedule in the shard_map executor (defaulting to the
    kind's namesake), so pricing and lowering resolve the same schedule;
    ``eindecomp`` validates the resolution at plan time.
    """
    from repro_torch.core.opdef import comm_for_node

    comm = comm_for_node(n)
    if not comm:
        return 0
    total = 0
    for c in comm:
        r = int(d.get(c["label"], 1))
        if r <= 1:
            continue
        idx = c["input"]
        ls = n.labels if idx == -1 else n.in_labels[idx]
        numel = 1
        for l in ls:
            numel *= bounds[l]
        dup = max((p or r) // r, 1) if c["kind"] == "a2a" else 1
        total += (r - 1) * numel * dup
    return total


# ---------------------------------------------------------------------------
# Baseline heuristics the paper compares against (§9)
# ---------------------------------------------------------------------------


def plan_sqrt(g: EinGraph, p: int) -> Plan:
    """The "SQRT" baseline (§9.2 Exp 1): slice the first two dimensions of
    every tensor sqrt(p) ways each, ignore everything else."""
    import math as _m

    s = 1 << (max(0, (p.bit_length() - 1)) // 2)
    plan = Plan(p=p, mode="pow2")
    for n in g.nodes:
        labels = node_label_universe(n)
        bounds = node_bounds(g, n.nid)
        d = {l: 1 for l in labels}
        picked = 0
        for l in labels:
            if picked >= 2:
                break
            if bounds[l] % s == 0:
                d[l] = s
                picked += 1
        plan.d_by_node[n.nid] = d
    plan.cost = plan_cost(g, plan)
    return plan


def plan_data_parallel(g: EinGraph, p: int, batch_label: str = "b") -> Plan:
    """Classic data parallelism: shard only the batch label everywhere."""
    plan = Plan(p=p, mode="pow2")
    for n in g.nodes:
        labels = node_label_universe(n)
        bounds = node_bounds(g, n.nid)
        d = {l: 1 for l in labels}
        if batch_label in d and bounds[batch_label] % p == 0:
            d[batch_label] = p
        plan.d_by_node[n.nid] = d
    plan.cost = plan_cost(g, plan)
    return plan


def plan_label(g: EinGraph, p: int, label: str) -> Plan:
    """Shard one named label p ways everywhere it appears (e.g. Megatron =
    shard the head/ffn-hidden label; "sequence" = shard s)."""
    plan = Plan(p=p, mode="pow2")
    for n in g.nodes:
        labels = node_label_universe(n)
        bounds = node_bounds(g, n.nid)
        d = {l: 1 for l in labels}
        if label in d and bounds[label] % p == 0:
            d[label] = p
        plan.d_by_node[n.nid] = d
    plan.cost = plan_cost(g, plan)
    return plan


def plan_cost_by_node(g: EinGraph, plan: Plan) -> dict[int, int]:
    """Per-node §7 cost of a fully-labeled plan: each einsum/opaque node's
    own cost (node cost / declared opaque movement) plus the priced
    repartitions of its input edges, attributed to the *consumer* — the
    same attribution ``CollectiveTrace.elems_by_node`` uses, so the
    predicted/traced ratio compares like-for-like per node."""
    out: dict[int, int] = {}
    for n in g.nodes:
        total = 0
        if n.kind == "einsum":
            d = plan.d_by_node[n.nid]
            total += node_cost(n.spec, d, node_bounds(g, n.nid))
        if n.kind == "opaque":
            total += _opaque_comm_cost(g, n, plan.d_by_node.get(n.nid, {}),
                                       node_bounds(g, n.nid), plan.p)
        if n.kind in ("einsum", "opaque"):
            in_sets = _in_labels_of(n)
            d = plan.d_by_node[n.nid]
            for ls, a in zip(in_sets, n.inputs):
                na = g.nodes[a]
                if na.kind == "input":
                    continue  # pre-placed (§8.2)
                da_map = plan.d_by_node.get(a, {})
                da = tuple(da_map.get(l, 1) for l in na.labels)
                target = tuple(d.get(l, 1) for l in ls)
                total += cost_repart(da, target, na.shape,
                                     _consumer_sites(n.kind, target, plan.p))
            out[n.nid] = total
    return out


def plan_cost(g: EinGraph, plan: Plan) -> int:
    """Total §7 cost of a fully-labeled plan: node costs + actual reparts
    between producers and consumers.  (The objective EinDecomp minimizes,
    evaluated exactly — used to compare heuristic plans apples-to-apples.)"""
    return sum(plan_cost_by_node(g, plan).values())


def opaque_node_bound(g: EinGraph, plan: Plan, nid: int) -> int:
    """What ``plan_cost`` attributes to one opaque node: the declared
    internal movement (``_opaque_comm_cost``) plus the priced repartitions
    of its input edges.  A shard rule that realizes the declared schedule
    keeps the node's traced wire elems within this bound — the per-node
    property ``bench_spmd.py --check`` asserts for ring/a2a-ruled nodes
    (the replicated fallback is ~p× over it on sharded inputs)."""
    n = g.nodes[nid]
    assert n.kind == "opaque", (nid, n.kind)
    d = plan.d_by_node.get(nid, {})
    total = _opaque_comm_cost(g, n, d, node_bounds(g, nid), plan.p)
    for ls, a in zip(_in_labels_of(n), n.inputs):
        na = g.nodes[a]
        if na.kind == "input":
            continue  # pre-placed (§8.2)
        da_map = plan.d_by_node.get(a, {})
        da = tuple(da_map.get(l, 1) for l in na.labels)
        target = tuple(d.get(l, 1) for l in ls)
        total += cost_repart(da, target, na.shape,
                             _consumer_sites("opaque", target, plan.p))
    return total

"""Canonical forms + stable content hashes for EinSpecs and EinGraphs.

The §8 dynamic program is a pure function of a graph's *structure*: two
EinGraphs that differ only in label names, in bound/label permutations, or
in the operand order of a commutative combine have identical plan spaces and
identical optimal costs.  This module computes a canonical form whose hash
is invariant under exactly those transformations, so plans keyed by

    (canonical graph, p, cost-model mode, mesh shape)

transfer across isomorphic graphs (the retrieval idea of "Canonicalization
of Batched Einstein Summations for Tuning Retrieval", applied to whole
EinGraphs).  ``core/plancache.py`` builds the persistent cache on top.

Because labels are node-local in this IR (producers and consumers link
positionally, §5), canonicalization is per node: each node's label universe
is renamed de Bruijn-style — ``c0, c1, ...`` in order of first structural
appearance, scanning inputs (in canonical operand order) and then the
output.  Binary einsum nodes with a commutative combine additionally sort
their two operands by a label-name-free structural pattern, so ``X ⊗ Y``
and ``Y ⊗ X`` canonicalize identically.  Bounds enter the hash as a
*bound signature* aligned with the canonical label order, which makes the
hash invariant under joint (label, bound) permutations but sensitive to
any change in actual extents.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.decomp import Plan, node_bounds
from repro_torch.core.einsum import EinGraph, EinSpec, Node

#: Binary combiners with COMBINE(x, y) == COMBINE(y, x); for these, operand
#: order is normalized away by canonicalization.  (``sub``/``div``/``expsub``
#: are order-sensitive and keep their operand order.)
COMMUTATIVE_COMBINES = frozenset({"mul", "add", "sqdiff", "absdiff", "maximum"})


# ---------------------------------------------------------------------------
# Per-node canonicalization
# ---------------------------------------------------------------------------


def _operand_patterns(spec: EinSpec) -> list[tuple]:
    """A label-name-free structural code per operand of a binary spec: for
    each label, (index in out_labels or -1, index in the other operand or
    -1).  Invariant under renaming and under swapping the operands."""
    out = spec.out_labels
    pats = []
    for i, ls in enumerate(spec.in_labels):
        other = spec.in_labels[1 - i]
        pats.append(tuple(
            (out.index(l) if l in out else -1,
             other.index(l) if l in other else -1)
            for l in ls))
    return pats


def operand_order(node: Node) -> tuple[int, ...]:
    """Canonical order of a node's operands.

    Identity for everything except binary einsum nodes with a commutative
    combine, whose two operands are sorted by (structural pattern, producer
    node id) — both label-name-free, so the order agrees across isomorphic
    graphs regardless of how the caller happened to write the expression.
    """
    if node.kind != "einsum" or len(node.spec.in_labels) != 2:
        return tuple(range(len(node.inputs)))
    if node.spec.combine not in COMMUTATIVE_COMBINES:
        return (0, 1)
    pats = _operand_patterns(node.spec)
    keys = sorted(range(2), key=lambda i: (pats[i], node.inputs[i], i))
    return tuple(keys)


def node_label_map(g: EinGraph, nid: int) -> dict[str, str]:
    """{original label -> canonical label} over the node's label universe.

    Canonical names are assigned in order of first structural appearance:
    operands first (in canonical operand order), then the output labels.
    Deterministic given the node's structure alone, so isomorphic nodes get
    structurally identical maps.
    """
    node = g.nodes[nid]
    ren: dict[str, str] = {}

    def see(label: str) -> None:
        if label not in ren:
            ren[label] = f"c{len(ren)}"

    if node.kind == "einsum":
        for slot in operand_order(node):
            for l in node.spec.in_labels[slot]:
                see(l)
        for l in node.spec.out_labels:
            see(l)
    else:
        for ls in node.in_labels:
            for l in ls:
                see(l)
        for l in node.labels:
            see(l)
    return ren


def _dtype_str(dtype) -> str:
    try:
        return str(np.dtype(dtype))
    except TypeError:
        return str(dtype)


def _params_sig(params: dict, ren: dict[str, str]) -> str:
    """Stable string form of a node's params with label references (the
    opaque ``comm`` declarations) renamed canonically."""
    if not params:
        return ""
    out = {}
    for k, v in params.items():
        if k == "comm":
            v = [dict(entry, label=ren.get(entry["label"], entry["label"]))
                 for entry in v]
        out[k] = v
    return json.dumps(out, sort_keys=True, default=repr)


def _spec_sig(spec: EinSpec, ren: dict[str, str], order: tuple[int, ...]) -> tuple:
    ins = tuple(tuple(ren[l] for l in spec.in_labels[slot]) for slot in order)
    return (ins, tuple(ren[l] for l in spec.out_labels), spec.combine, spec.agg)


def node_struct(g: EinGraph, nid: int) -> tuple:
    """Canonical structure of one node, *excluding* its producer references
    (used both for whole-graph signatures and for path-local DP memo keys,
    where producers are encoded relationally by the caller)."""
    node = g.nodes[nid]
    ren = node_label_map(g, nid)
    order = operand_order(node)
    bounds = node_bounds(g, nid)
    return (
        node.kind,
        node.op,
        _spec_sig(node.spec, ren, order) if node.spec else None,
        tuple(ren[l] for l in node.labels),
        tuple(node.shape),
        _dtype_str(node.dtype),
        tuple(tuple(ren[l] for l in ls) for ls in node.in_labels),
        (tuple(sorted(ren[l] for l in node.shardable if l in ren))
         if node.shardable is not None else None),
        _params_sig(node.params, ren),
        tuple(sorted((cl, bounds[l]) for l, cl in ren.items() if l in bounds)),
    )


def node_signature(g: EinGraph, nid: int) -> tuple:
    """``node_struct`` plus the producer node ids in canonical operand
    order — the full per-node entry of a graph signature."""
    node = g.nodes[nid]
    inputs = tuple(node.inputs[i] for i in operand_order(node))
    return node_struct(g, nid) + (inputs,)


# ---------------------------------------------------------------------------
# Whole-graph canonicalization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CanonicalGraph:
    """The canonical form of an EinGraph.

    ``key`` is a stable sha256 content hash: equal for graphs that are
    isomorphic up to label renaming, (label, bound) permutation, and
    commutative operand order; distinct (modulo hash collisions) otherwise.
    ``label_maps[nid]`` maps each node's original labels to canonical ones,
    which is what lets a cached plan stored in canonical labels be rewritten
    back into any isomorphic caller's labels.
    """

    key: str
    signature: tuple
    label_maps: dict[int, dict[str, str]]

    def inverse_map(self, nid: int) -> dict[str, str]:
        """{canonical label -> original label} for one node."""
        return {c: o for o, c in self.label_maps[nid].items()}


def canonicalize(g: EinGraph) -> CanonicalGraph:
    """Compute (and memoize on the graph object) its canonical form.

    The memo is keyed on the node count: EinGraphs only ever grow by
    appending nodes, so a stale entry is impossible without mutating nodes
    in place (which nothing in this codebase does after construction).
    """
    cached = getattr(g, "_canon_cache", None)
    if cached is not None and cached[0] == len(g.nodes):
        return cached[1]
    signature = tuple(node_signature(g, nid) for nid in g.topo_order())
    key = hashlib.sha256(repr(signature).encode()).hexdigest()
    cg = CanonicalGraph(
        key=key,
        signature=signature,
        label_maps={nid: node_label_map(g, nid) for nid in g.topo_order()},
    )
    g._canon_cache = (len(g.nodes), cg)
    return cg


def graph_key(g: EinGraph) -> str:
    """Stable content hash of a whole EinGraph (see CanonicalGraph.key)."""
    return canonicalize(g).key


def subgraph_key(g: EinGraph, nids) -> str:
    """Stable content hash of the subgraph induced by ``nids`` — the
    pipeline tier's stage identity (repro_torch.pipeline).

    In-subgraph producer references are encoded as local positions (in id
    order, which is topo order for this IR); references to producers
    outside the subgraph collapse to ("ext", shape, dtype) placeholders —
    exactly the information stage extraction turns into input stubs.  Two
    node sets that extract to isomorphic stage graphs (repeated
    transformer layers, whatever their global ids) therefore share a key,
    which is what lets per-stage plans resolve warm through the plan
    cache and lets diagnostics report stage dedup honestly.
    """
    order = sorted(int(n) for n in nids)
    pos = {nid: i for i, nid in enumerate(order)}
    sig = []
    for nid in order:
        node = g.nodes[nid]
        refs = tuple(
            ("in", pos[a]) if a in pos
            else ("ext", tuple(g.nodes[a].shape), _dtype_str(g.nodes[a].dtype))
            for a in (node.inputs[i] for i in operand_order(node)))
        sig.append(node_struct(g, nid) + (refs,))
    return hashlib.sha256(repr(tuple(sig)).encode()).hexdigest()


def plan_key(
    g: EinGraph,
    p: int,
    *,
    mesh_axes: dict[str, int] | None = None,
    cost_mode: str = "paper",
    offpath_repart: bool = False,
    algo: str = "eindecomp",
) -> str:
    """The full plan-cache key: canonical graph x every planner input that
    changes the resulting plan (device count, mesh shape + axis names, cost
    model mode, the EinDecomp+ off-path refinement flag, and which planner
    produced it)."""
    mesh_sig = (tuple(sorted(mesh_axes.items()))
                if mesh_axes is not None else None)
    raw = repr((graph_key(g), int(p), mesh_sig, cost_mode,
                bool(offpath_repart), algo))
    return hashlib.sha256(raw.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Canonical EinSpec hashing (spec-level retrieval, no graph required)
# ---------------------------------------------------------------------------


def canonical_spec(
    spec: EinSpec, bounds: dict[str, int] | None = None
) -> tuple[EinSpec, dict[str, str]]:
    """Canonically rename one standalone EinSpec.

    Returns the renamed spec plus the {original -> canonical} label map.
    Commutative binary specs get their operands sorted by structural
    pattern (with per-label bounds as tie-break when given), so e.g.
    ``ij,jk->ik`` and ``jk,ij->ik`` with combine "mul" canonicalize to the
    same spec.
    """
    order = tuple(range(len(spec.in_labels)))
    if len(spec.in_labels) == 2 and spec.combine in COMMUTATIVE_COMBINES:
        pats = _operand_patterns(spec)
        bsig = [tuple((bounds or {}).get(l, 0) for l in ls)
                for ls in spec.in_labels]
        order = tuple(sorted(range(2), key=lambda i: (pats[i], bsig[i], i)))
    ren: dict[str, str] = {}
    for slot in order:
        for l in spec.in_labels[slot]:
            ren.setdefault(l, f"c{len(ren)}")
    for l in spec.out_labels:
        ren.setdefault(l, f"c{len(ren)}")
    new = EinSpec(
        tuple(tuple(ren[l] for l in spec.in_labels[slot]) for slot in order),
        tuple(ren[l] for l in spec.out_labels),
        spec.combine, spec.agg)
    return new, ren


def spec_key(spec: EinSpec, bounds: dict[str, int] | None = None) -> str:
    """Stable content hash of one EinSpec (plus its bound signature when
    bounds are given) — invariant under label renaming and commutative
    operand swap."""
    cspec, ren = canonical_spec(spec, bounds)
    bsig = (tuple(sorted((ren[l], b) for l, b in bounds.items() if l in ren))
            if bounds else None)
    raw = repr((cspec.in_labels, cspec.out_labels, cspec.combine, cspec.agg,
                bsig))
    return hashlib.sha256(raw.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Plan label translation (canonical <-> caller labels)
# ---------------------------------------------------------------------------


def _translate(plan: Plan, maps: dict[int, dict[str, str]]) -> Plan:
    out = Plan(p=plan.p, mode=plan.mode, cost=plan.cost)
    out.d_by_node = {
        nid: {maps[nid].get(l, l): v for l, v in d.items()}
        for nid, d in plan.d_by_node.items()}
    out.axes_by_node = {
        nid: {maps[nid].get(l, l): tuple(a) for l, a in ax.items()}
        for nid, ax in plan.axes_by_node.items()}
    return out


def plan_to_canonical(g: EinGraph, plan: Plan) -> Plan:
    """Rewrite a plan for ``g`` into canonical labels (the storage form)."""
    return _translate(plan, canonicalize(g).label_maps)


def plan_from_canonical(g: EinGraph, plan: Plan) -> Plan:
    """Rewrite a canonically-labeled plan back into ``g``'s own labels —
    valid for any graph with the same canonical key as the one the plan was
    stored under."""
    cg = canonicalize(g)
    return _translate(plan, {nid: cg.inverse_map(nid) for nid in cg.label_maps})


# ---------------------------------------------------------------------------
# Test / benchmark helper: structurally-identical relabeled copies
# ---------------------------------------------------------------------------


def relabel_graph(
    g: EinGraph, fn: Callable[[int, str], str] | None = None
) -> EinGraph:
    """A structurally identical copy of ``g`` with every node's labels
    renamed through ``fn(nid, label)`` (default: suffix with the node id).

    Because labels are node-local, any per-node injective rename yields a
    semantically identical graph; the copy must therefore hash to the same
    canonical key — the invariant tests/test_plancache.py pins down.
    """
    fn = fn or (lambda nid, l: f"{l}_r{nid}")
    out = EinGraph(g.name)
    for n in g.nodes:
        universe = set(n.labels)
        if n.spec is not None:
            for ls in n.spec.in_labels:
                universe.update(ls)
        for ls in n.in_labels:
            universe.update(ls)
        universe.update(n.shardable or ())
        ren = {l: fn(n.nid, l) for l in universe}
        if len(set(ren.values())) != len(ren):
            raise ValueError("relabel fn must be injective per node")
        spec = None
        if n.spec is not None:
            spec = EinSpec(
                tuple(tuple(ren[l] for l in ls) for ls in n.spec.in_labels),
                tuple(ren[l] for l in n.spec.out_labels),
                n.spec.combine, n.spec.agg)
        params = dict(n.params)
        if "comm" in params:
            params["comm"] = [dict(e, label=ren[e["label"]])
                              for e in params["comm"]]
        out.nodes.append(dataclasses.replace(
            n,
            labels=tuple(ren[l] for l in n.labels),
            spec=spec,
            params=params,
            shardable=(frozenset(ren[l] for l in n.shardable)
                       if n.shardable is not None else None),
            in_labels=tuple(tuple(ren[l] for l in ls) for ls in n.in_labels),
        ))
    return out

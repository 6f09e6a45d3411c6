"""Plan pass (RA1xx): does this Plan actually fit this graph + mesh?

Re-derives, as findings instead of exceptions, everything the planner
assumes and the executor will later assert — partitioning divisibility,
mesh-axis bookkeeping, shard-rule/comm resolvability, and the §7 pricing
invariant ``plan.cost == plan_cost(g, plan)`` (a plan edited or
deserialized after pricing is stale and the cost-honesty contract of the
benches silently breaks).
"""
from __future__ import annotations

import math

from repro_torch.core import opaque_rules, opdef
from repro_torch.core.decomp import Plan, node_bounds, node_label_universe, plan_cost
from repro_torch.core.einsum import EinGraph

from repro_torch.analysis.findings import Finding

#: comm kinds the DP prices — mirror of opdef.COMM_KINDS
_COMM_KINDS = set(opdef.COMM_KINDS)


def _f(code: str, msg: str, n) -> Finding:
    return Finding(code, msg, nid=n.nid, node=n.name, srcloc=n.srcloc)


def analyze_plan(g: EinGraph, plan: Plan,
                 mesh_axes: dict[str, int] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    sizes = {a: int(s) for a, s in (mesh_axes or {}).items()}
    structurally_ok = True

    for n in g.nodes:
        d = plan.d_by_node.get(n.nid)
        if d is None:
            findings.append(_f(
                "RA101", "no partitioning entry in the plan", n))
            structurally_ok = False
            continue
        universe = node_label_universe(n)
        bounds = node_bounds(g, n.nid)

        # RA102: every partitioned label must divide its bound ------------
        for l, k in d.items():
            if l not in bounds:
                findings.append(_f(
                    "RA102", f"plan partitions label {l!r} which is not "
                             f"on the node (universe {universe})", n))
                structurally_ok = False
            elif k < 1 or bounds[l] % k:
                findings.append(_f(
                    "RA102", f"label {l!r}: {k} parts do not divide bound "
                             f"{bounds[l]}", n))
                structurally_ok = False

        # RA103: over-parallel (more shards than devices) -----------------
        total = math.prod(d.values()) if d else 1
        if total > plan.p:
            findings.append(_f(
                "RA103", f"product of parts {total} exceeds the plan's "
                         f"p={plan.p}", n))
            structurally_ok = False

        # RA108: sharding outside the declared shardable set --------------
        if n.kind == "opaque" and n.shardable is not None:
            for l, k in d.items():
                if k > 1 and l not in n.shardable:
                    findings.append(_f(
                        "RA108", f"label {l!r} is partitioned x{k} but is "
                                 "outside the node's shardable set "
                                 f"{sorted(n.shardable)}", n))

        # RA104: mesh-axis bookkeeping (mesh-mode plans only) -------------
        ax_n = plan.axes_by_node.get(n.nid, {})
        used: dict[str, str] = {}
        for l, axes in ax_n.items():
            for a in axes:
                if sizes and a not in sizes:
                    findings.append(_f(
                        "RA104", f"label {l!r} is sharded over unknown "
                                 f"mesh axis {a!r} (mesh has "
                                 f"{sorted(sizes)})", n))
                    structurally_ok = False
                prev = used.get(a)
                if prev is not None and prev != l:
                    findings.append(_f(
                        "RA104", f"mesh axis {a!r} shards both {prev!r} "
                                 f"and {l!r} on one node", n))
                    structurally_ok = False
                used[a] = l
            if sizes and all(a in sizes for a in axes):
                prod = math.prod(sizes[a] for a in axes) if axes else 1
                if prod != d.get(l, 1):
                    findings.append(_f(
                        "RA104", f"label {l!r}: mesh axes {tuple(axes)} "
                                 f"(x{prod}) disagree with d[{l!r}]="
                                 f"{d.get(l, 1)}", n))
                    structurally_ok = False
        # map nodes are exempt: the executor rides their input's layout
        # through untouched, so they legitimately carry parts but no axes.
        # input nodes too: they are pre-placed (§8.2) — an axis-less input
        # lands replicated and is repartitioned at its consumers, which is
        # always correct (and its placement cost is excluded anyway)
        if plan.mode == "mesh" and sizes and n.kind not in ("map", "input"):
            for l, k in d.items():
                if k > 1 and not ax_n.get(l):
                    findings.append(_f(
                        "RA104", f"label {l!r} is partitioned x{k} but "
                                 "carries no mesh axes — the executor "
                                 "would silently replicate it", n))
                    structurally_ok = False

        # RA105/RA106: opaque comm + shard-rule resolvability -------------
        if n.kind == "opaque":
            try:
                entries = opdef.comm_for_node(n)
            except Exception as e:  # malformed template renaming
                findings.append(_f("RA106", f"comm template does not "
                                            f"rename onto the node: {e}", n))
                entries = []
            for entry in entries:
                kind = entry.get("kind")
                if kind not in _COMM_KINDS:
                    findings.append(_f(
                        "RA105", f"comm kind {kind!r} unknown (priced "
                                 f"kinds: {sorted(_COMM_KINDS)})", n))
                label = entry.get("label")
                if label is not None and label not in universe:
                    findings.append(_f(
                        "RA106", f"comm entry names label {label!r}, not "
                                 f"on the node (universe {universe})", n))
                idx = entry.get("input", 0)
                if not (-1 <= int(idx) < len(n.inputs)):
                    findings.append(_f(
                        "RA106", f"comm entry input index {idx} out of "
                                 f"range for {len(n.inputs)} inputs "
                                 "(-1 = output)", n))
            try:
                rule_name = opaque_rules.resolve_rule_name(n)
            except ValueError as e:
                findings.append(_f("RA105", str(e), n))
            else:
                try:
                    opaque_rules.get_rule(rule_name)
                except KeyError:
                    findings.append(_f(
                        "RA105", f"shard rule {rule_name!r} is not "
                                 "registered "
                                 "(core.opaque_rules.register_rule)", n))

    # RA107: §7 pricing invariant — only meaningful on structurally sound
    # plans (a broken plan would crash or garbage the repricing)
    if structurally_ok and plan.cost:
        fresh = plan_cost(g, plan)
        if int(plan.cost) != int(fresh):
            findings.append(Finding(
                "RA107", f"plan.cost={plan.cost:,} but plan_cost(g, plan) "
                         f"reprices to {fresh:,} — the plan changed after "
                         "pricing"))
    return findings

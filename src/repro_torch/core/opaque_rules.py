"""Shard rules for opaque nodes: the registry the planner validates against.

An ``OpaqueShardRule`` turns (node, plan assignment, mesh sizes) into the
per-device program of a fused op (flash attention, MoE dispatch/combine,
recurrent scans).  The cost DP prices their internal movement through the
``comm`` declarations on the node's OpDef (``core/decomp._opaque_comm_cost``)
and ``validate_graph`` runs at plan time, so a plan never prices a schedule
no registered rule can lower.

This module holds the registry half of the reference's rules: the
``RuleLowering`` record, the ``OpaqueShardRule`` protocol, ``RULES`` /
``register_rule`` / ``resolve_rule_name`` / ``validate_graph``, and the five
built-in rule names (``replicate``, ``local``, ``ring``, ``a2a``,
``paged``).  Every rule's ``lower`` — the per-device program on
``torch.distributed`` — belongs to the explicit-collective executor slice of
the port (core/spmd.py) and raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core.einsum import EinGraph, Node

#: per-dim tuple of mesh-axis tuples (the executor's layout description)
Layout = tuple

_KIND_TO_RULE = {"ring": "ring", "a2a": "a2a"}


# ---------------------------------------------------------------------------
# Protocol + lowering result
# ---------------------------------------------------------------------------


@dataclass
class RuleLowering:
    """What a rule contributes to the static schedule for one opaque node:
    the layouts the executor repartitions each input into (``arg_layouts``),
    the output layout after ``post_steps``, the rule's internal collectives
    pre-priced as ``(kind, axes, elems, nbytes)`` events, and ``run(args)``,
    the node's local program."""

    arg_layouts: list[Layout]
    out_layout: Layout
    run: Callable[[Sequence[Any]], Any]
    post_steps: list[tuple] = field(default_factory=list)
    events: list[tuple] = field(default_factory=list)


@runtime_checkable
class OpaqueShardRule(Protocol):
    """Given a node, its plan assignment and the mesh, emit the per-device
    program.  ``lower`` returns ``None`` when the rule's structural
    preconditions do not hold — the executor then falls back to
    ``replicate``."""

    name: str

    def lower(self, g: EinGraph, node: Node,
              ax_n: dict[str, tuple[str, ...]],
              sizes: dict[str, int]) -> RuleLowering | None: ...


# ---------------------------------------------------------------------------
# Registry + resolution
# ---------------------------------------------------------------------------

RULES: dict[str, OpaqueShardRule] = {}


def register_rule(rule: OpaqueShardRule) -> None:
    RULES[rule.name] = rule


def get_rule(name: str) -> OpaqueShardRule:
    return RULES[name]


def resolve_rule_name(node: Node) -> str:
    """Rule name declared for a node: its comm entries (explicit ``rule``
    key, else derived from ``kind``), falling back to the OpDef's bound
    ``shard_rule``; ``replicate`` when nothing is declared.  The comm
    declaration itself resolves through the OpDef
    (``opdef.comm_for_node``); explicit node params still override."""
    from repro_torch.core import opdef

    names = set()
    for entry in opdef.comm_for_node(node):
        name = entry.get("rule") or _KIND_TO_RULE.get(entry.get("kind"))
        if name is not None:
            names.add(name)
    if not names:
        return opdef.shard_rule_for_node(node) or "replicate"
    if len(names) > 1:
        raise ValueError(
            f"node {node.name!r}: comm entries declare conflicting shard "
            f"rules {sorted(names)} — one rule lowers the whole node")
    return names.pop()


def validate_graph(g: EinGraph) -> None:
    """Plan-time validation: every opaque node's declaration (OpDef comm
    template or per-node override) must resolve to a registered rule with
    known kinds, so the DP never prices a schedule the executor cannot
    lower."""
    from repro_torch.core import opdef

    for n in g.nodes:
        if n.kind != "opaque":
            continue
        for entry in opdef.comm_for_node(n):
            if entry.get("kind") not in _KIND_TO_RULE:
                raise ValueError(
                    f"node {n.name!r}: comm kind {entry.get('kind')!r} "
                    f"unknown (expected one of {sorted(_KIND_TO_RULE)})")
        name = resolve_rule_name(n)
        if name not in RULES:
            raise ValueError(
                f"node {n.name!r}: comm declares shard rule {name!r}, but "
                f"only {sorted(RULES)} are registered "
                "(core.opaque_rules.register_rule)")


# ---------------------------------------------------------------------------
# The built-in rules (names only until the executor slice)
# ---------------------------------------------------------------------------


class _UnportedRule:
    """A built-in rule whose per-device lowering is not ported yet."""

    def __init__(self, name: str, doc: str):
        self.name = name
        self.__doc__ = doc

    def lower(self, g, node, ax_n, sizes):
        raise NotImplementedError(
            f"shard rule {self.name!r}: lowering belongs to the "
            "explicit-collective executor slice of the port (core/spmd.py "
            "on torch.distributed), which is not ported yet")

    def __repr__(self):
        return f"<shard rule {self.name!r} (lowering not ported)>"


for _name, _doc in (
        ("replicate", "gather every input, run the fused op densely on all "
                      "devices, re-slice the output to the plan layout"),
        ("local", "channel-parallel fused ops: run the op on local blocks "
                  "with zero collectives (the recurrent scans)"),
        ("ring", "sequence-parallel flash attention: K/V circulate the "
                 "ring, (m, l, acc) carried across steps"),
        ("a2a", "expert-parallel MoE dispatch/combine over a real "
                "all-to-all of token payloads"),
        ("paged", "the serving tier's block-table KV gather, zero "
                  "collectives")):
    register_rule(_UnportedRule(_name, _doc))

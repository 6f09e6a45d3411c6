"""Finding/Report data model + the RA error-code index.

Ruff-style codes, one namespace per pass:

  RA0xx  graph     (labels, bounds, dtypes, OpDef conformance)
  RA1xx  plan      (divisibility, mesh axes, shard rules, §7 cost)
  RA2xx  schedule  (ppermute bijectivity, donation aliasing, chains)
  RA3xx  memory    (per-device peak live bytes vs --max-hbm)
  RA4xx  pipeline  (stage chain, handoff ordering, per-stage memory)

Every finding carries the node id/name and — for frontend-traced graphs —
the ``file.py:line`` that built the node (``Node.srcloc``), so reports are
clickable back to the model source.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable

ERROR = "error"
WARNING = "warning"

#: code -> (default severity, one-line description) — the `--list-codes`
#: table and the docs' error-code index are generated from this.
CODES: dict[str, tuple[str, str]] = {
    # graph pass ----------------------------------------------------------
    "RA001": (WARNING, "dead node: not reachable from any requested output"),
    "RA002": (ERROR, "label/rank arity mismatch between a node and its "
                     "labels or an edge's labels"),
    "RA003": (ERROR, "label bound mismatch across edges (same label, "
                     "different sizes)"),
    "RA004": (ERROR, "opaque node contradicts its registered OpDef "
                     "signature (bind_call fails or infers another shape)"),
    "RA005": (ERROR, "unregistered map/opaque kind: execution has no impl "
                     "to dispatch"),
    "RA006": (WARNING, "dtype drift: einsum combines floats of different "
                       "widths (result silently takes the first input's)"),
    "RA007": (ERROR, "duplicate input name: feeds are name-keyed and "
                     "would be ambiguous"),
    "RA008": (ERROR, "spec arity mismatch: node input count differs from "
                     "its spec/in_labels"),
    # plan pass -----------------------------------------------------------
    "RA101": (ERROR, "node missing from the plan (no partitioning entry)"),
    "RA102": (ERROR, "partitioning does not divide the label bound"),
    "RA103": (ERROR, "over-parallel: product of parts exceeds the plan's "
                     "device count p"),
    "RA104": (ERROR, "mesh-axis inconsistency: unknown axis, axis-size "
                     "product != parts, or one axis on two labels"),
    "RA105": (ERROR, "unresolvable shard rule or unknown comm kind on an "
                     "opaque node's OpDef"),
    "RA106": (ERROR, "comm template inconsistent with the node (label not "
                     "on the node, input index out of range)"),
    "RA107": (ERROR, "stale plan cost: plan.cost != plan_cost(g, plan) — "
                     "the plan was edited after pricing"),
    "RA108": (ERROR, "non-shardable label is partitioned (outside the "
                     "opaque node's declared shardable set)"),
    # schedule pass -------------------------------------------------------
    "RA201": (ERROR, "non-bijective ppermute: deadlock (missing source) "
                     "or data loss (duplicate destination)"),
    "RA202": (ERROR, "donated buffer read after its aliasing step (or "
                     "returned as a program output)"),
    "RA203": (ERROR, "repartition chain breaks shape evolution (a step "
                     "does not divide / lowering failed)"),
    "RA204": (ERROR, "overlap hazard: overlapped collective outside any "
                     "rule's compute loop, or an over-rotated ring"),
    "RA205": (ERROR, "opaque node's traced wire elems exceed its "
                     "_opaque_comm_cost planner bound"),
    "RA206": (ERROR, "program's traced wire elems exceed the §7 "
                     "plan_cost the DP optimized"),
    "RA207": (WARNING, "dead donation: donated input is never read"),
    "RA208": (ERROR, "prefetch hazard: hoisted issue precedes a producer's "
                     "compute, aliases another prefetch's buffer, or is "
                     "unrecorded in the schedule's lifetimes"),
    # memory pass ---------------------------------------------------------
    "RA301": (ERROR, "peak per-device live bytes exceed --max-hbm"),
    "RA302": (ERROR, "a single buffer alone exceeds --max-hbm"),
    # pipeline pass -------------------------------------------------------
    "RA401": (ERROR, "stage-graph back-edge: a stage receives a tensor "
                     "produced by the same or a later stage (not a chain)"),
    "RA402": (ERROR, "premature handoff: a cell's ppermute fires before "
                     "the producing (stage, microbatch) cell completes"),
    "RA403": (ERROR, "a single stage's peak live bytes exceed --max-hbm"),
    "RA404": (WARNING, "stage compute imbalance beyond the partitioner's "
                       "balance cap (bubble fraction understated)"),
    "RA405": (ERROR, "a stage schedule's traced wire exceeds the sound "
                     "per-stage §7 price (per-stage analogue of RA206)"),
}


@dataclass(frozen=True)
class Finding:
    """One diagnostic: code + where + why."""

    code: str
    message: str
    severity: str = ""        # "" = the code's default severity
    nid: int | None = None
    node: str = ""            # node name, when node-scoped
    srcloc: str = ""          # "file.py:line" from the frontend trace

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown finding code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])

    def format(self) -> str:
        where = self.srcloc or (f"node {self.nid}" if self.nid is not None
                                else "")
        name = f" ({self.node})" if self.node else ""
        loc = f"{where}{name}: " if (where or name) else ""
        return f"{loc}{self.code} [{self.severity}] {self.message}"

    def to_json(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "nid": self.nid,
                "node": self.node, "srcloc": self.srcloc}


@dataclass
class Report:
    """All findings for one analyzed cell (graph [+ plan [+ schedule +
    memory]]), plus the memory pass's per-device accounting."""

    findings: list[Finding] = field(default_factory=list)
    meta: dict = field(default_factory=dict)      # family/mode/mesh/...
    memory: dict = field(default_factory=dict)    # memory_pass report

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def has_errors(self) -> bool:
        return bool(self.errors)

    def codes(self) -> set[str]:
        return {f.code for f in self.findings}

    def format(self) -> str:
        head = " ".join(f"{k}={v}" for k, v in self.meta.items())
        lines = [head] if head else []
        lines += [f.format() for f in self.findings]
        lines.append(f"{len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"meta": self.meta,
                "findings": [f.to_json() for f in self.findings],
                "memory": self.memory,
                "n_errors": len(self.errors),
                "n_warnings": len(self.warnings)}

    def dump_json(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)

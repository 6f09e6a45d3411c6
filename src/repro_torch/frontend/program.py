"""`Program`: one object owning the graph → plan → cache lifecycle.

The paper's workflow is declare → decompose → execute:

    x = ein.tensor("x", "b a", (8, 64))
    w = ein.tensor("w", "a f", (64, 128))
    y = ein.einsum("b a, a f -> b f", x, w)
    prog = ein.Program({"y": y})
    compiled = prog.compile(mesh_axes={"data": 2, "model": 4},
                            cache="plans.json")   # eindecomp + plan cache

``compile`` runs EinDecomp through the persistent plan cache (a hit skips
the §8 DP), exactly as the reference does.  ``.plan`` exposes the
decomposition, ``.lower()`` the per-node partitionings and mesh-axis
assignments, ``.policy()`` the production ShardingPolicy projection and
``.canonical_key`` the compiled handle's identity.

Executing a compiled program needs the dense executor (core/engine.py),
which is the next slice of the port; until then calling a
``CompiledProgram`` raises ``NotImplementedError``.  The model stack
(models/transformer.py) runs the model itself and takes only the plan's
policy from here, as the reference's serving path does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from repro_torch.core.einsum import EinGraph
from repro_torch.frontend.expr import Expr, trace

#: plan realizations the port supports so far (the reference also has
#: "shard_map", which arrives with core/spmd.py)
EXECUTORS = ("gspmd",)


class Program:
    """A declared computation with named inputs and named outputs.

    Construct from expressions — ``Program(z)``, ``Program([z1, z2])`` or
    ``Program({"logits": z})``.  Tracing happens once, eagerly; ``.graph``
    is the underlying ``EinGraph``.
    """

    def __init__(self, outputs, *, name: str = "program"):
        named = _normalize_outputs(outputs)
        self.name = name
        self.graph, ids = trace(list(named.values()), name)
        self._out: dict[str, int] = {k: ids[e] for k, e in named.items()}

    # -- introspection --------------------------------------------------------

    @property
    def input_names(self) -> tuple[str, ...]:
        return tuple(n.name for n in self.graph.nodes if n.kind == "input")

    @property
    def output_names(self) -> tuple[str, ...]:
        return tuple(self._out)

    def __repr__(self):
        ins = ", ".join(self.input_names)
        outs = ", ".join(self._out)
        return (f"Program({self.name!r}, {len(self.graph.nodes)} nodes, "
                f"inputs=[{ins}], outputs=[{outs}])")

    # -- compile --------------------------------------------------------------

    def compile(self, *, mesh_axes: dict[str, int] | None = None,
                p: int | None = None, cost_model: str = "paper",
                cache=None, offpath_repart: bool = True,
                executor: str = "gspmd", plan=None) -> "CompiledProgram":
        """Run EinDecomp (through the plan cache).

        ``mesh_axes`` (``{axis: size}``) selects torus-conformable mesh
        mode; a bare ``p`` selects the paper's power-of-two mode; neither
        means no planning at all.  ``cache`` is a ``PlanCache`` or a path to
        its JSON store; a hit skips the §8 DP entirely.  ``cost_model`` is
        ``"paper"``, ``"collective"`` or a ``core.cost.CostModel``.
        ``plan=`` short-circuits planning with a caller-supplied plan.
        """
        from repro_torch.core.decomp import eindecomp
        from repro_torch.core.plancache import PlanCache

        if executor not in EXECUTORS:
            raise NotImplementedError(
                f"compile: executor {executor!r} is not ported yet (the "
                "explicit-collective executor arrives with core/spmd.py); "
                f"choose from {EXECUTORS}")
        cache = PlanCache.coerce(cache)
        if plan is not None:
            pass  # caller-supplied plan
        elif mesh_axes is not None or p is not None:
            if p is None:
                p = math.prod(mesh_axes.values())
            plan = eindecomp(self.graph, p, mesh_axes=mesh_axes,
                             cost_mode=cost_model,
                             offpath_repart=offpath_repart, cache=cache)
        elif cache is not None:
            raise ValueError("compile: cache given but nothing to plan "
                             "with — pass mesh_axes or p")
        return CompiledProgram(self, plan=plan, executor=executor)


class CompiledProgram:
    """A planned Program.

    ``.plan`` is the EinDecomp result (None if compiled without planning
    inputs), ``.lower()`` the introspection surface, ``.policy()`` the
    production ShardingPolicy and ``.canonical_key`` the handle's identity.
    Calling it needs the dense executor, which is not ported yet.
    """

    def __init__(self, program: Program, *, plan=None,
                 executor: str = "gspmd"):
        self.program = program
        self.plan = plan
        self.executor = executor

    @property
    def graph(self) -> EinGraph:
        return self.program.graph

    @property
    def canonical_key(self) -> str:
        """Stable identity of this compiled handle: the canonical graph key
        (same string the plan cache is keyed on — structurally identical
        programs collide by design) plus the planning signature."""
        from repro_torch.core import canon

        gk = canon.graph_key(self.graph)
        if self.plan is None:
            return f"{gk}:unplanned:{self.executor}"
        return f"{gk}:p{self.plan.p}:{self.plan.mode}:{self.executor}"

    def __call__(self, feeds: Mapping[str, Any] | None = None, /, **kw):
        raise NotImplementedError(
            "CompiledProgram execution needs the dense executor "
            "(core/engine.py), which is the next slice of the port; the "
            "model stack runs models directly (models/transformer.py)")

    def policy(self, *, fsdp_axes: Sequence[str] = (), remat: bool = True):
        """Collapse the mesh-mode plan to the production ``ShardingPolicy``
        (models/policy.py)."""
        from repro_torch.models.policy import policy_from_plan

        if self.plan is None:
            raise ValueError("policy(): program was compiled without "
                             "planning inputs (no plan)")
        return policy_from_plan(self.plan, self.graph,
                                fsdp_axes=tuple(fsdp_axes), remat=remat)

    def lower(self) -> "LoweredProgram":
        """Introspection: the traced graph, the plan, and (in mesh mode)
        each node's per-dim mesh-axis assignment — the plain-tuple form of
        the reference's PartitionSpecs (``None`` = unsharded, an axis name,
        or a tuple of axis names)."""
        shardings = None
        if self.plan is not None and self.plan.axes_by_node:
            shardings = {
                n.nid: spec_for_node(n, self.plan.axes_by_node.get(n.nid, {}))
                for n in self.graph.nodes}
        return LoweredProgram(graph=self.graph, plan=self.plan,
                              shardings=shardings,
                              outputs=dict(self.program._out))


def spec_for_node(node, axes_by_label: dict[str, tuple[str, ...]]) -> tuple:
    """Per-dim mesh axes of a node's output from its label->axes map."""
    entries = []
    for l in node.labels:
        ax = tuple(axes_by_label.get(l, ()))
        entries.append(None if not ax else ax[0] if len(ax) == 1 else ax)
    return tuple(entries)


@dataclass
class LoweredProgram:
    """What ``CompiledProgram.lower()`` returns: everything between the
    declaration and the executable, in one inspectable object."""

    graph: EinGraph
    plan: Any
    shardings: dict[int, tuple] | None
    outputs: dict[str, int]

    def as_text(self) -> str:
        lines = [repr(self.graph)]
        if self.plan is not None:
            lines.append(f"plan: p={self.plan.p} mode={self.plan.mode} "
                         f"cost={self.plan.cost:,} floats")
            for nid in sorted(self.plan.d_by_node):
                n = self.graph.nodes[nid]
                d = self.plan.d_by_node[nid]
                extra = ""
                if self.shardings is not None and nid in self.shardings:
                    extra = f"  {self.shardings[nid]}"
                lines.append(f"  [{nid:3d}] {n.name:20s} d={d}{extra}")
        outs = ", ".join(f"{k}=[{v}]" for k, v in self.outputs.items())
        lines.append(f"outputs: {outs}")
        return "\n".join(lines)

    def __repr__(self):
        return self.as_text()


def _normalize_outputs(outputs) -> dict[str, Expr]:
    if isinstance(outputs, Expr):
        outputs = [outputs]
    if isinstance(outputs, Mapping):
        named = {str(k): v for k, v in outputs.items()}
    else:
        named = {}
        for i, e in enumerate(outputs):
            if not isinstance(e, Expr):
                raise TypeError(f"Program: output {i} is {type(e).__name__}, "
                                "expected Expr")
            key = e.name or f"out{i}"
            if key in named:
                raise ValueError(f"Program: duplicate output name {key!r} — "
                                 "pass a dict to name outputs explicitly")
            named[key] = e
    if not named:
        raise ValueError("Program: no outputs")
    for k, e in named.items():
        if not isinstance(e, Expr):
            raise TypeError(f"Program: output {k!r} is {type(e).__name__}, "
                            "expected Expr")
    return named

"""`Program`: one object owning the graph → plan → cache → runner lifecycle.

The paper's workflow is declare → decompose → execute:

    x = ein.tensor("x", "b a", (8, 64))
    w = ein.tensor("w", "a f", (64, 128))
    y = ein.einsum("b a, a f -> b f", x, w)
    prog = ein.Program({"y": y})
    run = prog.compile(p=8, cache="plans.json")     # eindecomp + plan cache
    out = run({"x": X, "w": W})["y"]                # name-keyed I/O

``compile`` runs EinDecomp through the persistent plan cache (a hit skips
the §8 DP), exactly as the reference does, and builds the runner: the
dense run on one device (``executor="gspmd"``), or the plan's TRA dataflow
with explicit ``torch.distributed`` collectives over a ``launch.mesh.Mesh``
(``executor="shard_map"``).  The result takes and returns name-keyed
dicts.  ``.plan`` exposes the decomposition, ``.lower()`` the per-node
partitionings and mesh-axis assignments, ``.policy()`` the production
ShardingPolicy projection, ``.collectives`` the shard_map executor's static
collective schedule and ``.canonical_key`` the compiled handle's identity.
``Program.grad(wrt=...)`` derives the training program via
``core/autodiff`` — still a plain Program, so the same DP plans forward and
backward jointly (the paper's Experiment 2).

Runners run on the card unless the caller asks for another device
(``device="cpu"``, or a mesh on the CPU); with no card and no device asked
for, calling a compiled program raises.  The runner is eager: there is no
jit, and no buffer donation — a value's memory goes back to the allocator
when its last reference goes, and the runner drops every intermediate
after its last reader.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.einsum import EinGraph
from repro_torch.frontend.expr import Expr, trace


class Program:
    """A declared computation with named inputs and named outputs.

    Construct from expressions — ``Program(z)``, ``Program([z1, z2])`` or
    ``Program({"logits": z})`` — or from an already-traced graph with
    ``Program.from_graph``.  Tracing happens once, eagerly; ``.graph`` is
    the underlying ``EinGraph``.
    """

    def __init__(self, outputs, *, name: str = "program"):
        named = _normalize_outputs(outputs)
        self.name = name
        self.graph, ids = trace(list(named.values()), name)
        self._out: dict[str, int] = {k: ids[e] for k, e in named.items()}
        self._default_ones: frozenset[str] = frozenset()

    @classmethod
    def from_graph(cls, g: EinGraph, outputs: Mapping[str, int], *,
                   default_ones: Sequence[str] = (),
                   name: str | None = None) -> "Program":
        """Wrap an existing EinGraph (node-id outputs) as a Program.

        ``default_ones`` names inputs that default to ``ones`` when unfed —
        used for gradient seeds, so a grad program is callable with just the
        forward feeds.
        """
        self = cls.__new__(cls)
        self.name = name if name is not None else g.name
        self.graph = g
        self._out = {str(k): int(v) for k, v in outputs.items()}
        self._default_ones = frozenset(default_ones)
        names = [n.name for n in g.nodes if n.kind == "input"]
        dups = sorted({x for x in names if names.count(x) > 1})
        if dups:
            raise ValueError(f"from_graph: duplicate input names {dups} — "
                             "Program I/O is name-keyed")
        for k, v in self._out.items():
            if not 0 <= v < len(g.nodes):
                raise ValueError(f"from_graph: output {k!r} -> bad node id {v}")
        return self

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

    # -- autodiff -------------------------------------------------------------

    def grad(self, wrt: str | Sequence[str], *,
             output: str | None = None) -> "Program":
        """The training program: outputs the differentiated value plus
        ``grad_<name>`` for every input in ``wrt`` (core/autodiff reverse
        mode — the backward pass is EinSum nodes in the same graph, so one
        EinDecomp run plans fwd+bwd jointly).

        The gradient seed is an input named ``dLoss_seed`` that defaults to
        ones; feed it explicitly to chain an incoming cotangent.
        """
        from repro_torch.core.autodiff import grad_graph

        if output is None:
            if len(self._out) != 1:
                raise ValueError(
                    f"grad: program has outputs {list(self._out)}; pass "
                    "output=<name> to pick the one to differentiate")
            output = next(iter(self._out))
        wrt_names = [wrt] if isinstance(wrt, str) else list(wrt)
        by_name = {n.name: n.nid for n in self.graph.nodes if n.kind == "input"}
        unknown = [w for w in wrt_names if w not in by_name]
        if unknown:
            raise KeyError(f"grad: unknown inputs {unknown}; "
                           f"inputs are {sorted(by_name)}")
        gg, grads, seed = grad_graph(self.graph, self._out[output],
                                     [by_name[w] for w in wrt_names])
        outs = {output: self._out[output]}
        outs.update({f"grad_{w}": grads[by_name[w]] for w in wrt_names})
        return Program.from_graph(
            gg, outs, default_ones=(gg.nodes[seed].name,),
            name=f"{self.name}:grad")

    # -- compile --------------------------------------------------------------

    def compile(self, *, mesh=None, mesh_axes: dict[str, int] | None = None,
                p: int | None = None, cost_model: str = "paper",
                cache=None, offpath_repart: bool = True,
                executor: str = "gspmd", fuse: bool = True,
                lookahead: int = 1, donate: bool | Sequence[str] = False,
                pipeline=None, plan=None, device=None) -> "CompiledProgram":
        """Run EinDecomp (through the plan cache) and build the runner.

        ``mesh`` (a ``launch.mesh.Mesh``) or ``mesh_axes`` (``{axis:
        size}``) selects torus-conformable mesh mode; a bare ``p`` selects
        the paper's power-of-two mode; neither means no planning at all.
        ``cache`` is a ``PlanCache`` or a path to its JSON store; a hit
        skips the §8 DP entirely.  ``cost_model`` is ``"paper"``,
        ``"collective"`` or a ``core.cost.CostModel``.  ``plan=``
        short-circuits planning with a caller-supplied plan.

        ``executor`` picks how the plan is realized
        (``engine.EXECUTORS``): ``"gspmd"`` runs densely on one device
        (``device``, or the card); ``"shard_map"`` runs the plan's
        join→agg→repartition dataflow with explicit collectives between
        the ranks of ``mesh`` (required), on ``mesh.device``, and exposes
        its static schedule as ``.collectives``.  ``fuse`` and
        ``lookahead`` (shard_map only) are the fused repartition planner
        and the graph-wide overlap window, as in the reference: outputs
        are bit-identical across both knobs.

        ``pipeline=PipelineSpec(stages=p, microbatches=m)`` compiles the
        pipelined realization (``repro_torch.pipeline``): the graph is cut
        into ``p`` stage subgraphs, each planned by the same §8 DP against
        the intra-stage submesh (warm through ``cache``), and run as the
        GPipe cell schedule by every rank of ``mesh``, with ppermute
        handoffs over the ``spec.axis`` (default ``"pp"``) mesh axis — the
        mesh must carry that axis at size ``stages``.  Outputs are
        bit-identical to the unpipelined compile of the stitched plan;
        ``.plan`` is that stitched full-graph plan and
        ``.pipeline_schedule`` the static schedule (cells, per-stage
        traces, bubble fraction).  Requires ``executor='shard_map'``;
        donation is not supported.

        ``plan=`` short-circuits planning with a caller-supplied mesh-mode
        plan (e.g. the pipeline tier's stitched plan, to compile the exact
        bit-identity baseline) — mutually exclusive with ``pipeline=``.

        Not ported yet, and raising ``NotImplementedError``: ``gspmd`` on a
        mesh of more than one rank (DTensor placements per node, ROADMAP
        Queue 1 item 4) and ``donate=`` (buffer donation: PyTorch has no
        jit to donate to; the eager runner already frees each value after
        its last reader).
        """
        from repro_torch.core.decomp import eindecomp
        from repro_torch.core.engine import EXECUTORS, mesh_axes_dict
        from repro_torch.core.plancache import PlanCache

        if executor not in EXECUTORS:
            raise ValueError(f"compile: unknown executor {executor!r}; "
                             f"choose from {EXECUTORS}")
        cache = PlanCache.coerce(cache)
        if mesh is not None and mesh_axes is None:
            mesh_axes = mesh_axes_dict(mesh)
        if executor == "shard_map" and mesh is None:
            raise ValueError("compile: executor='shard_map' needs a mesh "
                             "(launch.mesh.Mesh; mesh_axes alone cannot "
                             "place shards)")
        if pipeline is not None:
            if plan is not None:
                raise ValueError("compile: pipeline= builds its own "
                                 "stitched plan — plan= is mutually "
                                 "exclusive with it")
            if executor != "shard_map" or mesh is None:
                raise ValueError("compile: pipeline= needs "
                                 "executor='shard_map' and a mesh "
                                 "carrying the pipeline axis")
            if donate:
                raise ValueError("compile: donate is not supported with "
                                 "pipeline= — microbatch chunks alias the "
                                 "fed batch buffers")
            from repro_torch.pipeline import build_pipeline_schedule

            psched = build_pipeline_schedule(
                self.graph, pipeline, mesh_axes,
                [self._out[k] for k in self._out],
                cache=cache, offpath_repart=offpath_repart,
                cost_mode=cost_model, fuse=fuse, lookahead=lookahead)
            return CompiledProgram(self, plan=psched.stitched, mesh=mesh,
                                   executor="shard_map", fuse=fuse,
                                   lookahead=lookahead,
                                   pipeline_schedule=psched)
        if donate:
            raise NotImplementedError(
                "compile: donate= is not ported — PyTorch has no jit "
                "donation; the eager runner frees each intermediate after "
                "its last reader, and donating the feeds themselves is a "
                "later slice")
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
                             "with — pass mesh, mesh_axes or p")
        return CompiledProgram(self, plan=plan, mesh=mesh, executor=executor,
                               fuse=fuse, lookahead=lookahead, device=device)


class CompiledProgram:
    """A planned Program, callable with name-keyed feeds.

    ``run({"x": X, ...})`` (or ``run(x=X, ...)``) returns ``{output name:
    tensor}``; feeds may be numpy arrays or tensors.  ``.plan`` is the
    EinDecomp result (None if compiled without planning inputs),
    ``.lower()`` the introspection surface, ``.policy()`` the production
    ShardingPolicy.  ``.executor`` names the execution strategy; for
    ``"shard_map"``, ``.collectives`` is the static ``CollectiveTrace`` the
    program executes (None under gspmd), ``.collectives_by_rule`` its
    per-shard-rule view, and ``.lookahead`` the overlap window.  A
    pipelined compile carries ``.pipeline_schedule`` (None otherwise), and
    its ``.collectives`` is that schedule's combined, (stage,
    microbatch)-tagged trace.  ``.donate_argnums`` is always ``()``: the
    port donates no feed.

    The device is resolved at the first call: ``mesh.device`` under
    shard_map, else ``device`` as compiled, else the card — raising where
    there is none.
    """

    def __init__(self, program: Program, *, plan=None, mesh=None,
                 executor: str = "gspmd", fuse: bool = True,
                 lookahead: int = 1, device=None, pipeline_schedule=None):
        self.program = program
        self.plan = plan
        self.mesh = mesh
        self.executor = executor
        self.fuse = fuse
        self.lookahead = int(lookahead)
        self.device = device
        self.collectives = None
        self.pipeline_schedule = pipeline_schedule
        self.donate_argnums: tuple[int, ...] = ()
        g = program.graph
        self._in_names = tuple(g.nodes[i].name for i in g.input_ids())
        self._out_names = tuple(program._out)
        self._out_ids = [program._out[k] for k in self._out_names]
        self._fn = None
        if pipeline_schedule is not None:
            from repro_torch.pipeline.exec import make_pipeline_runner

            # the combined trace is static — built at schedule time, with
            # (stage, microbatch) attribution and rule="handoff" ppermutes
            self.collectives = pipeline_schedule.trace
            self._fn = make_pipeline_runner(g, pipeline_schedule, mesh)
        elif executor == "shard_map":
            from repro_torch.core import spmd

            self.collectives = spmd.CollectiveTrace()
            self._fn = spmd.make_spmd_runner(
                g, self._out_ids, plan=plan, mesh=mesh,
                trace=self.collectives, fuse=fuse, lookahead=lookahead)
        elif mesh is not None and math.prod(mesh.sizes.values()) > 1:
            raise NotImplementedError(
                "compile: executor='gspmd' on a mesh of more than one rank "
                "needs DTensor placements per node — the DTensor slice of "
                "the port, not ported yet; use executor='shard_map'")

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

    @property
    def collectives_by_rule(self) -> dict | None:
        """{rule: {kind: {count, elems, bytes}}} for the shard_map executor
        (None under gspmd) — the per-rule view of ``.collectives``."""
        return None if self.collectives is None else self.collectives.by_rule()

    def _runner(self):
        if self._fn is None:
            from repro_torch.core import engine
            from repro_torch.models.common import resolve_device

            dev = self.mesh.device if self.mesh is not None else \
                resolve_device(self.device)
            g, in_ids, out_ids = self.graph, self.graph.input_ids(), self._out_ids
            keep = set(out_ids)

            def dense(*arrays):
                vals = engine.run(g, dict(zip(in_ids, arrays)), device=dev,
                                  keep=keep)
                return tuple(vals[o] for o in out_ids)

            self._fn = dense
        return self._fn

    def __call__(self, feeds: Mapping[str, Any] | None = None, /,
                 **kw) -> dict[str, Any]:
        feeds = {**(feeds or {}), **kw}
        for name in self.program._default_ones:
            if name not in feeds:
                node = next(n for n in self.graph.nodes
                            if n.kind == "input" and n.name == name)
                feeds[name] = np.ones(node.shape, node.dtype)
        unknown = sorted(set(feeds) - set(self._in_names))
        if unknown:
            raise KeyError(f"unknown inputs {unknown}; "
                           f"program inputs are {sorted(self._in_names)}")
        missing = sorted(n for n in self._in_names if n not in feeds)
        if missing:
            raise ValueError(f"missing feeds for inputs {missing}")
        outs = self._runner()(*[feeds[n] for n in self._in_names])
        return dict(zip(self._out_names, outs))

    def grad(self, wrt: str | Sequence[str], *,
             output: str | None = None) -> "Program":
        """Convenience: the (uncompiled) gradient program — compile it with
        the planning inputs of your choice."""
        return self.program.grad(wrt, output=output)

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

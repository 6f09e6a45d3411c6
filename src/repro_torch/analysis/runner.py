"""Run the analysis passes over a graph / plan / schedule — backend-free.

The entry points never allocate a tensor or touch a device: planning
(``decomp.eindecomp``) and schedule lowering (``spmd.build_schedule``) are
pure Python over static shapes, so the full pipeline — graph → plan →
schedule → memory — runs on any host, and never initializes CUDA.

``analyze_compiled`` is the post-compile convenience: it re-analyzes what
a ``CompiledProgram`` is actually going to execute (its plan, mesh, and
donation set) and is what the launch/serving hooks call.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.decomp import Plan, eindecomp
from repro_torch.core.einsum import EinGraph

from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.graph_pass import analyze_graph
from repro_torch.analysis.memory_pass import analyze_memory
from repro_torch.analysis.plan_pass import analyze_plan
from repro_torch.analysis.schedule_pass import analyze_schedule


def analyze(g: EinGraph, plan: Plan | None = None,
            mesh_axes: dict[str, int] | None = None,
            out_ids: Sequence[int] | None = None,
            donate: Sequence[str] = (), max_hbm: int | None = None,
            fuse: bool = True, lookahead: int = 1,
            meta: dict | None = None) -> Report:
    """All applicable passes over one cell.

    Graph pass always runs; the plan pass needs ``plan``; the schedule and
    memory passes need ``plan`` + ``mesh_axes`` (they analyze the exact
    static schedule ``build_schedule`` lowers for that pair — including
    the graph-wide ``lookahead`` prefetch hoisting, so the memory pass
    charges prefetch buffers exactly where the executor holds them).
    """
    report = Report(meta=dict(meta or {}))
    outs = list(out_ids) if out_ids is not None else g.outputs()
    report.extend(analyze_graph(g, outs))

    if plan is not None:
        report.extend(analyze_plan(g, plan, mesh_axes))

    if plan is not None and mesh_axes is not None:
        from repro_torch.core.spmd import build_schedule

        try:
            sched = build_schedule(g, plan, dict(mesh_axes), outs, fuse=fuse,
                                   lookahead=lookahead)
        except Exception as e:  # broken plans fail lowering, not the CLI
            report.add(Finding(
                "RA203", f"schedule lowering failed: "
                         f"{type(e).__name__}: {e}"))
            return report
        report.extend(analyze_schedule(g, plan, sched, outs, donate))
        mem_findings, mem_report = analyze_memory(g, sched, outs, donate,
                                                  max_hbm)
        report.extend(mem_findings)
        report.memory = mem_report
    return report


def analyze_schedule_only(g: EinGraph, sched, out_ids=None,
                          donate: Sequence[str] = (),
                          max_hbm: int | None = None,
                          meta: dict | None = None) -> Report:
    """Schedule + memory passes over an already-built (possibly
    hand-constructed) Schedule — the corpus fixtures' entry point."""
    report = Report(meta=dict(meta or {}))
    outs = list(out_ids) if out_ids is not None else g.outputs()
    report.extend(analyze_schedule(g, None, sched, outs, donate))
    mem_findings, mem_report = analyze_memory(g, sched, outs, donate,
                                              max_hbm)
    report.extend(mem_findings)
    report.memory = mem_report
    return report


def analyze_program(program, mesh_axes: dict[str, int],
                    plan: Plan | None = None, donate: Sequence[str] = (),
                    max_hbm: int | None = None, fuse: bool = True,
                    lookahead: int = 1, meta: dict | None = None,
                    pipeline=None) -> Report:
    """Analyze a frontend ``Program`` under a mesh shape, planning with the
    §7 DP when no plan is supplied (both steps are backend-free).

    ``pipeline`` is a ``repro_torch.pipeline.PipelineSpec``: the pipeline pass
    (RA4xx) builds the static ``PipelineSchedule`` against ``mesh_axes``
    (which must carry the pipeline axis at size ``stages``) and verifies
    the stage chain, handoff ordering, per-stage memory, and balance on
    top of the ordinary four passes — still fully backend-free.  A spec
    whose microbatches the graph cannot support (rows coupled across the
    batch label, e.g. MoE capacity routing) is clamped to microbatches=1
    and noted in the report meta."""
    g = program.graph
    out_ids = [program._out[k] for k in program._out]
    if pipeline is not None:
        return _analyze_pipelined(program, g, out_ids, dict(mesh_axes),
                                  pipeline, donate, max_hbm, fuse,
                                  lookahead, meta)
    if plan is None:
        p = math.prod(int(s) for s in mesh_axes.values()) if mesh_axes else 1
        plan = eindecomp(g, p, mesh_axes=dict(mesh_axes))
    return analyze(g, plan, dict(mesh_axes), out_ids, donate, max_hbm,
                   fuse, lookahead, meta)


def _analyze_pipelined(program, g, out_ids, mesh_axes, pipeline, donate,
                       max_hbm, fuse, lookahead, meta) -> Report:
    import dataclasses

    from repro_torch.pipeline import (batch_splittable, build_pipeline_schedule)

    from repro_torch.analysis.pipeline_pass import analyze_pipeline_schedule

    meta = dict(meta or {})
    spec = pipeline
    if spec.microbatches > 1 and not batch_splittable(g, spec.batch_label):
        spec = dataclasses.replace(spec, microbatches=1)
        meta["microbatches_clamped"] = 1
    # offpath_repart=False mirrors the plain path's eindecomp default —
    # the stitched plan is the bit-identity baseline an unpipelined
    # compile of the same cell would run
    psched = build_pipeline_schedule(g, spec, mesh_axes, out_ids,
                                     offpath_repart=False,
                                     fuse=fuse, lookahead=lookahead)
    # graph + plan passes analyze the stitched full-graph plan (the
    # bit-identity baseline the pipeline realizes); the schedule- and
    # memory-level checks run PER STAGE inside the pipeline pass (RA402 /
    # RA403 / RA405) — the pipelined executor never runs the whole-graph
    # schedule, and RA206's whole-graph convention is a statement about
    # DP-produced plans that a per-stage-optimal stitched plan does not
    # satisfy (the sound bound is the per-stage price, RA405)
    report = analyze(g, psched.stitched, None, out_ids, donate, max_hbm,
                     fuse, lookahead, meta)
    report.extend(analyze_pipeline_schedule(g, psched, max_hbm))
    # memory meta: the worst stage's per-device peak — each stage must fit
    peaks = []
    for st in psched.stages:
        if st.sched is None:
            continue
        louts = [st.lid_of[gn] for gn in st.out_gids]
        _, mem = analyze_memory(st.graph, st.sched, louts, (), None)
        peaks.append(mem)
    if peaks:
        report.memory = max(peaks, key=lambda m: m.get("peak_bytes", 0))
    report.meta.setdefault("pipeline", f"p={spec.stages},m="
                                       f"{spec.microbatches}")
    report.meta["bubble"] = round(psched.bubble, 4)
    return report


def analyze_compiled(compiled, max_hbm: int | None = None,
                     meta: dict | None = None,
                     mesh_axes: dict[str, int] | None = None) -> Report:
    """Re-verify what a ``CompiledProgram`` will execute: its own plan,
    mesh, and donation set (the launch / serving hooks' surface).

    ``mesh_axes`` is only needed for programs compiled with
    ``mesh_axes=`` but no ``launch.mesh.Mesh`` (the gspmd executor): the plan is
    mesh-mode but the compiled object has no mesh to read sizes from."""
    from repro_torch.core.engine import mesh_axes_dict

    program = compiled.program
    if mesh_axes is None and compiled.mesh is not None:
        mesh_axes = mesh_axes_dict(compiled.mesh)
    donate = tuple(compiled._in_names[i] for i in compiled.donate_argnums)
    g = program.graph
    out_ids = [program._out[k] for k in program._out]
    return analyze(g, compiled.plan, mesh_axes, out_ids, donate, max_hbm,
                   fuse=True, lookahead=getattr(compiled, "lookahead", 1),
                   meta=meta)

"""Pipeline executor: the GPipe cell schedule on a mesh of
``torch.distributed`` ranks that carries the ``pp`` axis.

Realization (the reference's design, on the port's eager runner): compute
is **replicated over the pp axis** — every rank runs every (stage,
microbatch) cell of ``psched.cells`` in order, each stage's body through
``spmd.run_schedule_body`` with a ``StepContext`` over the intra-stage
axes only, so every intra-stage collective stays within this rank's pp
slice.  Each stage handoff is a *cyclic rotation* over pp (``perm = [(i,
(i + 1) % pp)]``, ``StepContext.ring_shift``: ``batch_isend_irecv``,
staged through the host where gloo ranks hold CUDA blocks).  Because the
graph inputs enter replicated over pp, every slice holds identical values
at every point; the rotation therefore preserves values exactly (slice i
receives from slice i-1 what it already holds) while putting the handoff
bytes on the pp wire exactly where the static trace puts them.  The
static tier (``PipelineSchedule``: cells, per-stage traces, bubble) is the
cost model of the stage-resident schedule; this executor is its bit-exact
value realization — the pipelined outputs equal, bit for bit, the
unpipelined compile of the stitched plan on the same mesh.

Microbatches are split from the batch label's dimension of the global
feeds before the cells, and each microbatch's outputs are assembled to
their global rows before they are concatenated, so the row order is the
batch's.  Feeds without the batch label are shared by every microbatch.

Stage intermediates are dropped after their last reader
(``run_schedule_body`` with ``keep``); a stage's outputs are held only
until the last stage of the same microbatch that reads them has run.

With a size-1 (or absent) pp axis no handoff is issued at all and the
single stage's schedule is the serial ``build_schedule`` verbatim.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import spmd
from repro_torch.core.einsum import EinGraph

from repro_torch.pipeline.schedule import PipelineSchedule


class PipelineRunner:
    """``f(*global_inputs) -> tuple(global outputs)`` running the GPipe
    cells of ``psched`` on this rank of ``mesh``.  ``issued`` holds what
    this rank issued in the last call (``StepContext.issued``, node ids
    global), handoffs included."""

    def __init__(self, g: EinGraph, psched: PipelineSchedule, mesh):
        if dict(mesh.sizes) != psched.sizes:
            raise ValueError(f"pipeline runner: mesh {dict(mesh.sizes)} is "
                             f"not the schedule's {psched.sizes}")
        self.graph = g
        self.schedule = psched
        self.mesh = mesh
        self.issued: list[tuple] = []
        spec = psched.spec
        self.pp = psched.sizes.get(spec.axis, 1)
        self.intra = {a: s for a, s in psched.sizes.items() if a != spec.axis}
        m = spec.microbatches
        stitched = psched.stitched
        self.in_layout = {
            i: spmd._plan_layout(g.nodes[i], stitched.axes_by_node.get(i, {}),
                                 self.intra)
            for i in g.input_ids()}
        self.stage_of = {gn: st.index for st in psched.stages for gn in st.nids}
        self.batch_dim = {
            i: (g.nodes[i].labels.index(spec.batch_label)
                if m > 1 and spec.batch_label in g.nodes[i].labels else None)
            for i in list(g.input_ids()) + list(psched.out_ids)}
        # a boundary tensor is dropped after the last stage that reads it
        outs = set(psched.out_ids)
        last_boundary = {u: k for k, bset in enumerate(psched.boundaries)
                         for u in bset}
        self.drop_after: dict[int, list[int]] = {}
        for u, k in last_boundary.items():
            if u not in outs:
                self.drop_after.setdefault(k + 1, []).append(u)

    def _out_layout(self, o: int):
        st = self.schedule.stages[self.stage_of[o]]
        return st.sched.layouts[st.lid_of[o]]

    def __call__(self, *arrays):
        g, psched, mesh = self.graph, self.schedule, self.mesh
        spec = psched.spec
        p, m = spec.stages, spec.microbatches
        dev = mesh.device
        ctx = spmd.StepContext(mesh, self.intra)

        gvals: list[dict[int, Any]] = [{} for _ in range(m)]
        for i, arr in zip(g.input_ids(), arrays):
            x, dim, layout = torch.as_tensor(arr), self.batch_dim[i], self.in_layout[i]
            if dim is None:  # shared by every microbatch
                blk = ctx.shard(x, layout).to(dev)
                for d in gvals:
                    d[i] = blk
            else:
                for d, c in zip(gvals, torch.chunk(x, m, dim=dim)):
                    d[i] = ctx.shard(c, layout).to(dev)

        for (s, mb) in psched.cells:
            st = psched.stages[s]
            vals: dict[int, Any] = {
                ln: gvals[mb][gn] for gn, ln in st.lid_of.items()
                if st.graph.nodes[ln].kind == "input"}
            keep = {st.lid_of[gn] for gn in st.out_gids}
            n0 = len(ctx.issued)
            spmd.run_schedule_body(st.graph, st.sched, vals, ctx, keep=keep)
            for j in range(n0, len(ctx.issued)):  # local -> global node ids
                nid, *rest = ctx.issued[j]
                ctx.issued[j] = (st.gid_of.get(nid, nid), *rest)
            for gn in st.out_gids:
                gvals[mb][gn] = vals[st.lid_of[gn]]
            del vals
            for u in self.drop_after.get(s, ()):
                gvals[mb].pop(u, None)
            if s < p - 1 and self.pp > 1:
                for u in psched.boundaries[s]:  # priced over the whole mesh
                    gvals[mb][u] = ctx.ring_shift(
                        [gvals[mb][u]], (spec.axis,), nid=u,
                        sizes=psched.sizes).wait()[0]

        self.issued = ctx.issued
        outs = []
        for o in psched.out_ids:
            layout = self._out_layout(o)
            dim = self.batch_dim[o]
            if dim is None:
                outs.append(ctx.assemble(gvals[0][o], layout))
            else:
                outs.append(torch.cat([ctx.assemble(gvals[mb][o], layout)
                                       for mb in range(m)], dim=dim))
        return tuple(outs)


def make_pipeline_runner(g: EinGraph, psched: PipelineSchedule,
                         mesh) -> PipelineRunner:
    """Build the per-rank runner executing the GPipe cell schedule over
    ``mesh`` (a ``launch.mesh.Mesh`` carrying the combined axes
    ``psched.sizes``)."""
    return PipelineRunner(g, psched, mesh)

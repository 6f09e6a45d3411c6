"""Static predicted/traced cost-honesty trajectory for the model zoo.

The §8 DP optimizes the paper's §7 p2p upper bound; the shard_map executor
realizes the plan with ring-priced collectives.  The ratio between the two
— ``plan_cost / traced wire elems`` — is how much the DP *overprices* the
schedule it picked: a large ratio means the DP may forgo plans it misprices
(the gap the calibrated ``CostModel.with_measured`` closes), a ratio that
*shrinks* across PRs means the executor is squandering wire savings on
redundant movement.

Everything here is a pure function of (config, plan, mesh shape): the plan
comes from the deterministic paper-mode DP and the traced elems from the
static ``build_schedule`` — no tensors, no devices — so the per-family
ratios are bit-identical on every host, and equal to the reference's
(``repro/launch/trajectory.py``), whose numbers ``BENCH_spmd.json``
records.
"""
from __future__ import annotations

import math

#: the CI bench mesh: 2x4 forced host devices
MESH_AXES = {"data": 2, "model": 4}

#: the zoo families the trajectory tracks (bench_spmd's FAMILIES)
FAMILIES = ("llama-7b", "mixtral-8x7b", "xlstm-125m", "hymba-1.5b")


def family_ratio(arch: str, phase: str = "prefill",
                 mesh_axes: dict[str, int] | None = None,
                 fuse: bool = True, lookahead: int = 1) -> dict:
    """Deterministic predicted/traced numbers for one zoo family.

    Returns ``{"arch", "phase", "predicted_elems", "traced_elems",
    "ratio"}`` where ``ratio = predicted / traced`` under the paper-mode
    plan and the static fused schedule, plus the graph-wide overlap
    numbers of the ``lookahead`` schedule: ``overlapped_elems`` (ring
    double-buffer + hoisted prefetches, counted once), ``overlap_frac``
    (overlapped / traced), and ``exposed_elems`` (wire left after hiding
    each issue site's overlappable traffic behind its compute window —
    ``core.cost.exposed_wire``).  Pure host Python.
    """
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.core.decomp import eindecomp, plan_cost
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques

    mesh_axes = dict(mesh_axes or MESH_AXES)
    cfg = reduced(get_config(arch))
    prog = program_for(cfg, ShapeConfig("bench", phase, 32, 4))
    g = prog.graph
    make_stub_opaques(capacity_of(g))
    # offpath_repart=True mirrors Program.compile's planning default, so
    # the trajectory prices the same plan bench_spmd executes
    plan = eindecomp(g, math.prod(mesh_axes.values()), mesh_axes=mesh_axes,
                     offpath_repart=True)
    out_ids = [prog._out[k] for k in prog._out]
    sched = spmd.build_schedule(g, plan, mesh_axes, out_ids, fuse=fuse,
                                lookahead=lookahead)
    predicted = int(plan_cost(g, plan))
    traced = int(sched.trace.total_elems)
    overlapped = int(sched.trace.overlapped_elems)
    return {"arch": arch, "phase": phase,
            "predicted_elems": predicted, "traced_elems": traced,
            "ratio": round(predicted / max(traced, 1), 4),
            "overlapped_elems": overlapped,
            "overlap_frac": round(overlapped / max(traced, 1), 4),
            "exposed_elems": int(sched.exposed_wire_elems())}


def family_ratios(fams=FAMILIES, **kw) -> list[dict]:
    return [family_ratio(a, **kw) for a in fams]

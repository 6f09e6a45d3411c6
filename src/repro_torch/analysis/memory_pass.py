"""Memory pass (RA3xx): peak per-device live bytes, statically.

Deinsum (arxiv 2206.08301) derives distributed memory footprints from the
einsum spec alone; this pass does the same from (graph, plan, schedule):
every buffer's per-device block shape is ``local_shape(shape, layout,
sizes)``, liveness follows topo order (producer → last consumer; inputs
and outputs are program-lifetime; donated inputs die after their last
read), and repartition
chains add their largest replay copy as transient working space — at the
consumer for serial chains, at the hoisted issue point for lookahead
prefetches, whose landed shards additionally stay live until the consumer
reads them.

This is what the port's eager runner holds: the caller's feeds stay alive
for the whole call (the runner only reads them) but for the donated ones,
which it frees after their last reader (``core/engine.release``); the
outputs are kept until it returns, and ``spmd.run_schedule_body`` drops
every other value after its last reader, so its memory goes back to the
allocator.  A
repartition chain's steps run one after another on the consumer's
argument, each a fresh tensor.  The pass counts none of the allocator's
rounding or workspace, nor a copy a kernel wrapper makes of an operand.

The result is the deliberate first brick of ROADMAP's
memory-aware planning: ``--max-hbm`` turns the report into a hard bound
(RA301/RA302).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.einsum import EinGraph
from repro_torch.core.spmd import Schedule, _itemsize, local_shape

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.schedule_pass import _replay_chain


def analyze_memory(g: EinGraph, sched: Schedule, out_ids=None,
                   donate: Sequence[str] = (), max_hbm: int | None = None
                   ) -> tuple[list[Finding], dict]:
    """Returns (findings, report).  The report dict carries the numbers a
    run on the card is held against (``torch.cuda.max_memory_allocated``
    over one call, less what was allocated before it and is not the
    call's feeds): ``args_bytes`` / ``out_bytes`` / ``peak_bytes`` are all
    per-device."""
    findings: list[Finding] = []
    sizes = sched.sizes
    consumers = g.consumers()
    out_set = set(out_ids) if out_ids is not None else set(g.outputs())
    donated = {n.nid for n in g.nodes
               if n.kind == "input" and n.name in set(donate)}
    n_pos = len(g.nodes)

    def bytes_of(nid: int, shape=None) -> int:
        n = g.nodes[nid]
        try:
            loc = shape if shape is not None else \
                local_shape(n.shape, sched.layouts.get(nid, ()), sizes)
        except (ValueError, KeyError):
            loc = n.shape  # unrealizable layout: RA203 already flagged it
        return math.prod(loc) * _itemsize(n.dtype) if loc else \
            _itemsize(n.dtype)

    # lifetime [birth, death] in topo positions, inclusive ----------------
    buf_bytes: dict[int, int] = {}
    birth: dict[int, int] = {}
    death: dict[int, int] = {}
    for n in g.nodes:
        buf_bytes[n.nid] = bytes_of(n.nid)
        last = max(consumers.get(n.nid, []), default=n.nid)
        if n.kind == "input":
            # arguments are held for the whole program (the caller owns
            # the feeds) — unless donated, which frees/aliases the buffer
            # after its last read
            birth[n.nid] = 0
            death[n.nid] = last if n.nid in donated else n_pos - 1
        else:
            birth[n.nid] = n.nid
            death[n.nid] = n_pos - 1 if n.nid in out_set else last

    # transient repartition copies: while node t executes, each gathered /
    # re-bucketed argument occupies its largest replay shape next to the
    # resident buffers.  A *prefetched* argument (graph-wide lookahead)
    # widens that lifetime: the chain replays — and peaks — at its hoisted
    # issue position, and the landed shard stays live from there until the
    # consumer reads it, so its final bytes are charged over the whole
    # (issue, consumer] window.
    pf_issue = {(pf.consumer, pf.arg): pf.issue
                for pf in getattr(sched, "prefetches", ()) or ()}
    extra = [0] * n_pos
    prefetch_hold_bytes = 0
    for prog in sched.programs:
        n = g.nodes[prog.nid]
        for ai, (a, steps) in enumerate(zip(n.inputs, prog.arg_steps)):
            if not steps:
                continue
            try:
                shape = local_shape(g.nodes[a].shape,
                                    sched.layouts.get(a, ()), sizes)
            except (ValueError, KeyError):
                continue
            peak = math.prod(shape) if shape else 1
            s = list(shape)
            for st in steps:
                nxt, err = _replay_chain(tuple(s), [st], sizes)
                if err or nxt is None:
                    break
                s = list(nxt)
                peak = max(peak, math.prod(s) if s else 1)
            item = _itemsize(g.nodes[a].dtype)
            issue = pf_issue.get((prog.nid, ai), prog.nid)
            if not 0 <= issue < prog.nid:
                issue = prog.nid  # malformed lifetime: RA208's domain —
                #                   fall back to the serial charge
            extra[issue] += peak * item
            if issue < prog.nid:
                final = (math.prod(s) if s else 1) * item
                prefetch_hold_bytes += final
                for t in range(issue + 1, prog.nid + 1):
                    extra[t] += final

    # peak over topo positions --------------------------------------------
    peak_bytes = 0
    peak_pos = 0
    for t in range(n_pos):
        live = sum(b for nid, b in buf_bytes.items()
                   if birth[nid] <= t <= death[nid])
        live += extra[t]
        if live > peak_bytes:
            peak_bytes, peak_pos = live, t

    args_bytes = sum(buf_bytes[n.nid] for n in g.nodes if n.kind == "input")
    out_bytes = sum(buf_bytes[nid] for nid in out_set)
    top = sorted(buf_bytes.items(), key=lambda kv: -kv[1])[:8]
    report = {
        "peak_bytes": int(peak_bytes),
        "peak_pos": int(peak_pos),
        "args_bytes": int(args_bytes),
        "out_bytes": int(out_bytes),
        "n_buffers": len(buf_bytes),
        "n_prefetches": len(pf_issue),
        "prefetch_hold_bytes": int(prefetch_hold_bytes),
        "top_buffers": [{"nid": nid, "name": g.nodes[nid].name,
                         "bytes": int(b)} for nid, b in top],
    }

    if max_hbm is not None:
        for nid, b in top:
            if b > max_hbm:
                n = g.nodes[nid]
                findings.append(Finding(
                    "RA302", f"buffer {n.name!r} alone is {b:,} B per "
                             f"device, over --max-hbm {int(max_hbm):,} B",
                    nid=nid, node=n.name, srcloc=n.srcloc))
        if peak_bytes > max_hbm:
            n = g.nodes[peak_pos]
            findings.append(Finding(
                "RA301", f"peak live bytes {peak_bytes:,} B per device "
                         f"(at node {peak_pos}, {n.name}) exceed "
                         f"--max-hbm {int(max_hbm):,} B",
                nid=peak_pos, node=n.name, srcloc=n.srcloc))
    return findings, report

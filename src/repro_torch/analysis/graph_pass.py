"""Graph pass (RA0xx): label/bound/dtype consistency and OpDef conformance
of one EinGraph — independent of any plan, mesh, or backend.

Everything here re-derives what the builders *should* have enforced, so
hand-constructed graphs (``EinGraph.opaque`` performs no OpDef validation)
and graphs deserialized from caches get the same checks the frontend path
got at build time.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import opdef
from repro_torch.core.einsum import EinGraph

from repro_torch.analysis.findings import Finding


def _f(code: str, msg: str, n=None) -> Finding:
    if n is None:
        return Finding(code, msg)
    return Finding(code, msg, nid=n.nid, node=n.name, srcloc=n.srcloc)


def _is_float(dtype) -> bool:
    try:
        return np.dtype(dtype).kind == "f"
    except TypeError:
        return False


def analyze_graph(g: EinGraph, out_ids=None) -> list[Finding]:
    findings: list[Finding] = []
    n_nodes = len(g.nodes)

    # RA007: duplicate input names -----------------------------------------
    seen: dict[str, int] = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if n.name in seen:
            findings.append(_f(
                "RA007", f"input name {n.name!r} already used by node "
                         f"{seen[n.name]} — feeds are name-keyed", n))
        seen.setdefault(n.name, n.nid)

    # RA001: dead nodes (not reachable from the requested outputs) ---------
    outs = list(out_ids) if out_ids is not None else g.outputs()
    live: set[int] = set()
    stack = [o for o in outs if 0 <= o < n_nodes]
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(g.nodes[nid].inputs)
    for n in g.nodes:
        if n.nid not in live:
            findings.append(_f(
                "RA001", f"{n.kind} node is unreachable from the requested "
                         f"outputs {sorted(outs)}", n))

    bounds: dict[str, int] = {}  # per-graph label universe is node-local;
    for n in g.nodes:            # bounds reset per node below
        # RA002: node labels vs shape rank ---------------------------------
        if len(n.labels) != len(n.shape):
            findings.append(_f(
                "RA002", f"{len(n.labels)} labels {n.labels} vs rank "
                         f"{len(n.shape)} shape {n.shape}", n))
            continue
        for a in n.inputs:
            if not (0 <= a < n_nodes) or a >= n.nid:
                findings.append(_f(
                    "RA002", f"input edge {a} is not an earlier node "
                             "(graphs are topological by construction)", n))

        if n.kind == "einsum":
            if n.spec is None:
                findings.append(_f("RA008", "einsum node without a spec", n))
                continue
            # RA008: spec arity vs inputs ----------------------------------
            if len(n.spec.in_labels) != len(n.inputs):
                findings.append(_f(
                    "RA008", f"spec {n.spec.pretty()!r} takes "
                             f"{len(n.spec.in_labels)} inputs, node has "
                             f"{len(n.inputs)}", n))
                continue
            if tuple(n.spec.out_labels) != tuple(n.labels):
                findings.append(_f(
                    "RA002", f"node labels {n.labels} differ from spec "
                             f"output labels {n.spec.out_labels}", n))
            # RA002/RA003: per-edge rank + bound consistency ---------------
            bounds = {}
            ok = True
            for i, (ls, a) in enumerate(zip(n.spec.in_labels, n.inputs)):
                an = g.nodes[a]
                if len(ls) != len(an.shape):
                    findings.append(_f(
                        "RA002", f"input {i} ({an.name}) rank "
                                 f"{len(an.shape)} vs edge labels {ls}", n))
                    ok = False
                    continue
                for l, b in zip(ls, an.shape):
                    if bounds.setdefault(l, b) != b:
                        findings.append(_f(
                            "RA003", f"label {l!r} bound {b} on input {i} "
                                     f"({an.name}) vs {bounds[l]} "
                                     "elsewhere", n))
                        ok = False
            if ok:
                want = tuple(bounds.get(l) for l in n.spec.out_labels)
                if want != n.shape:
                    findings.append(_f(
                        "RA003", f"output shape {n.shape} contradicts the "
                                 f"label bounds {want}", n))
            # RA006: float-width drift across einsum operands --------------
            dts = [g.nodes[a].dtype for a in n.inputs]
            fl = [np.dtype(d) for d in dts if _is_float(d)]
            if len(fl) == len(dts) and len({d.itemsize for d in fl}) > 1:
                findings.append(_f(
                    "RA006", f"operand dtypes {[str(d) for d in fl]} "
                             "differ; result silently takes the first", n))

        elif n.kind == "map":
            od = opdef.get(n.op)
            if od is None or od.category != "map":
                findings.append(_f(
                    "RA005", f"map kind {n.op!r} is not a registered map "
                             "op (opdef.list_ops('map'))", n))
            if len(n.inputs) != 1:
                findings.append(_f(
                    "RA008", f"map node takes 1 input, has "
                             f"{len(n.inputs)}", n))
            elif g.nodes[n.inputs[0]].shape != n.shape:
                findings.append(_f(
                    "RA003", "map output shape "
                             f"{n.shape} differs from its input's "
                             f"{g.nodes[n.inputs[0]].shape} (maps are "
                             "elementwise)", n))

        elif n.kind == "opaque":
            base = n.op.split(opdef.VJP_TAG)[0] if opdef.VJP_TAG in n.op \
                else n.op
            od = opdef.get(base)
            if od is None and opdef.executable_or_none(n.op) is None:
                findings.append(_f(
                    "RA005", f"opaque kind {n.op!r} is not registered "
                             "(ein.defop) and has no executable impl", n))
            # RA008: in_labels arity vs inputs -----------------------------
            if n.in_labels and len(n.in_labels) != len(n.inputs):
                findings.append(_f(
                    "RA008", f"{len(n.in_labels)} in_labels for "
                             f"{len(n.inputs)} inputs", n))
            elif n.in_labels:
                # RA002/RA003: edge labels vs input shapes + output -------
                bounds = {l: s for l, s in zip(n.labels, n.shape)}
                for i, (ls, a) in enumerate(zip(n.in_labels, n.inputs)):
                    an = g.nodes[a]
                    if len(ls) != len(an.shape):
                        findings.append(_f(
                            "RA002", f"input {i} ({an.name}) rank "
                                     f"{len(an.shape)} vs edge labels "
                                     f"{ls}", n))
                        continue
                    for l, b in zip(ls, an.shape):
                        if bounds.setdefault(l, b) != b:
                            findings.append(_f(
                                "RA003", f"label {l!r} bound {b} on input "
                                         f"{i} ({an.name}) vs {bounds[l]} "
                                         "elsewhere", n))
            # RA004: re-run the OpDef signature inference ------------------
            if od is not None and od.signature is not None and \
                    opdef.VJP_TAG not in n.op and \
                    len(n.inputs) == len(od.in_labels):
                try:
                    bound = opdef.bind_call(
                        od, [g.nodes[a].shape for a in n.inputs],
                        in_labels=n.in_labels,
                        out_labels=n.labels or None,
                        params=n.call_params)
                except opdef.OpDefError as e:
                    findings.append(_f("RA004", str(e), n))
                else:
                    if bound["out_shape"] != n.shape:
                        findings.append(_f(
                            "RA004", f"node shape {n.shape} contradicts "
                                     "the signature-inferred "
                                     f"{bound['out_shape']}", n))

    return findings

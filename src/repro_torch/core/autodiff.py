"""Backward-graph construction for EinGraphs (paper Experiment 2 needs the
*training* computation as an EinGraph so EinDecomp can plan it).

Reverse-mode accumulation where every adjoint is itself an EinSum node:

* contraction  Z[lZ] = sum X[lX] * Y[lY]
    dX[lX] = einsum(dZ[lZ], Y[lY] -> lX)    (and symmetrically dY)
    — with a broadcast node first when lX contains labels absent from
      lZ ∪ lY (a label aggregated out of X alone).
* elementwise add/sub: adjoints pass through (negated for the sub rhs).
* elementwise mul: dX = dZ ⊙ Y.
* map f: dX = dZ ⊙ f'(x) — f' from the map op's OpDef ``grad`` link
  (the historical GRAD_MAPS registry, now a view over core/opdef.py).
* opaque f: the OpDef's VJP rule (``vjp="auto"`` emits derived
  ``<kind>@vjp<i>`` opaque nodes executed through ``torch.func.vjp`` of the
  forward impl; custom rules build arbitrary backward structure) — an
  OpDef without a VJP raises an actionable error naming the op.

The result is a plain EinGraph (forward + backward nodes), so the same
EinDecomp DP plans fwd+bwd jointly — exactly the paper's FFNN experiment.
"""
from __future__ import annotations

import copy
from typing import Sequence

from repro_torch.core import opdef
from repro_torch.core.einsum import EinGraph, EinSpec

#: map kind -> derivative map kind.  A live view over the unified OpDef
#: registry (every builtin elementwise map declares its grad link in
#: core/opdefs_builtin.py; tests/test_autodiff_gradmaps.py pins coverage).
#: softmax_last is deliberately grad-less: its Jacobian is not diagonal,
#: so it is not derivative-map eligible (grad_graph raises).
GRAD_MAPS = opdef.GRAD_MAPS


def grad_graph(
    g: EinGraph, loss_nid: int, wrt: Sequence[int]
) -> tuple[EinGraph, dict[int, int], int]:
    """Extend a copy of ``g`` with backward nodes.

    Returns (graph, {wrt input nid -> grad nid}, seed input nid).  The seed
    is a new graph input with the loss's shape; feed ones (or an incoming
    cotangent) to evaluate.
    """
    gg = copy.deepcopy(g)
    loss = gg.nodes[loss_nid]
    seed = gg.input("dLoss_seed", loss.labels, loss.shape, loss.dtype)

    adj: dict[int, list[int]] = {loss_nid: [seed]}

    def adjoint_of(nid: int) -> int | None:
        contribs = adj.get(nid)
        if not contribs:
            return None
        while len(contribs) > 1:
            a, b = contribs.pop(), contribs.pop()
            la = gg.nodes[a].labels
            s = " ".join(la)
            contribs.append(gg.einsum(f"{s}, {s} -> {s}", a, b, combine="add",
                                      agg="", name=f"accum{nid}"))
        return contribs[0]

    for nid in reversed(g.topo_order()):
        n = gg.nodes[nid]
        dz = adjoint_of(nid)
        if dz is None or n.kind == "input":
            continue
        if n.kind == "einsum":
            spec = n.spec
            if len(spec.in_labels) == 2:
                lx, ly = spec.in_labels
                lz = spec.out_labels
                if spec.combine == "mul" and spec.agg == "sum":
                    _back_contract(gg, adj, dz, n.inputs[0], lx, n.inputs[1], ly, lz)
                    _back_contract(gg, adj, dz, n.inputs[1], ly, n.inputs[0], lx, lz)
                elif spec.combine in ("add", "sub") and not spec.agg_labels:
                    adj.setdefault(n.inputs[0], []).append(
                        _reshape_adj(gg, dz, lz, lx))
                    rhs = _reshape_adj(gg, dz, lz, ly)
                    if spec.combine == "sub":
                        rhs = gg.map("neg", rhs)
                    adj.setdefault(n.inputs[1], []).append(rhs)
                elif spec.combine == "mul" and not spec.agg_labels:
                    for me, other, lme, loth in ((0, 1, lx, ly), (1, 0, ly, lx)):
                        d = gg.einsum(
                            f"{' '.join(lz)}, {' '.join(loth)} -> {' '.join(lme)}",
                            dz, n.inputs[other], combine="mul",
                            agg="sum" if set(loth) - set(lme) or set(lz) - set(lme)
                            else "")
                        adj.setdefault(n.inputs[me], []).append(d)
                else:
                    raise NotImplementedError(
                        f"grad for combine={spec.combine} agg={spec.agg}")
            else:
                (lx,) = spec.in_labels
                lz = spec.out_labels
                if spec.combine == "id" and spec.agg in ("", "sum"):
                    if set(lx) <= set(lz):
                        adj.setdefault(n.inputs[0], []).append(
                            _reshape_adj(gg, dz, lz, lx))
                    else:  # sum-reduction: adjoint broadcasts back up
                        node_in = gg.nodes[n.inputs[0]]
                        d = gg.opaque(
                            "broadcast_to", [dz], node_in.labels, node_in.shape,
                            in_labels=[tuple(lz)], shardable=node_in.labels,
                            labels=tuple(node_in.labels),
                            shape=tuple(node_in.shape), src_labels=tuple(lz))
                        adj.setdefault(n.inputs[0], []).append(d)
                else:
                    raise NotImplementedError(f"unary grad for {spec.combine}")
        elif n.kind == "map":
            gname = GRAD_MAPS.get(n.op)
            if gname is None:
                raise NotImplementedError(
                    f"grad for map {n.op}: its OpDef declares no grad link "
                    "(ein.defop(..., category='map', grad='<kind>'))")
            local = gg.map(gname, n.inputs[0], **n.params)
            s = " ".join(n.labels)
            d = gg.einsum(f"{s}, {s} -> {s}", dz, local, combine="mul", agg="")
            adj.setdefault(n.inputs[0], []).append(d)
        else:
            # opaque: the OpDef's VJP rule builds the backward nodes
            for a, d in zip(n.inputs, opdef.build_vjp(gg, n, dz)):
                if d is not None:
                    adj.setdefault(a, []).append(d)

    grads: dict[int, int] = {}
    for w in wrt:
        gnid = adjoint_of(w)
        if gnid is None:
            raise ValueError(f"no gradient path to node {w}")
        grads[w] = gnid
    return gg, grads, seed


def _back_contract(gg, adj, dz, target, lt, other, lo, lz):
    """dTarget = einsum(dZ, Other -> lT), broadcasting labels of lT that are
    in neither lZ nor lO (aggregated out of target alone)."""
    avail = set(lz) | set(lo)
    missing = [l for l in lt if l not in avail]
    keep = [l for l in lt if l in avail]
    agg_needed = bool((set(lz) | set(lo)) - set(keep))
    d = gg.einsum(
        f"{' '.join(lz)}, {' '.join(lo)} -> {' '.join(keep)}",
        dz, other, combine="mul", agg="sum" if agg_needed else "")
    if missing:
        node_t = gg.nodes[target]
        d = gg.opaque(
            "broadcast_to", [d], node_t.labels, node_t.shape,
            in_labels=[tuple(keep)], shardable=node_t.labels,
            labels=tuple(node_t.labels), shape=tuple(node_t.shape),
            src_labels=tuple(keep))
    adj.setdefault(target, []).append(d)


def _reshape_adj(gg, dz, l_from, l_to):
    """Transpose/broadcast an adjoint from labels l_from to l_to."""
    if tuple(l_from) == tuple(l_to):
        return dz
    if set(l_to) <= set(l_from):
        return gg.einsum(f"{' '.join(l_from)} -> {' '.join(l_to)}", dz,
                         combine="id",
                         agg="sum" if set(l_from) - set(l_to) else "")
    node = gg.nodes[dz]
    raise NotImplementedError(f"adjoint broadcast {l_from} -> {l_to}")

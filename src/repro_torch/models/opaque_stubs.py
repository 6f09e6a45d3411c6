"""Deterministic, shape-correct stand-ins for opaque kinds that are
*declared* (``core/opdefs_builtin.py``: signature, comm, shard rule) but
ship no engine implementation of their own (MoE dispatch/combine, the
recurrent scans).

The executor tests and ``chip_smoke.py`` use them to pin that two
execution paths realize the *same dataflow* (the dense run and the
``shard_map`` run with its ``a2a`` rule), not the fused ops' numerics,
which live with the model stack (``models/moe.py``).

The MoE pair implements real (deterministic, top-1, capacity-dropped)
token routing through ``core.opaque_rules.moe_route``, the same helper the
expert-parallel ``a2a`` rule builds its all_to_all program from.  Dispatch
places each kept token's activation at its global ``(expert, slot)``;
combine gathers it back gate-weighted (dropped tokens contribute 0).  The
scans' stand-in is a running mean over the sequence.

``make_stub_opaques`` registers through ``opdef.provide_impl``, which
checks each impl's output shape against the declared signature; the
returned dict can also be set into ``engine.OPAQUE_FNS`` by hand.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.opaque_rules import moe_route


def capacity_of(g) -> int:
    """Expert capacity of the graph's MoE dispatch node (0 if none)."""
    disp = [n for n in g.nodes if n.op == "moe_dispatch"]
    return disp[0].shape[1] if disp else 0


def cumnorm(h, **_):
    """The scans' stand-in: the running mean along the sequence (dim 1)."""
    h = torch.as_tensor(h)
    t = torch.arange(1, h.shape[1] + 1, dtype=h.dtype,
                     device=h.device)[None, :, None]
    return torch.cumsum(h, dim=1) / t


def make_stub_opaques(capacity: int = 0, *,
                      register: bool = True) -> dict[str, Callable]:
    """{opaque kind: deterministic stand-in}.  ``capacity`` (from
    ``capacity_of``) is the default where a dispatch node carries no
    ``capacity`` param of its own; OpDef-built graphs always do.  With
    ``register`` the impls are attached to their OpDefs
    (``opdef.provide_impl``, signature-checked)."""

    def dispatch(x, route, capacity=capacity):
        x, route = torch.as_tensor(x), torch.as_tensor(route)
        b, s, d = x.shape
        expert, pos, _gate, _cnt = moe_route(route)
        keep = pos < capacity
        xt = x.transpose(0, 1).reshape(s * b, d)
        out = torch.zeros((route.shape[-1], capacity, d), dtype=x.dtype,
                          device=x.device)
        out[expert[keep], pos[keep].long()] = xt[keep]  # kept slots are unique
        return out

    def combine(y, route):
        y, route = torch.as_tensor(y), torch.as_tensor(route)
        _, cap, d = y.shape
        b, s, _ = route.shape
        expert, pos, gate, _cnt = moe_route(route)
        keep = pos < cap
        vals = y[torch.where(keep, expert, 0), torch.where(keep, pos, 0).long()]
        vals = vals * (gate * keep).to(y.dtype)[:, None]
        return vals.reshape(s, b, d).transpose(0, 1)

    fns = {"ssm_scan": cumnorm, "mlstm_scan": cumnorm, "slstm_scan": cumnorm,
           "moe_dispatch": dispatch, "moe_combine": combine}
    if register:
        from repro_torch.core import opdef

        for kind, fn in fns.items():
            opdef.provide_impl(kind, fn)
    return fns

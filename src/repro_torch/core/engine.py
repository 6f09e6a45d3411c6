"""Execute an EinGraph with PyTorch, optionally under an EinDecomp plan.

Each node lowers to the corresponding torch op on the caller's device: a
contraction to ``torch.einsum``, a general (⊗, ⊕) node to broadcast +
reduce over the ``_COMBINE2`` / ``_COMBINE1`` / ``_AGG`` tables, a map or
opaque node to its OpDef's executable (the kernel dispatcher where the op
has one, so flash attention launches its kernel on a card).

Two executors realize a plan (``EXECUTORS``):

  * ``gspmd`` — the dense run on one device; on a mesh of more than one
    rank the plan's per-node shardings as DTensor placements
    (``core/gspmd.py``), the port's counterpart of the reference's
    per-node sharding constraints that XLA's partitioner realizes.
  * ``shard_map`` — core/spmd.py: the plan's TRA dataflow as explicit
    ``torch.distributed`` collectives between the ranks of a
    ``launch.mesh.Mesh``, every clean contraction through the matmul kernel,
    opaque nodes through the shard-rule registry.

Every runner drops a value after its last reader.  A feed compiled as
donated (``Program.compile(donate=)``) goes further: after its last
reader the runner frees its storage — the caller's tensor, and the
runner's copy or block of it — and the caller's tensor raises on any
later use (``DonatedTensor``), as XLA invalidates a donated buffer
(``donatable``, ``release``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.einsum import EinGraph, EinSpec, resolve_feeds

# ---------------------------------------------------------------------------
# Per-node lowering
# ---------------------------------------------------------------------------

_COMBINE2 = {
    "mul": lambda x, y: x * y,
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "div": lambda x, y: x / y,
    "sqdiff": lambda x, y: (x - y) ** 2,
    "absdiff": lambda x, y: torch.abs(x - y),
    "maximum": torch.maximum,
    "expsub": lambda x, y: torch.exp(x - y),
}

_COMBINE1 = {
    "id": lambda x: x,
    "exp": torch.exp,
    "neg": lambda x: -x,
    "abs": torch.abs,
    "square": lambda x: x * x,
}

_AGG = {
    "sum": lambda x, dims: torch.sum(x, dim=dims),
    "max": lambda x, dims: torch.amax(x, dim=dims),
    "min": lambda x, dims: torch.amin(x, dim=dims),
    "prod": lambda x, dims: _prod(x, dims),
}


def _prod(x, dims):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d)
    return x


def lower_einsum(spec: EinSpec, *args):
    """One EinSum node -> torch.  Contractions go straight to
    ``torch.einsum``; general (⊗, ⊕) nodes lower to broadcast + reduce."""
    if spec.is_contraction and len(spec.in_labels) == 2:
        return torch.einsum(spec.einsum_str(), *args)
    if spec.is_contraction and len(spec.in_labels) == 1 and spec.combine == "id":
        return torch.einsum(spec.einsum_str(), *args)

    all_labels = spec.all_labels

    def lift(arr, labels):
        perm_src = list(labels)
        for l in all_labels:
            if l not in perm_src:
                arr = arr[..., None]
                perm_src.append(l)
        return arr.permute([perm_src.index(l) for l in all_labels])

    lifted = [lift(a, ls) for a, ls in zip(args, spec.in_labels)]
    if len(lifted) == 2:
        joined = _COMBINE2[spec.combine](*lifted)
    else:
        joined = _COMBINE1[spec.combine](lifted[0])
    if spec.agg and spec.agg_labels:
        dims = tuple(i for i, l in enumerate(all_labels) if l in spec.agg_labels)
        joined = _AGG[spec.agg](joined, dims)
    kept = [l for l in all_labels if l not in spec.agg_labels]
    return joined.permute([kept.index(l) for l in spec.out_labels])


# map / opaque execution registries: live views over the one OpDef
# registry (core/opdef.py), as in the reference
from repro_torch.core.opdef import MAP_FNS, OPAQUE_FNS  # noqa: E402


def register_opaque(name: str, fn: Callable) -> None:
    """Deprecated: register through the unified OpDef API instead —
    ``ein.defop(name, "<signature>", fn=...)`` bundles the signature, dense
    impl, kernel dispatcher, VJP, comm declaration, and shard rule in one
    record (this shim installs a bare impl with none of that metadata)."""
    from repro_torch.core import opdef

    opdef.register_legacy(name, fn, surface="engine.register_opaque")


def mesh_axes_dict(mesh) -> dict[str, int]:
    """{axis name: size} for a ``launch.mesh.Mesh`` — the planner's mesh
    description.  (Re-exported by launch/mesh.py; lives here so core never
    imports launch.)"""
    return dict(mesh.sizes)


# ---------------------------------------------------------------------------
# Plan -> placements
# ---------------------------------------------------------------------------


def spec_for_node(node, axes_by_label: dict[str, tuple[str, ...]]) -> tuple:
    """Per-dim mesh axes of a node's output from its label->axes map: the
    plain-tuple form of the reference's PartitionSpec (``None`` =
    unsharded, an axis name, or a tuple of axis names)."""
    from repro_torch.core.gspmd import spec_of

    return spec_of(node.labels, axes_by_label)


def plan_shardings(g: EinGraph, plan, mesh) -> dict[int, tuple]:
    """DTensor placements per node output for a mesh-mode plan (the
    reference's ``NamedSharding`` per node), one per axis of ``mesh`` (a
    ``launch.mesh.Mesh`` or ``{axis: size}``)."""
    from repro_torch.core.gspmd import placements

    return {n.nid: placements(spec_for_node(n, plan.axes_by_node.get(n.nid, {})),
                              mesh)
            for n in g.nodes}


# ---------------------------------------------------------------------------
# Graph execution
# ---------------------------------------------------------------------------


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


class DonatedTensor(torch.Tensor):
    """What a donated feed becomes once a call has freed its storage:
    every torch operation on it raises, as JAX raises on a deleted
    array."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(
            f"{getattr(func, '__name__', func)}: this tensor was donated to "
            "a compiled program's call (compile(donate=)), which freed its "
            "storage after its last read")


def _storage_of(t):
    """The data pointer of ``t``'s storage (a DTensor's local block's), or
    None for what is not a tensor holding memory."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t._local_tensor
    if not torch.is_tensor(t) or t.device.type == "meta":
        return None
    return t.untyped_storage().data_ptr()


def _owns_storage(t: torch.Tensor) -> bool:
    """Whether ``t`` is the whole of its storage: not a view of a tensor
    the caller may still hold (a slice, one piece of ``split``), whose
    memory a donation of ``t`` alone must not take."""
    return (t._base is None and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.nbytes)


def donatable(feeds: dict[int, Any], donate: Sequence[int],
              keep: set[int]) -> dict[int, torch.Tensor]:
    """``{input id: the caller's tensor}`` of the donated feeds a call may
    free after their last reader: plain tensors that own their whole
    storage, that are not outputs (``keep``) and share their storage with
    no other feed — the static verifier's rules: a donation also returned
    (RA202) or aliasing another feed is not freed, one nobody reads
    (RA207) frees nothing, having no last reader.  A view of a larger
    tensor is kept whole, as an aliased feed is.  Numpy feeds are not the
    caller's memory on a card (the runner's copy goes with its last
    reader) and are never freed."""
    from collections import Counter

    shared = Counter(_storage_of(x) for x in feeds.values())
    return {nid: feeds[nid] for nid in donate
            if nid not in keep
            and type(feeds[nid]) in (torch.Tensor, torch.nn.Parameter)
            and feeds[nid].device.type != "meta"
            and shared[_storage_of(feeds[nid])] == 1
            and _owns_storage(feeds[nid])
            and feeds[nid].untyped_storage().resizable()}


def release(fed: torch.Tensor, value, vals: dict[int, Any]) -> None:
    """Free a donated feed after its last reader: the storage of the
    caller's tensor ``fed`` and of the runner's ``value`` of it (a copy, or
    a DTensor whose local block is a slice), unless a value still held
    (``vals``, without this feed) shares either — a view of the feed that
    outlives it keeps the feed whole.  ``fed`` then raises on any use."""
    from torch.distributed.tensor import DTensor

    mine = {_storage_of(fed), _storage_of(value)} - {None}
    if any(_storage_of(v) in mine for v in vals.values()):
        return
    local = value._local_tensor if isinstance(value, DTensor) else value
    for t in (local, fed):
        if torch.is_tensor(t) and t.untyped_storage().resizable():
            t.untyped_storage().resize_(0)
    fed.__class__ = DonatedTensor


def drop(vals: dict[int, Any], a: int, donated: dict[int, Any]) -> None:
    """Drop node ``a``'s value after its last reader, and free it if it is
    a donated feed (``donatable``, ``release``)."""
    v = vals.pop(a, None)
    if a in donated:
        release(donated[a], v, vals)


def live_nodes(g: EinGraph, keep) -> set[int]:
    """The nodes ``keep`` depends on, ``keep`` included: what a run that
    returns only ``keep`` must compute.  A gradient graph holds adjoints
    nobody reads (the input X's in an FFNN that asked for the weights'
    only); a compiler drops them as dead code, and so does the eager
    runner."""
    live: set[int] = set()
    stack = list(keep)
    while stack:
        nid = stack.pop()
        if nid not in live:
            live.add(nid)
            stack.extend(g.nodes[nid].inputs)
    return live


def run(g: EinGraph, feeds: dict[Any, Any], *, device=None,
        keep: set[int] | None = None, plan=None, mesh=None,
        donate: Sequence[int] = ()) -> dict[int, torch.Tensor]:
    """Evaluate the graph densely with torch on ``device`` (default: where
    the feeds are).  ``feeds`` may be keyed by input *name* or node id
    (``resolve_feeds``).  Returns every node's value, or with ``keep``
    only those in ``keep``: the others are dropped after their last
    reader, and nodes that ``keep`` does not depend on are not run.

    With a mesh-mode ``plan`` and a ``mesh`` of more than one rank every
    rank runs the ``gspmd`` executor (``core/gspmd.py``): each rank keeps
    its blocks of the feeds, every node computes on local blocks and is
    redistributed to its planned placements, and the values come back
    whole on every rank, as the reference returns global arrays.

    ``donate`` (input ids; with ``keep``) frees those feeds after their
    last reader (``donatable``, ``release``)."""
    feeds = resolve_feeds(g, feeds)
    if _multi_rank(mesh):
        from repro_torch.core.gspmd import GspmdRunner, full

        ids = sorted(keep) if keep is not None else [n.nid for n in g.nodes]
        runner = GspmdRunner(g, plan, mesh, ids, donate=donate)
        vals = runner.run_nodes(feeds, set(ids))
        return {k: full(v) for k, v in vals.items()}
    last: dict[int, int] = {}
    live = None
    if keep is not None:
        live = live_nodes(g, keep)
        for n in g.nodes:
            if n.nid in live:
                for a in n.inputs:
                    last[a] = max(last.get(a, -1), n.nid)
    donated = donatable(feeds, donate, keep) if keep is not None else {}
    vals: dict[int, torch.Tensor] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        if live is not None and nid not in live:
            continue
        if n.kind == "input":
            v = _on(feeds[nid], device)
        elif n.kind == "einsum":
            v = lower_einsum(n.spec, *[vals[a] for a in n.inputs])
        elif n.kind == "map":
            v = MAP_FNS[n.op](vals[n.inputs[0]], **n.params)
        else:
            v = OPAQUE_FNS[n.op](*[vals[a] for a in n.inputs], **n.call_params)
        vals[nid] = v
        if keep is not None:
            for a in set(n.inputs):
                if last[a] == nid and a not in keep:
                    drop(vals, a, donated)
    return vals


#: executors ``make_runner`` / ``Program.compile`` can build:
#:   gspmd     — the dense run on one device; on a mesh of more than one
#:               rank, the plan's per-node placements on DTensor
#:               (core/gspmd.py), DTensor choosing the collectives as XLA's
#:               partitioner does for the reference's constraints.
#:   shard_map — core/spmd.py: the plan's TRA dataflow emitted literally as
#:               torch.distributed collectives between the mesh's ranks;
#:               opaque nodes dispatch per rank through the shard-rule
#:               registry (core/opaque_rules.py).
EXECUTORS = ("gspmd", "shard_map")


def _multi_rank(mesh) -> bool:
    return mesh is not None and math.prod(mesh_axes_dict(mesh).values()) > 1


def make_runner(g: EinGraph, out_ids: Sequence[int] | None = None, *,
                plan=None, mesh=None, cache=None,
                mesh_axes: dict[str, int] | None = None, p: int | None = None,
                cost_mode: str = "paper",
                offpath_repart: bool = True,
                executor: str = "gspmd",
                collective_trace=None,
                fuse: bool = True,
                lookahead: int = 1,
                device=None) -> Callable:
    """Build ``f(*feeds) -> outputs`` for the graph (feeds positional in
    input-node order; one output is returned bare, several as a tuple).

    ``executor`` selects how the plan is realized (see ``EXECUTORS``):
    ``"gspmd"`` runs densely on ``device`` (on ``mesh.device`` when a
    one-rank mesh is given; on the card when neither is, raising where
    there is none — pass ``device="cpu"`` for the host), and on a mesh of
    more than one rank places every node as the plan says on DTensor
    (``core/gspmd.py``; a bare mesh self-plans, as under shard_map), each
    rank returning the whole outputs; ``"shard_map"`` runs the plan's
    join→agg→repartition dataflow with explicit collectives over ``mesh``
    (a ``launch.mesh.Mesh``; it needs a mesh-mode plan, so a bare mesh
    self-plans).  ``collective_trace`` (a ``core.spmd.CollectiveTrace``)
    receives the shard_map executor's static collective schedule;
    ``fuse`` and ``lookahead`` are its repartition-fusion and overlap
    knobs (see ``spmd.build_schedule``).

    Planning inputs (``p``, ``mesh_axes``, or a ``mesh`` with a ``cache``)
    plan the graph here when no ``plan`` is given — consulting ``cache``
    (a ``core.plancache.PlanCache``) before running the DP.  An explicit
    ``plan`` always takes precedence."""
    if executor not in EXECUTORS:
        raise ValueError(f"make_runner: unknown executor {executor!r}; "
                         f"choose from {EXECUTORS}")
    if collective_trace is not None and executor != "shard_map":
        raise ValueError("make_runner: collective_trace is only produced by "
                         "the shard_map executor")
    if (plan is None and cache is not None and mesh is None
            and p is None and mesh_axes is None):
        raise ValueError(
            "make_runner: cache given but nothing to plan with — pass "
            "mesh, mesh_axes, or p")
    if plan is None and (p is not None or mesh_axes is not None
                         or (cache is not None and mesh is not None)
                         or (executor == "shard_map" and mesh is not None)
                         or (executor == "gspmd" and _multi_rank(mesh))):
        from repro_torch.core.decomp import eindecomp

        if mesh is None and cache is None:
            raise ValueError(
                "make_runner: planning inputs (p/mesh_axes) have no effect "
                "without a mesh to shard by or a cache to warm")
        if mesh_axes is None and mesh is not None:
            mesh_axes = mesh_axes_dict(mesh)
        if p is None:
            if not mesh_axes:
                raise ValueError("make_runner: planning needs p or mesh/mesh_axes")
            p = math.prod(mesh_axes.values())
        plan = eindecomp(g, p, mesh_axes=mesh_axes, cost_mode=cost_mode,
                         offpath_repart=offpath_repart, cache=cache)
    in_ids = g.input_ids()
    out_ids = list(out_ids) if out_ids is not None else g.outputs()

    if executor == "shard_map":
        from repro_torch.core import spmd

        if mesh is None or plan is None:
            raise ValueError("make_runner: executor='shard_map' needs a "
                             "mesh and a (mesh-mode) plan")
        mapped = spmd.make_spmd_runner(g, out_ids, plan=plan, mesh=mesh,
                                       trace=collective_trace, fuse=fuse,
                                       lookahead=lookahead)

        def f_spmd(*arrays):
            outs = mapped(*arrays)
            return outs[0] if len(outs) == 1 else outs

        f_spmd.runner = mapped
        return f_spmd

    if _multi_rank(mesh):
        from repro_torch.core.gspmd import GspmdRunner

        runner = GspmdRunner(g, plan, mesh, out_ids)

        def f_gspmd(*arrays):
            outs = runner(*arrays)
            return outs[0] if len(outs) == 1 else outs

        f_gspmd.runner = runner
        return f_gspmd

    if device is None and mesh is not None:
        device = mesh.device
    else:
        from repro_torch.models.common import resolve_device

        device = resolve_device(device)  # the card unless asked otherwise
    keep = set(out_ids)

    def f(*arrays):
        vals = run(g, dict(zip(in_ids, arrays)), device=device, keep=keep)
        outs = tuple(vals[o] for o in out_ids)
        return outs[0] if len(outs) == 1 else outs

    return f

"""The ``gspmd`` executor on DTensor: a plan's per-node shardings as
placements on the ``DeviceMesh`` a ``launch.mesh.Mesh`` carries.

The reference applies a mesh-mode plan as ``with_sharding_constraint`` on
every node output and lets XLA's partitioner choose the collectives.  The
port's counterpart of GSPMD is DTensor (``torch.distributed.tensor``):

  * a spec — one entry per tensor dim, ``None``, an axis name or a tuple of
    axis names, the plain-tuple form of a ``PartitionSpec`` — becomes one
    placement per mesh dim (``placements``): ``Shard(d)`` where the axis
    splits dim ``d``, ``Replicate()`` elsewhere.  An entry naming several
    axes becomes ``[Shard(d), Shard(d)]``, which nests the blocks in mesh
    order, as JAX's ``P(("data", "model"))`` does.  ``placements`` refuses
    an entry whose axes are out of mesh order (it would need
    ``_StridedShard``); its callers here — ``wrap``, ``distribute``,
    ``constrain`` and the executor's program — nest such an entry in mesh
    order first (``nested``): every rank holds a block of the same shape
    and the global tensor is the same, only which rank holds which block
    differs from the reference;
  * ``with_sharding_constraint`` becomes ``redistribute`` to those
    placements (``constrain``), and DTensor's redistribution planner picks
    the collectives (all-gather, all-to-all, all-reduce, reduce-scatter);
  * model code between constraints runs on DTensors, and DTensor's sharding
    propagation places each op, as XLA's partitioner does for the
    reference — but for the products of an activation and a weight, which
    run on local blocks (``local_einsum``: where both operands are split,
    the one that costs fewer bytes moves).

The graph executor (``GspmdRunner``) computes each node's join on the
local blocks of its inputs, placed as the plan's join layout says — the
layout the ``shard_map`` executor computes in — and wraps the block with
``DTensor.from_local``: contracted axes come back as ``Partial``, and the
redistribution to the node's planned placements resolves them.  It does
not hand a whole contraction to ``torch.einsum`` on DTensors: a plan may
put one label on two mesh axes (llama-7b's ``f`` and ``v`` on ``("data",
"model")``), and DTensor cannot take such a layout through the views
``torch.einsum`` decomposes into.  So every collective the executor issues
is a redistribution between two placements, chosen by DTensor, but for
the ``a2a`` rule's.  Opaque nodes run their kernels on local blocks placed
as their shard rule keeps them local (flash attention: batch and heads,
whole sequence); the ``a2a`` rule (expert-parallel MoE dispatch and
combine) runs its own program on its blocks — the sequence split over its
axes in, the experts out — and issues its collectives (an all-gather of
the per-expert counts, the all-to-alls of slots and payloads) through an
``spmd.StepContext`` on the mesh's process group over those axes, as the
``shard_map`` executor does.  An opaque node whose rule has no local
lowering under its plan assignment, or whose rule is none of the built-in
ones, is lowered through the ``replicate`` rule — its inputs gathered
whole, the op run whole on every rank, each rank keeping its block of the
output — as the ``shard_map`` executor falls back, and as XLA partitions
a custom call that has no partitioning rule.  A ``prod`` aggregation over
a split label is a ``Partial("product")``: each rank's product over its
block, the blocks' products multiplied across the label's axes.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.core.einsum import EinGraph, Node

# ---------------------------------------------------------------------------
# Specs -> placements
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_of(axes: Sequence[str]):
    """The spec entry of a tuple of mesh axes (None, a name, or a tuple)."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def spec_of(labels: Sequence[str], axes_by_label: dict) -> tuple:
    """Spec of a tensor with ``labels`` under a label->axes map."""
    return tuple(entry_of(axes_by_label.get(l, ())) for l in labels)


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``launch.mesh.Mesh``, a dict of axis sizes, or
    anything with the reference mesh's ``axis_names`` and
    ``devices.shape``."""
    if hasattr(mesh, "sizes"):
        return dict(mesh.sizes)
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(mesh)


def placements(spec: Sequence, mesh, partial: Sequence[tuple[str, str]] = ()
               ) -> tuple:
    """DTensor placements (one per mesh axis, in mesh order) for ``spec``,
    with ``partial`` — ``(axis, "sum" | "max" | "min" | "product")``
    pairs — marking
    axes that hold partial results.  Size-1 axes shard nothing and are
    dropped.  Raises ``NotImplementedError`` for an entry whose axes are
    out of mesh order, ``ValueError`` for an axis the mesh lacks or one
    that splits two dims."""
    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    out: list = [Replicate()] * len(names)
    used: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ValueError(f"spec {tuple(spec)}: axes {unknown} are not "
                             f"on the mesh {sizes}")
        axes = tuple(a for a in axes if sizes[a] > 1)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry!r} (dim {d} of {tuple(spec)}) lists its "
                f"mesh axes out of the mesh's order {names}: DTensor's "
                "[Shard(d), Shard(d)] nests blocks in mesh order, and the "
                "port does not place the other order (_StridedShard)")
        for a, i in zip(axes, idx):
            if a in used:
                raise ValueError(f"spec {tuple(spec)}: axis {a!r} splits "
                                 f"dims {used[a]} and {d}")
            used[a] = d
            out[i] = Shard(d)
    for a, op in partial:
        if sizes[a] > 1:
            out[names.index(a)] = Partial(op)
    return tuple(out)


def nested(spec: Sequence, mesh) -> tuple:
    """``spec`` with each entry's axes in mesh order, the order in which
    DTensor's ``[Shard(d), Shard(d)]`` nests blocks.  ``wrap``,
    ``distribute`` and ``constrain`` place their specs so (``placements``
    itself refuses an entry out of mesh order): a plan's ``("model", "pod")`` on ``("pod", "data", "model")``
    then gives every rank a block of the same shape, and issues the same
    collectives, with the blocks assigned to other ranks than the
    reference's ``P(("model", "pod"))`` assigns them."""
    order = {a: i for i, a in enumerate(mesh_sizes(mesh))}
    return tuple(entry_of(sorted(entry_axes(e), key=order.__getitem__))
                 for e in spec)


def local_block(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``: each
    entry's axes split its dim major to minor, as ``placements`` nests
    them."""
    sizes = mesh_sizes(mesh)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            if sizes[a] > 1:
                n = x.shape[d] // sizes[a]
                x = x.narrow(d, mesh.coord[a] * n, n)
    return x


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(s)
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, mesh, spec: Sequence, shape,
         partial: Sequence[tuple[str, str]] = ()) -> DTensor:
    """The DTensor whose block on this rank is ``local`` (no collective).
    ``partial`` marks a block the executor computes forward only:
    ``from_local`` would hand a Partial block's gradient back divided
    among the ranks.  ``spec``'s entries nest in mesh order (``nested``)."""
    return DTensor.from_local(local, mesh.dmesh,
                              placements(nested(spec, mesh), mesh, partial),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(x, mesh, spec: Sequence) -> DTensor:
    """Place a global tensor that every rank holds: each rank keeps its
    block (a local slice — no scatter, no collective).  ``spec``'s entries
    nest in mesh order (``nested``)."""
    spec = nested(spec, mesh)
    x = torch.as_tensor(x)
    if x.device != mesh.device:
        x = x.to(mesh.device)
    block = local_block(x, spec, mesh)
    if block.numel() != x.numel():  # a copy: the whole tensor can go
        block = block.clone(memory_format=torch.contiguous_format)
    return wrap(block, mesh, spec, x.shape)


def constrain(x, mesh, spec: Sequence):
    """The counterpart of ``with_sharding_constraint``: ``x`` (a DTensor)
    redistributed to ``spec``'s placements; DTensor chooses the
    collectives; ``spec``'s entries nest in mesh order (``nested``).  A
    plain tensor is returned as it is (one rank)."""
    if not isinstance(x, DTensor):
        return x
    want = placements(nested(spec, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh.dmesh, want)


def full(x):
    """The whole tensor on every rank (``full_tensor``); a plain tensor
    as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def spec_of_placements(pl: Sequence, ndim: int, mesh) -> tuple:
    """The spec of ``ndim``-d placements ``pl`` of ``Shard``/``Replicate``
    (shards nested in mesh order); raises on a ``Partial`` or strided
    placement."""
    entries: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.axis_names, pl):
        if p.is_partial() or (p.is_shard() and type(p) is not Shard):
            raise NotImplementedError(f"spec_of_placements: {p} on {name!r}")
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(entry_of(e) for e in entries)


def replicate_like(t: torch.Tensor, ref):
    """``t`` as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor (a constant the model builds beside DTensor activations:
    RoPE angles, masks); ``t`` itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def splits_contraction(x, w) -> bool:
    """Whether ``x @ w`` contracts a dim that ``x`` or ``w`` holds sharded
    (``x``'s last dim, ``w``'s second to last), so that the product comes
    out as partial blocks."""
    def sharded(t, dim):
        return isinstance(t, DTensor) and any(
            p.is_shard() and p.dim == dim % t.ndim for p in t.placements)

    return sharded(x, -1) or sharded(w, -2 if w.ndim > 1 else 0)


def local_einsum(eq: str, x: DTensor, w) -> DTensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (a DTensor) and a
    weight ``w`` (a DTensor, or a tensor whole on every rank), computed on
    local blocks by one rule for each mesh axis:

      * the axis splits a label of ``x`` that the output keeps: the output
        is split there too, and ``w`` is gathered along the axis where it
        is split;
      * it splits a label of ``x`` that is contracted: ``w`` is taken in the
        same blocks (a local slice where it is whole, redistributed where
        it is split otherwise), and the blocks' products are partial sums;
      * it splits only ``w``: a label the output keeps splits the output; a
        contracted one takes ``x`` in the same blocks, partial sums again;
      * otherwise both are whole along it.

    Where the axis splits both, along different labels, the operand that
    costs fewer bytes moves: ``w`` gathered (``k`` of its blocks on an axis
    of ``k`` ranks, also what a backward's reduce-scatter of its gradient
    moves), or ``x`` — re-split along ``w``'s contracted label (one block
    by all-to-all; the output's partial sums, ``k`` output blocks, are then
    reduce-scattered back into ``x``'s layout), or gathered where ``w``'s
    label is kept (``k`` blocks, which a backward holds, and one output
    block left in ``w``'s layout for the next op to move back).  A
    data-parallel step of large batches gathers its weights; a small batch
    of the same step, and a decode step, move the activation instead.

    Partial sums are reduced over their axes before the product returns —
    in float32 for a low-precision product, rounded once, as a one-rank
    product accumulates in float32 (DTensor would round every block to
    bf16 first).  Each operand's gradient block is its own, or partial
    where the other operand split the output.  Labels are single letters,
    no ellipsis.  DTensor's own placement of a product flattens the batch
    dims and the weight's output dims into one, which no abstract tensor
    passes where several axes split them (a strided shard) and which fails
    outright on some plans of a three-axis mesh (the model dim and the kv
    heads on ``pod``)."""
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    mesh = x.device_mesh
    n = mesh.ndim
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * n, run_check=False)
    sizes = dict(zip(xl, x.shape)) | dict(zip(wl, w.shape))
    labels = [(xl[px.dim] if px.is_shard() else None, wl[pw.dim] if pw.is_shard() else None)
              for px, pw in zip(x.placements, w.placements)]
    x_bytes = x.to_local().numel() * x.element_size()
    w_bytes = w.to_local().numel() * w.element_size()
    y_bytes = math.prod(sizes[l] for l in out) * x.element_size() // math.prod(
        k for k, (lx, lw) in zip(mesh.shape, labels) if {lx, lw} & set(out))
    x_to, w_to, out_pl, y_to, gx, gw = [], [], [], [], [], []
    for k, (px, pw), (lx, lw) in zip(mesh.shape, zip(x.placements, w.placements), labels):
        keep = Shard(out.index(lx)) if lx and lx in out else Replicate()  # x's layout
        if lx is not None and lw not in (None, lx) and (
                (k * x_bytes if lw in out else x_bytes) + k * y_bytes < k * w_bytes):
            lx = None  # the blocks disagree and x moves for fewer bytes
        if lx is not None and lx in out:
            x_to.append(px), w_to.append(Replicate())
            out_pl.append(Shard(out.index(lx)))
            gx.append(px), gw.append(Partial())
        elif lx is not None:
            x_to.append(px), w_to.append(Shard(wl.index(lx)))
            out_pl.append(Partial())
            gx.append(px), gw.append(w_to[-1])
        elif lw is not None and lw in out:
            x_to.append(Replicate()), w_to.append(pw)
            out_pl.append(Shard(out.index(lw)))
            gx.append(Partial()), gw.append(pw)
        elif lw is not None and lw in xl:
            x_to.append(Shard(xl.index(lw))), w_to.append(pw)
            out_pl.append(Partial())
            gx.append(x_to[-1]), gw.append(pw)
        else:
            x_to.append(Replicate()), w_to.append(Replicate())
            out_pl.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
        y_to.append(keep if out_pl[-1].is_partial() else out_pl[-1])
    if list(x.placements) != x_to:
        x = x.redistribute(mesh, x_to)
    if list(w.placements) != w_to:
        w = w.redistribute(mesh, w_to)
    xb, wb = x.to_local(grad_placements=gx), w.to_local(grad_placements=gw)
    partial = any(p.is_partial() for p in out_pl)
    dtype = x.dtype
    if partial and dtype != torch.float32:
        xb, wb = xb.float(), wb.float()
    y = torch.einsum(eq, xb, wb)
    shape = tuple(sizes[l] for l in out)
    y = DTensor.from_local(y, mesh, out_pl, run_check=False,
                           shape=torch.Size(shape), stride=_contiguous_stride(shape))
    if partial:
        y = y.redistribute(mesh, y_to)
    return y.to(dtype)


def matmul(x, w):
    """``x @ w``: on a DTensor ``x``, ``local_einsum`` of ``x``'s dims and
    the weight's (partial sums reduced, in float32 for a low-precision
    product); otherwise ``torch.matmul``."""
    if not isinstance(x, DTensor):
        return torch.matmul(x, w)
    lab = "bcdefg"[:x.ndim - 1]
    return local_einsum(f"{lab}k,kn->{lab}n", x, w)


def local_param(w, mesh, spec: Sequence, over: Sequence[str] = ()):
    """This rank's block of a weight ``w`` (a DTensor; a plain tensor is
    returned as it is) redistributed to ``spec``, for a computation whose
    blocks are split over the mesh axes ``over`` (the batch rows of a
    recurrent scan, or the expert blocks of a MoE layer): each rank's
    gradient of the block is then one share of the whole gradient, and it
    is declared a partial sum over ``over`` (whole along the other axes),
    which the redistribution back to ``w``'s placements reduces."""
    if not isinstance(w, DTensor):
        return w
    spec = nested(spec, mesh)
    w = constrain(w, mesh, spec)
    held = {a for e in spec for a in entry_axes(e)}
    return w.to_local(grad_placements=placements(
        spec, mesh, [(a, "sum") for a in over if a not in held]))


def run_local(fn: Callable, args: Sequence, specs: Sequence[tuple],
              out_spec, mesh):
    """``fn`` on this rank's blocks: each DTensor argument redistributed to
    its spec, ``fn`` run on the local tensors, its result wrapped under
    ``out_spec`` (a tuple of specs where ``fn`` returns a tuple) with the
    global shape it has on the whole tensors — the treatment of an op
    DTensor cannot propagate (a kernel, a masked softmax).  ``fn`` must be
    local under those specs: the block of its output is its value on the
    blocks of its inputs."""
    local = [constrain(a, mesh, s).to_local() for a, s in zip(args, specs)]
    out = fn(*local)
    if isinstance(out, (tuple, list)):
        return tuple(wrap_block(o, mesh, s) for o, s in zip(out, out_spec))
    return wrap_block(out, mesh, out_spec)


def run_rows(fn: Callable, params, x, state, mesh, rows):
    """``fn(params, x, state) -> (out, new state)`` of a block whose rows
    are independent (a recurrent scan runs along the sequence of each batch
    row) on this rank's batch rows: ``rows`` is the spec entry splitting
    dim 0 of ``x``, ``state`` (a tree, or None) and the results.  ``x``
    and ``state`` (DTensors) are redistributed to rows split and the rest
    whole; the parameters (a tree) are whole on every rank, each rank's
    gradient a share summed over the rows' axes (``local_param``); ``fn``
    runs on plain local tensors — no DTensor dispatch inside, which a
    per-position Python loop could not afford — and its output and new
    state come back as DTensors of row blocks."""
    from repro_torch.core import tree

    def spec(t):
        return (rows,) + (None,) * (t.ndim - 1)

    axes = entry_axes(rows)
    xl = constrain(x, mesh, spec(x)).to_local()
    pl = tree.map(lambda w: local_param(w, mesh, (None,) * w.ndim, axes), params)
    sl = tree.map(lambda t: constrain(t, mesh, spec(t)).to_local(), state)
    out, new = fn(pl, xl, sl)
    return (wrap_block(out, mesh, spec(out)),
            tree.map(lambda t: wrap_block(t, mesh, spec(t)), new))


def wrap_block(block: torch.Tensor, mesh, spec,
               partial: Sequence[tuple[str, str]] = ()) -> DTensor:
    """``wrap`` with the global shape read off the block and the spec."""
    shape = list(block.shape)
    sizes = mesh_sizes(mesh)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            shape[d] *= sizes[a]
    return wrap(block, mesh, spec, shape, partial)


def psum(block: torch.Tensor, mesh, axes: Sequence[str], spec: Sequence = ()):
    """The sum of this rank's ``block`` over the ranks along ``axes``, on
    each of them (one all-reduce; ``spec`` places the block's leading dims
    along other axes).  Its gradient reaches each rank's block with weight
    one."""
    if not axes:
        return block
    spec = tuple(spec) + (None,) * (block.ndim - len(spec))
    part = wrap_block(block.unsqueeze(0), mesh, (entry_of(axes),) + spec)
    return constrain(torch.sum(part, dim=0), mesh, spec).to_local()


def _exchange(x, out_sizes, in_sizes, group: str, stage: bool):
    fc = torch.ops._c10d_functional
    dev = x.device
    x = x.contiguous()
    if stage:
        x = x.cpu()
    return fc.wait_tensor(fc.all_to_all_single(x, out_sizes, in_sizes, group)).to(dev)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_sizes, in_sizes, group, stage):
        ctx.back = (in_sizes, out_sizes, group, stage)
        return _exchange(x, out_sizes, in_sizes, group, stage)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, *ctx.back),) + (None,) * 4


def all_to_all(x: torch.Tensor, out_sizes: Sequence[int],
               in_sizes: Sequence[int], mesh, axes: Sequence[str]):
    """Rows of a local block exchanged over ``mesh``'s group on ``axes``
    (mesh order): the ``in_sizes[i]`` rows after the first ``sum(in_sizes[:i])``
    go to the rank at linear index ``i`` along ``axes``, and ``out_sizes[j]``
    rows come back from the rank at index ``j``.  One functional
    ``all_to_all_single`` (what ``CommLog`` and the dry run's recorder
    count); its backward is the exchange the other way.  gloo ranks
    holding CUDA blocks stage them through the host, as their all-gathers
    are (``launch.mesh.stage_all_gather``)."""
    import torch.distributed as dist

    stage = x.device.type == "cuda" and dist.get_backend() == "gloo"
    return _AllToAll.apply(x, [int(n) for n in out_sizes],
                           [int(n) for n in in_sizes],
                           mesh.group(axes).group_name, stage)


# ---------------------------------------------------------------------------
# What DTensor issued
# ---------------------------------------------------------------------------

#: functional collectives DTensor issues, by the kind names of
#: ``spmd.CollectiveTrace``
_KINDS = {"all_gather_into_tensor": "all_gather",
          "reduce_scatter_tensor": "reduce_scatter",
          "all_reduce": "all_reduce",
          "all_to_all_single": "all_to_all"}


class CommLog(CommDebugMode):
    """``CommDebugMode`` that also sums, per kind, the bytes of the buffer
    each collective was handed on this rank.  ``counts`` and ``bytes`` are
    keyed by kind (``all_gather``, ``reduce_scatter``, ``all_reduce``,
    ``all_to_all``)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.bytes: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace == "_c10d_functional":
            t = args[0]
            self.counts[kind] += 1
            self.bytes[kind] += t.numel() * t.element_size()
        return super().__torch_dispatch__(func, types, args, kwargs)


# ---------------------------------------------------------------------------
# The graph executor
# ---------------------------------------------------------------------------


@dataclass
class NodeStep:
    """One node of the executor's static program: the specs its inputs
    are redistributed to, the spec (and partial axes) of the block it
    computes locally, the planned spec it is constrained to, and for
    opaque nodes the shard rule's local program."""

    nid: int
    arg_specs: list[tuple] = field(default_factory=list)
    local_spec: tuple = ()
    partial: tuple[tuple[str, str], ...] = ()
    out_spec: tuple = ()
    run: Callable | None = None
    rule: str = ""


#: the DTensor ``Partial`` reduction of each aggregation
_PARTIAL_AGGS = {"sum": "sum", "max": "max", "min": "min", "prod": "product"}

#: opaque shard rules whose local program issues no collective of its own
_LOCAL_RULES = ("local", "paged")


def _layout_spec(layout) -> tuple:
    return tuple(entry_of(axes) for axes in layout)


def _opaque_step(g: EinGraph, n: Node, ax_n: dict, sizes: dict) -> NodeStep:
    from repro_torch.core import opaque_rules

    rule_name = opaque_rules.resolve_rule_name(n)
    low = None
    if rule_name == "ring":
        # the ring label unsharded: one local flash call per rank on its
        # batch and head blocks (the sequence is gathered by DTensor)
        from repro_torch.core import opdef

        ring = {c["label"] for c in opdef.comm_for_node(n)
                if c.get("kind") == "ring"}
        ax_local = {l: a for l, a in ax_n.items() if l not in ring}
        low = opaque_rules.RULES["ring"].lower(g, n, ax_local, sizes)
    elif rule_name in _LOCAL_RULES or rule_name == "a2a":
        # the a2a rule's program issues its own collectives through the
        # runner's ``spmd.StepContext``; its axes are in mesh order (every
        # spec here is), so its blocks nest as DTensor's, and its
        # collectives run over the mesh's one group spanning them
        low = opaque_rules.RULES[rule_name].lower(g, n, ax_n, sizes)
    if low is None:
        # no local lowering: the op declares no rule, its rule's
        # preconditions fail under this assignment, or the rule is not a
        # built-in one — run it whole on every rank (``spmd``'s fallback)
        rule_name = "replicate"
        low = opaque_rules.RULES["replicate"].lower(g, n, ax_n, sizes)
    step = NodeStep(nid=n.nid, rule=rule_name)
    step.arg_specs = [_layout_spec(lay) for lay in low.arg_layouts]
    # the block the rule's program returns: its output layout before the
    # local slices of its post steps, which the constraint to the planned
    # spec takes instead
    sliced = {(st[2], st[1]) for st in low.post_steps if st[0] == "slice"}
    step.local_spec = tuple(
        entry_of([a for a in axes if (d, a) not in sliced])
        for d, axes in enumerate(low.out_layout))
    step.run = low.run
    return step


def build_program(g: EinGraph, plan, mesh_axes: dict[str, int]
                  ) -> list[NodeStep]:
    """The executor's static program for a mesh-mode plan, in node order:
    pure Python over the graph, the plan and the mesh shape.  A plan entry
    whose axes are out of mesh order is placed nested in mesh order
    (``nested``)."""
    if plan is None or plan.mode != "mesh":
        raise ValueError("gspmd on a mesh of more than one rank needs a "
                         "mesh-mode plan (plan with mesh_axes)")
    sizes = {a: int(s) for a, s in mesh_axes.items()}
    order = {a: i for i, a in enumerate(sizes)}

    def axes_of(nid: int) -> dict:
        return {l: tuple(sorted(axes, key=lambda a: order.get(a, len(order))))
                for l, axes in plan.axes_by_node.get(nid, {}).items()}

    steps: list[NodeStep] = []
    for n in g.nodes:
        ax_n = axes_of(n.nid)
        out_spec = spec_of(n.labels, ax_n)
        if n.kind == "input":
            step = NodeStep(nid=n.nid, local_spec=out_spec)
        elif n.kind == "map":
            # elementwise on the local block: its input's planned spec
            src = spec_of(g.nodes[n.inputs[0]].labels, axes_of(n.inputs[0]))
            step = NodeStep(nid=n.nid, arg_specs=[src], local_spec=src)
        elif n.kind == "einsum":
            spec = n.spec
            step = NodeStep(nid=n.nid,
                            arg_specs=[spec_of(ls, ax_n)
                                       for ls in spec.in_labels],
                            local_spec=out_spec)
            step.partial = tuple(
                (a, _PARTIAL_AGGS[spec.agg]) for l in spec.agg_labels
                for a in ax_n.get(l, ()) if sizes.get(a, 1) > 1)
        else:
            step = _opaque_step(g, n, ax_n, sizes)
        step.out_spec = out_spec
        steps.append(step)
    for st in steps:  # every spec must be placeable before anything runs
        for s in st.arg_specs + [st.local_spec, st.out_spec]:
            placements(s, sizes)
    return steps


class GspmdRunner:
    """``f(*global_inputs) -> tuple(global outputs)`` on every rank of
    ``mesh``.  Each rank is handed the global inputs and keeps its blocks
    (``distribute``); every node computes on local blocks and is
    constrained to its planned placements; the outputs come back whole on
    every rank, as the reference returns global arrays.  With
    ``log_comms`` set, ``comms`` is the ``CommLog`` of the last call;
    ``issued`` lists the collectives the shard rules' own programs issued
    in it (the ``a2a`` rule's), as ``spmd.StepContext.issued`` does."""

    def __init__(self, g: EinGraph, plan, mesh, out_ids: Sequence[int],
                 donate: Sequence[int] = ()):
        from repro_torch.core.engine import mesh_axes_dict

        self.graph = g
        self.plan = plan
        self.mesh = mesh
        self.out_ids = list(out_ids)
        self.donate = tuple(donate)
        self.program = build_program(g, plan, mesh_axes_dict(mesh))
        self.log_comms = False
        self.comms: CommLog | None = None
        self.issued: list[tuple] = []

    def __call__(self, *arrays):
        if not self.log_comms:
            return self._run(arrays)
        with CommLog() as log:
            outs = self._run(arrays)
        self.comms = log
        return outs

    def run_nodes(self, feeds: dict[int, Any], keep: set[int]) -> dict[int, Any]:
        """Every node ``keep`` depends on, placed; returns ``keep``'s values
        as DTensors (the others are dropped after their last reader, the
        donated feeds' storage freed: ``engine.drop``)."""
        from repro_torch.core import spmd
        from repro_torch.core.engine import (MAP_FNS, donatable, drop,
                                             live_nodes, mesh_axes_dict)

        g, mesh = self.graph, self.mesh
        donated = donatable(feeds, self.donate, keep)
        live = live_nodes(g, keep)
        frees = spmd._last_uses(g, live)
        ctx = spmd.StepContext(mesh, mesh_axes_dict(mesh))
        vals: dict[int, Any] = {}
        for nid in g.topo_order():
            if nid not in live:
                continue
            n, st = g.nodes[nid], self.program[nid]
            if n.kind == "input":
                vals[nid] = distribute(feeds[nid], mesh, st.out_spec)
                continue
            args = [constrain(vals[a], mesh, s).to_local()
                    for a, s in zip(n.inputs, st.arg_specs)]
            if n.kind == "einsum":
                v = spmd.local_einsum(n.spec, *args)
            elif n.kind == "map":
                v = MAP_FNS[n.op](args[0], **n.params)
            else:
                ctx.nid = nid
                v = st.run(args, ctx)
            del args
            v = wrap(v, mesh, st.local_spec, n.shape, st.partial)
            vals[nid] = constrain(v, mesh, st.out_spec)
            for a in frees.get(nid, ()):
                if a not in keep:
                    drop(vals, a, donated)
        self.issued = ctx.issued
        return {k: vals[k] for k in keep}

    def _run(self, arrays):
        feeds = dict(zip(self.graph.input_ids(), arrays))
        vals = self.run_nodes(feeds, set(self.out_ids))
        return tuple(full(vals[o]) for o in self.out_ids)


def comm_summary(log: CommLog) -> dict[str, dict[str, int]]:
    """{kind: {"count", "bytes"}} from a ``CommLog``."""
    return {k: {"count": int(log.counts[k]), "bytes": int(log.bytes[k])}
            for k in sorted(log.counts)}


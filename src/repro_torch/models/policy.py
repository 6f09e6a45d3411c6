"""ShardingPolicy: the bridge from an EinDecomp plan to per-tensor layouts.

The model stack is written against *canonical labels*:

    b batch   s sequence   t kv-cache time   a d_model   h q-heads
    k kv-heads   d head_dim   f ffn hidden   v vocab   e experts
    c expert capacity   n ssm state   L layer stack

EinDecomp (mesh mode) assigns whole mesh axes to labels per node; a policy
collapses that to one label->axes map (majority vote across nodes — the
per-node plan is exact in the engine path, the policy is the production
projection of it).

``act_spec`` / ``param_spec`` return plain tuples, one entry per dim
(``None`` = unsharded, an axis name, or a tuple of axis names) — the
reference's PartitionSpecs without jax.  ``sharding`` turns one into
DTensor placements on a mesh (``core/gspmd.placements``), the reference's
``NamedSharding``; ``safe_spec`` drops the axes that do not divide a dim.

``fsdp_axes`` additionally shards *parameters only* along a feature dim
over the data axis (ZeRO-3 style storage sharding, all-gathered at use).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field


@dataclass
class ShardingPolicy:
    label_axes: dict[str, tuple[str, ...]] = field(default_factory=dict)
    fsdp_axes: tuple[str, ...] = ()     # extra param-only axes (on label 'a'/'v')
    remat: bool = True

    # -- spec construction ---------------------------------------------------

    def _axes(self, label: str) -> tuple[str, ...]:
        if label == "t":  # cache time inherits sequence sharding
            return self.label_axes.get("t", self.label_axes.get("s", ()))
        return self.label_axes.get(label, ())

    def act_spec(self, labels: str) -> tuple:
        """Per-dim mesh axes for an activation with the given label string."""
        entries = []
        used: set[str] = set()
        for l in labels.split():
            ax = tuple(a for a in self._axes(l) if a not in used)
            used.update(ax)
            entries.append(_entry(ax))
        return tuple(entries)

    def param_spec(self, labels: str) -> tuple:
        """Per-dim mesh axes for a parameter; fsdp axes land on the first
        otherwise-unsharded feature dim (f, h, v, ...), 'a' last."""
        entries = []
        used: set[str] = set()
        lab = labels.split()
        for l in lab:
            ax = tuple(a for a in self._axes(l) if a not in used)
            used.update(ax)
            entries.append(list(ax))
        if self.fsdp_axes:
            free = [a for a in self.fsdp_axes if a not in used]
            if free:
                # prefer OUTPUT/feature dims over the contraction dim 'a':
                # sharding 'a' reshards the (huge) activation to produce the
                # weight gradient, feature-dim sharding only all-gathers the
                # (small) weight
                for pick in ("f", "h", "v", "k", "d", "e", "c", "a"):
                    if pick in lab and not entries[lab.index(pick)]:
                        entries[lab.index(pick)].extend(free)
                        break
        return tuple(_entry(tuple(e)) for e in entries)

    def sharding(self, mesh, labels: str, shape=None, *,
                 param: bool = False) -> tuple:
        """DTensor placements (one per mesh axis) for a tensor with
        ``labels`` on ``mesh`` (a ``launch.mesh.Mesh`` or ``{axis: size}``):
        the parameter spec with ``param``, else the activation spec, made
        safe for ``shape`` where it is given, an entry on several axes
        nested in mesh order (``gspmd.nested``), as the model stack places
        its tensors."""
        from repro_torch.core.gspmd import nested, placements

        spec = self.param_spec(labels) if param else self.act_spec(labels)
        if shape is not None:
            spec = safe_spec(spec, shape, mesh)
        return placements(nested(spec, mesh), mesh)


def _entry(ax: tuple[str, ...]):
    if not ax:
        return None
    return ax[0] if len(ax) == 1 else tuple(ax)


def safe_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes that do not divide the corresponding dim (divisibility
    guard: e.g. 25 heads on a 16-way axis)."""
    from repro_torch.core.gspmd import mesh_sizes

    sizes = mesh_sizes(mesh)
    spec = tuple(spec)
    out = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = []
        d = int(dim)
        for a in axes:
            if d % sizes[a] == 0:
                keep.append(a)
                d //= sizes[a]
        out.append(_entry(tuple(keep)))
    return tuple(out)


def batch_entry(policy, mesh, batch: int):
    """The spec entry of the batch dim of a ``batch``-row activation under
    ``policy`` on ``mesh`` (its ``b`` axes that divide ``batch``)."""
    return safe_spec((policy.act_spec("b")[0],), (batch,), mesh)[0]


# ---------------------------------------------------------------------------
# Plan -> policy
# ---------------------------------------------------------------------------


def policy_from_plan(plan, graph=None, *, fsdp_axes: tuple[str, ...] = (),
                     remat: bool = True) -> ShardingPolicy:
    """Collapse a mesh-mode plan's per-node label->axes maps to one policy.

    Votes are weighted by node output size (big tensors should keep their
    plan-chosen sharding), then resolved *per mesh axis* so one axis serves
    exactly one label globally — the per-node plan is exact in the engine
    path; the policy is its consistent production projection.
    """
    sizes: dict[int, float] = {}
    if graph is not None:
        for n in graph.nodes:
            numel = 1
            for s in n.shape:
                numel *= int(s)
            sizes[n.nid] = float(numel)
    votes: dict[str, Counter] = {}
    for nid, ax_map in plan.axes_by_node.items():
        w = sizes.get(nid, 1.0)
        for label, axes in ax_map.items():
            votes.setdefault(label, Counter())[tuple(sorted(axes))] += w
    label_axes: dict[str, tuple[str, ...]] = {}
    for label, ctr in votes.items():
        best = max(ctr.items(), key=lambda kv: (kv[1], len(kv[0])))[0]
        if best:
            label_axes[label] = best
    # two labels may share an axis only if they never co-occur in a tensor;
    # act_spec/param_spec dedupe per-tensor (first label keeps the axis).
    return ShardingPolicy(label_axes=label_axes, fsdp_axes=fsdp_axes,
                          remat=remat)


def manual_policy(assignments: dict[str, str | tuple[str, ...]], *,
                  fsdp_axes: tuple[str, ...] = (), remat: bool = True
                  ) -> ShardingPolicy:
    """Hand-written policy (the paper's §9 baselines: megatron = {'h': model,
    'f': model, 'v': model, 'b': data}; sequence = {'s': model, ...})."""
    la = {}
    for l, ax in assignments.items():
        la[l] = (ax,) if isinstance(ax, str) else tuple(ax)
    return ShardingPolicy(label_axes=la, fsdp_axes=fsdp_axes, remat=remat)

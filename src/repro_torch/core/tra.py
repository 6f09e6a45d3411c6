"""Tensor relations and the tensor-relational algebra (paper §4).

A *tensor relation* stores a tensor ``R`` with bound vector ``b`` as a set of
keyed sub-tensors, controlled by a *partitioning vector* ``d``:

    R : I(d)  ->  ( I(b/d) -> float )

i.e. a dict mapping partition keys (tuples in I(d)) to numpy blocks of shape
b/d.  The TRA has three operations — *join* (kernel calls on key-matched
sub-tensor pairs), *aggregation* (⊕-reduce over contracted key dims), and
*repartition* — and the §4.3 rewrite turns any EinSum node plus a
partitioning vector ``d`` into join→agg.

This module is the **reference runtime**: a faithful, pure-numpy
implementation of the paper's abstraction, used (a) as the oracle for the
equivalence property tests, (b) to count kernel calls and transfers for the
paper-figure benchmarks.  Map and opaque nodes run through the op
registry's dense impls (core/opdef.py).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.einsum import COMBINE1, COMBINE2, EinSpec, eval_einsum_dense

# ---------------------------------------------------------------------------
# Partitioning-vector helpers (the b[l1; l2] projection of §3)
# ---------------------------------------------------------------------------


def project(vec: Sequence[int], onto: Sequence[str], frm: Sequence[str]) -> tuple[int, ...]:
    """``vec[onto; frm]`` — for each label in ``onto`` pick the entry of
    ``vec`` at the first position of that label in ``frm`` (§3)."""
    out = []
    for l in onto:
        out.append(vec[list(frm).index(l)])
    return tuple(out)


def label_parts(d_by_label: dict[str, int], labels: Sequence[str]) -> tuple[int, ...]:
    """Partitioning vector for a tensor with the given labels."""
    return tuple(d_by_label[l] for l in labels)


# ---------------------------------------------------------------------------
# TensorRelation
# ---------------------------------------------------------------------------


@dataclass
class TensorRelation:
    """A tensor stored as keyed sub-tensors (paper §4.1)."""

    bound: tuple[int, ...]
    parts: tuple[int, ...]  # d — partition count along each dimension
    blocks: dict[tuple[int, ...], np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        assert len(self.bound) == len(self.parts)
        for b, d in zip(self.bound, self.parts):
            if d <= 0 or b % d != 0:
                raise ValueError(f"parts {self.parts} do not divide bound {self.bound}")

    @property
    def block_shape(self) -> tuple[int, ...]:
        return tuple(b // d for b, d in zip(self.bound, self.parts))

    def keys(self):
        return itertools.product(*[range(d) for d in self.parts])

    @property
    def n_blocks(self) -> int:
        return int(np.prod(self.parts)) if self.parts else 1

    # -- conversion ---------------------------------------------------------

    @classmethod
    def from_dense(cls, arr: np.ndarray, parts: Sequence[int]) -> "TensorRelation":
        arr = np.asarray(arr)
        parts = tuple(int(p) for p in parts)
        tr = cls(tuple(arr.shape), parts)
        bs = tr.block_shape
        for key in tr.keys():
            sl = tuple(slice(k * s, (k + 1) * s) for k, s in zip(key, bs))
            tr.blocks[key] = arr[sl]
        return tr

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.bound, dtype=next(iter(self.blocks.values())).dtype)
        bs = self.block_shape
        for key, blk in self.blocks.items():
            sl = tuple(slice(k * s, (k + 1) * s) for k, s in zip(key, bs))
            out[sl] = blk
        return out

    # -- the three TRA operators --------------------------------------------

    def repartition(self, new_parts: Sequence[int]) -> "TensorRelation":
        """Π_d (§4.2): same tensor, different slicing.  Reference impl goes
        through dense; a real runtime moves only the overlapping pieces."""
        return TensorRelation.from_dense(self.to_dense(), new_parts)


def tra_join(
    x: TensorRelation,
    y: TensorRelation,
    lx: Sequence[str],
    ly: Sequence[str],
    kernel: Callable[[np.ndarray, np.ndarray], np.ndarray],
    out_labels: Sequence[str],
    out_block_shape: tuple[int, ...],
) -> tuple["KeyedSet", int]:
    """⋈_{K,ℓX,ℓY} (§4.2).  Returns the joined keyed set (keys over
    ℓX ⊙ ℓY) and the number of kernel calls performed."""
    joined = ld_concat(lx, ly)
    out: dict[tuple[int, ...], np.ndarray] = {}
    calls = 0
    for kxe in x.blocks:
        for kye in y.blocks:
            ok = True
            for i, l in enumerate(lx):
                if l in ly and kxe[i] != kye[list(ly).index(l)]:
                    ok = False
                    break
            if not ok:
                continue
            # natural-join key over ℓX ⊙ ℓY
            kv = dict(zip(lx, kxe))
            kv.update(dict(zip(ly, kye)))
            key = tuple(kv[l] for l in joined)
            out[key] = kernel(x.blocks[kxe], y.blocks[kye])
            calls += 1
    return KeyedSet(tuple(joined), out), calls


def tra_aggregate(
    rel: "KeyedSet",
    agg_labels: Sequence[str],
    agg_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
) -> "KeyedSet":
    """Σ_{⊕,ℓ,ℓagg} (§4.2): group keys on labels ∉ ℓagg, ⊕-reduce tensors."""
    keep = [l for l in rel.labels if l not in agg_labels]
    groups: dict[tuple[int, ...], np.ndarray] = {}
    for key, blk in rel.blocks.items():
        gk = tuple(k for k, l in zip(key, rel.labels) if l in keep)
        if gk in groups:
            groups[gk] = agg_fn(groups[gk], blk)
        else:
            groups[gk] = blk
    return KeyedSet(tuple(keep), groups)


@dataclass
class KeyedSet:
    """An intermediate tensor relation whose keys are labeled (join output)."""

    labels: tuple[str, ...]
    blocks: dict[tuple[int, ...], np.ndarray]

    def to_relation(self, labels_order: Sequence[str], bound: Sequence[int]) -> TensorRelation:
        order = [self.labels.index(l) for l in labels_order]
        some = next(iter(self.blocks.values()))
        parts = []
        for i, l in enumerate(labels_order):
            keys_along = {k[order[i]] for k in self.blocks}
            parts.append(max(keys_along) + 1)
        tr = TensorRelation(tuple(bound), tuple(parts))
        for key, blk in self.blocks.items():
            tr.blocks[tuple(key[o] for o in order)] = blk
        return tr


def ld_concat(lx: Sequence[str], ly: Sequence[str]) -> list[str]:
    """ℓX ⊙ ℓY — concatenation, dropping duplicates (§4.3)."""
    seen = list(lx)
    for l in ly:
        if l not in seen:
            seen.append(l)
    return seen


# ---------------------------------------------------------------------------
# EinSum → TRA rewrite (§4.3): execute one EinSum node under a partitioning d
# ---------------------------------------------------------------------------


def make_kernel(spec: EinSpec) -> Callable:
    """The kernel function K of §4.3: evaluates the *inner* EinSum on
    sub-tensors (one pl/MKL/XLA kernel call in a real runtime)."""

    def k2(bx: np.ndarray, by: np.ndarray) -> np.ndarray:
        return eval_einsum_dense(spec, bx, by)

    def k1(bx: np.ndarray) -> np.ndarray:
        return eval_einsum_dense(spec, bx)

    return k2 if len(spec.in_labels) == 2 else k1


_AGG_PAIR = {
    "sum": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
    "prod": lambda a, b: a * b,
}


def execute_einsum_tra(
    spec: EinSpec,
    d_by_label: dict[str, int],
    *inputs: TensorRelation,
) -> tuple[TensorRelation, dict]:
    """Execute Z ← ⊕ ⊗(X, Y) as join→aggregate per §4.3.

    ``d_by_label`` maps each unique label to its partition count (entries of
    the paper's d vector, co-partitioned labels already merged).  Inputs must
    already be partitioned compatibly (``d[l_X; l_XY]`` etc.); callers use
    ``TensorRelation.repartition`` first if not.

    Returns the output relation (partitioned by ``d[l_Z; l_XY]``) and a stats
    dict with kernel-call and tuple counts for the figures.
    """
    for ls, rel in zip(spec.in_labels, inputs):
        want = label_parts(d_by_label, ls)
        if rel.parts != want:
            raise ValueError(f"input partitioned {rel.parts}, want {want} for labels {ls}")

    kernel = make_kernel(spec)
    out_block = None
    stats: dict = {}

    if len(inputs) == 2:
        x, y = inputs
        lx, ly = spec.in_labels
        joined, calls = tra_join(x, y, lx, ly, kernel, spec.out_labels, out_block)
        stats["kernel_calls"] = calls
        agged = tra_aggregate(joined, spec.agg_labels, _AGG_PAIR[spec.agg or "sum"])
    else:
        (lx,) = spec.in_labels
        x = inputs[0]
        blocks = {}
        for key, blk in x.blocks.items():
            blocks[key] = kernel(blk)
        stats["kernel_calls"] = len(blocks)
        agged = tra_aggregate(KeyedSet(tuple(lx), blocks), spec.agg_labels,
                              _AGG_PAIR[spec.agg or "sum"])

    out_bound = []
    # bound of output = product over labels (taken from inputs)
    bounds: dict[str, int] = {}
    for ls, rel in zip(spec.in_labels, inputs):
        for l, b in zip(ls, rel.bound):
            bounds[l] = b
    out_bound = [bounds[l] for l in spec.out_labels]
    out = agged.to_relation(spec.out_labels, out_bound)
    stats["out_blocks"] = out.n_blocks
    return out, stats


# ---------------------------------------------------------------------------
# Whole-graph TRA execution under a plan {node -> d_by_label}
# ---------------------------------------------------------------------------


def execute_graph_tra(
    g,
    plan: dict[int, dict[str, int]],
    feeds: dict[int, np.ndarray],
) -> tuple[dict[int, TensorRelation], dict]:
    """Execute an EinGraph in the TRA reference runtime.

    ``plan[nid]`` is the d_by_label map for node nid (einsum nodes).  Input
    nodes take their partitioning from their first consumer's requirement.
    map/opaque nodes run densely (reference semantics only).  Returns node
    values as TensorRelations plus aggregate stats (kernel calls,
    repartitions performed).
    """
    from repro_torch.core.einsum import EinGraph  # noqa: F401 (typing only)

    vals: dict[int, TensorRelation] = {}
    stats = {"kernel_calls": 0, "repartitions": 0}

    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind == "input":
            d = plan.get(nid)
            parts = label_parts(d, n.labels) if d else tuple([1] * n.rank)
            vals[nid] = TensorRelation.from_dense(feeds[nid], parts)
        elif n.kind == "einsum":
            d = plan[nid]
            ins = []
            for ls, a in zip(n.spec.in_labels, n.inputs):
                want = label_parts(d, ls)
                rel = vals[a]
                if rel.parts != want:
                    rel = rel.repartition(want)
                    stats["repartitions"] += 1
                ins.append(rel)
            out, s = execute_einsum_tra(n.spec, d, *ins)
            stats["kernel_calls"] += s["kernel_calls"]
            vals[nid] = out
        elif n.kind == "map":
            from repro_torch.core import opdef as _opdef

            src = vals[n.inputs[0]]
            fn = _opdef.MAP_FNS[n.op]
            dense = np.asarray(fn(src.to_dense(), **n.params))
            vals[nid] = TensorRelation.from_dense(dense, src.parts)
        else:  # opaque — dense reference
            from repro_torch.core import opdef as _opdef

            fn = _opdef.OPAQUE_FNS[n.op]
            dense = np.asarray(fn(*[vals[a].to_dense() for a in n.inputs],
                                  **n.call_params))
            d = plan.get(nid)
            parts = label_parts(d, n.labels) if d else tuple([1] * len(dense.shape))
            vals[nid] = TensorRelation.from_dense(dense, parts)
    return vals, stats
